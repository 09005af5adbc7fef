"""The benchmark of pilosa_tpu_torch: one command runs one cell once.

``python benchport/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` loads a deployment's data into the port's ``Server`` in
this process, warms it, drives it from client processes for the window,
checks the window's answers against a plain reference and prints one
JSON line.  Cells, configurations, traffic mixes, data kinds, query
shapes and metrics are data: ``BENCHMARK.json`` names them, and the
harness finds each by name under ``configs/``, ``traffic/``, ``kinds/``,
``shapes/`` and ``metrics/``.

Adding a configuration takes new files only:

- ``configs/<name>.json``: ``index``, ``slices``, ``data.kind`` and
  either one frame (``frame``, ``row_label``, ``rows``) or ``frames``,
  a list of ``{"name", "row_label", "rows"}``; the harness creates every
  frame.
- ``kinds/<kind>.py`` (a kind of data no file has yet):
  ``chunks(cfg, seed, device, block)`` yields ``(frame, rows, cols)``
  int64 tensors on ``device``, made from the seed, by ascending blocks
  of ``block`` slices; each chunk lies in one block, and every frame's
  chunks of a block come before the next block.  The harness loads each
  into its frame; the reference remakes them block by block.
- ``traffic/<mix>.json``: the mix's parameters and ``"shape"`` (default
  ``"nary"``, ``traffic_gen.Traffic``).  ``shapes/<shape>.py``: a class
  ``Traffic(mix, cfg, seed)`` with ``traffic_gen.Shape``'s interface:
  ``request(stream, client, i)`` a list of ``calls`` call trees
  (``schema``: ``Count`` over ``Union`` / ``Intersect`` / ``Difference``
  / ``Xor`` nodes, leaves ``("Bitmap", frame, row)``), ``cover()``
  requests that name every row of every frame, ``body(request)`` its
  PQL.  Answers are lists of counts; the reference counts any such tree.
- ``metrics/<metric>.py``: ``read(ctx)``, a number or None.

Nothing here imports ``jax`` or the JAX package.  The generators, kinds,
shapes, the reference and the arithmetic import nothing of
``pilosa_tpu_torch`` either; ``harness.py`` alone drives the port.
"""
