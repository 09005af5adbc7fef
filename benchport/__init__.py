"""The benchmark of pilosa_tpu_torch: one command runs one cell once.

``python benchport/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` loads a deployment's data into the port's ``Server`` in
this process, warms it, drives it from client processes for the window,
checks the window's answers against a plain reference and prints one
JSON line.  Cells, configurations, traffic mixes and metrics are data:
``BENCHMARK.json`` names them, and the harness finds each by name under
``configs/``, ``traffic/`` and ``metrics/``.

Nothing here imports ``jax`` or the JAX package.  The generators, the
reference and the arithmetic import nothing of ``pilosa_tpu_torch``
either; ``harness.py`` alone drives the port.
"""
