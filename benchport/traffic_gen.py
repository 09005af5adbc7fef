"""Traffic: requests of Count calls, made from the seed.

A traffic mix (``traffic/<name>.json``) gives the parameters and names
its query shape (``"shape"``, default ``"nary"``); a configuration
(``configs/<name>.json``) gives the index and its frames.  Every request
is made from ``(seed, client, stream, i)`` alone, so the client that
sends request ``i`` and the harness that checks it make the same request
without passing it around.  Numpy only: client processes import this
and nothing heavier.

A shape is a class ``Traffic(mix, cfg, seed)`` with ``Shape``'s
interface: ``request(stream, client, i)``, a list of ``calls`` call
trees (``schema``); ``cover()``, requests that name every row of every
frame; ``body(request)``, the POST's PQL.  ``nary`` is the class below;
any other shape is ``<root>/benchport/shapes/<shape>.py``'s ``Traffic``.

Parameters of the ``nary`` mix (flat folds of one frame's rows: the
configuration's first):

- ``calls_per_request``: Counts in one POST;
- ``ops``: {"Union" | "Intersect" | "Difference": weight};
- ``operands``: for each op, {"min": k0, "max": k1}: K uniform in
  [k0, k1], distinct rows;
- ``row_skew``: Zipf exponent over the frame's rows, whose ranks are a
  seeded permutation of the row ids (0 = uniform).
"""

from __future__ import annotations

import numpy as np

from benchport import schema

OPS = ("Union", "Intersect", "Difference")

# Stream ids: requests sent in the window, warm-up requests, the
# requests that fill the pool in set-up, and the check's sample.
STREAMS = {"window": 0, "warm": 1, "cover": 2, "sample": 3}

# Set-up's pool fill names at most this many rows a request, so the pool
# fills in steps and its transient copy stays small.
COVER_ROWS = 64


def seed_words(seed: int) -> list[int]:
    """A run's ``--seed`` (any whole number, negative too) as entropy
    words for ``np.random.SeedSequence``."""
    s = int(seed)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, 1 if s < 0 else 0]


def rng_for(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed_words(seed) + [int(k) for k in key]))


def shape(mix: dict, cfg: dict, seed: int, root: str) -> "Shape":
    """The mix's shape over ``cfg``, found by name under ``root``."""
    name = mix.get("shape", "nary")
    if name == "nary":
        return Traffic(mix, cfg, seed)
    return schema.plugin(root, "shapes", name).Traffic(mix, cfg, seed)


class Shape:
    """What every shape shares: the mix, the configuration, the seed, the
    frames' row labels, ``calls`` a request and the PQL of a request."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix = mix
        self.cfg = cfg
        self.seed = int(seed)
        self.frames = schema.frames(cfg)
        self.labels = {f["name"]: f["row_label"] or schema.DEFAULT_ROW_LABEL for f in self.frames}
        self.calls = int(mix["calls_per_request"])

    def request(self, stream: str, client: int, i: int) -> list:
        raise NotImplementedError

    def cover(self) -> list[list]:
        raise NotImplementedError

    def body(self, request: list) -> bytes:
        return "".join(f"Count({schema.pql(c, self.labels)})" for c in request).encode()


class Traffic(Shape):
    """The ``nary`` shape: each call one op over distinct rows of the
    configuration's first frame."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        super().__init__(mix, cfg, seed)
        self.frame = self.frames[0]["name"]
        self.n_rows = self.frames[0]["rows"]
        names = list(mix["ops"])
        unknown = set(names) - set(OPS)
        if unknown:
            raise ValueError(f"unknown ops {sorted(unknown)}")
        w = np.array([float(mix["ops"][n]) for n in names])
        self.op_names = names
        self.op_p = w / w.sum()
        ranges = mix["operands"]
        self.k_lo = np.array([int(ranges[n]["min"]) for n in names])
        self.k_hi = np.array([int(ranges[n]["max"]) for n in names])
        if not (2 <= self.k_lo).all() or not (self.k_lo <= self.k_hi).all() \
                or int(self.k_hi.max()) > self.n_rows:
            raise ValueError(f"operands {ranges} outside 2-{self.n_rows}")
        self.k_max = int(self.k_hi.max())
        # Zipf over ranks, ranks a seeded permutation of the row ids:
        # which rows are hot changes with the seed, the work does not.
        s = float(mix["row_skew"])
        ranks = np.arange(1, self.n_rows + 1, dtype=np.float64)
        self.log_p = -s * np.log(ranks)
        self.rank_row = rng_for(self.seed, 7).permutation(self.n_rows)

    def request(self, stream: str, client: int, i: int) -> list:
        rng = rng_for(self.seed, STREAMS[stream], client, i)
        n = self.calls
        ops = rng.choice(len(self.op_names), size=n, p=self.op_p)
        ks = self.k_lo[ops] + np.floor(
            rng.random(n) * (self.k_hi[ops] - self.k_lo[ops] + 1)).astype(np.int64)
        # Weighted draws without replacement: the K largest of
        # log p + Gumbel noise (successive sampling by weight).
        keys = self.log_p[None, :] + rng.gumbel(size=(n, self.n_rows))
        order = np.argsort(-keys, axis=1)[:, : self.k_max]
        return [self._call(self.op_names[ops[c]], self.rank_row[order[c, : ks[c]]].tolist())
                for c in range(n)]

    def _call(self, op: str, rows: list[int]) -> tuple:
        return (op,) + tuple(("Bitmap", self.frame, r) for r in rows)

    def cover(self) -> list[list]:
        """Requests of this mix's shape that name every row: set-up sends
        them so that the whole working set is resident before the window.
        The calls cycle through the mix's ops, each with as many operands
        as its op's range allows at most; a request names at most
        ``COVER_ROWS`` rows."""
        perm = rng_for(self.seed, STREAMS["cover"]).permutation(self.n_rows).tolist()
        calls = []
        j = 0
        while j < len(perm):
            o = len(calls) % len(self.op_names)
            part = perm[j: j + int(self.k_hi[o])]
            j += len(part)
            if len(part) < self.k_lo[o]:  # top up from the front: distinct rows
                part += [r for r in perm if r not in part][: int(self.k_lo[o]) - len(part)]
            calls.append((self.op_names[o], part))
        out, rows_in = [], 0
        for op, part in calls:
            if not out or len(out[-1]) >= self.calls or rows_in + len(part) > COVER_ROWS:
                out.append([])
                rows_in = 0
            out[-1].append(self._call(op, part))
            rows_in += len(part)
        return out
