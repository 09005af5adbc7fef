"""The one traffic generator: requests of batched N-ary Counts.

A traffic mix (``traffic/<name>.json``) gives the parameters; a
configuration (``configs/<name>.json``) gives the index, frame, row label
and row count.  Every request is made from ``(seed, client, stream, i)``
alone, so the client that sends request ``i`` and the harness that
checks it make the same request without passing it around.  Numpy only:
client processes import this and nothing heavier.

Parameters of a mix:

- ``calls_per_request``: Counts in one POST;
- ``ops``: {"Union" | "Intersect" | "Difference": weight};
- ``operands``: for each op, {"min": k0, "max": k1}: K uniform in
  [k0, k1], distinct rows;
- ``row_skew``: Zipf exponent over the configuration's rows, whose ranks
  are a seeded permutation of the row ids (0 = uniform).
"""

from __future__ import annotations

import numpy as np

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


class Traffic:
    """A mix over one configuration.  ``request(stream, client, i)``
    returns ``(ops, rows)``: each call's op name and its operand rows."""

    def __init__(self, mix: dict, cfg: dict, seed: int):
        self.mix = mix
        self.cfg = cfg
        self.seed = int(seed)
        self.n_rows = int(cfg["rows"])
        self.calls = int(mix["calls_per_request"])
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

    def request(self, stream: str, client: int, i: int) -> tuple[list[str], list[list[int]]]:
        rng = rng_for(self.seed, STREAMS[stream], client, i)
        n = self.calls
        ops = rng.choice(len(self.op_names), size=n, p=self.op_p)
        ks = self.k_lo[ops] + np.floor(
            rng.random(n) * (self.k_hi[ops] - self.k_lo[ops] + 1)).astype(np.int64)
        # Weighted draws without replacement: the K largest of
        # log p + Gumbel noise (successive sampling by weight).
        keys = self.log_p[None, :] + rng.gumbel(size=(n, self.n_rows))
        order = np.argsort(-keys, axis=1)[:, : self.k_max]
        rows = [self.rank_row[order[c, : ks[c]]].tolist() for c in range(n)]
        return [self.op_names[o] for o in ops], rows

    def cover(self) -> list[tuple[list[str], list[list[int]]]]:
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
            if not out or len(out[-1][0]) >= self.calls or rows_in + len(part) > COVER_ROWS:
                out.append(([], []))
                rows_in = 0
            out[-1][0].append(op)
            out[-1][1].append(part)
            rows_in += len(part)
        return out

    def body(self, ops: list[str], rows: list[list[int]]) -> bytes:
        frame = self.cfg["frame"]
        label = self.cfg.get("row_label", "rowID")
        return "".join(
            f"Count({op}("
            + ", ".join(f"Bitmap({label}={r}, frame={frame})" for r in rs)
            + "))"
            for op, rs in zip(ops, rows)
        ).encode()
