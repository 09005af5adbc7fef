"""The ``groupby`` shape over the first two frames (A, B): each call is
either a cell of the group-by, ``Intersect(Bitmap(A, a), Bitmap(B, b))``,
or, with probability ``nested``, a tree three ops deep:
``Difference(Union(Intersect(A a1, B b1), Intersect(A a2, B b2)),
Xor(A a3, B b3))``.  ``cover()`` names every row of every frame, one
``Union`` a frame."""

from __future__ import annotations

from benchport.traffic_gen import STREAMS, Shape, rng_for


class Traffic(Shape):
    def __init__(self, mix, cfg, seed):
        super().__init__(mix, cfg, seed)
        (self.a, self.na), (self.b, self.nb) = [(f["name"], f["rows"]) for f in self.frames[:2]]
        self.nested = float(self.mix["nested"])

    def _pair(self, rng) -> tuple:
        return ("Intersect", ("Bitmap", self.a, int(rng.integers(self.na))),
                ("Bitmap", self.b, int(rng.integers(self.nb))))

    def request(self, stream, client, i):
        rng = rng_for(self.seed, STREAMS[stream], client, i)
        out = []
        for _ in range(self.calls):
            if rng.random() < self.nested:
                xor = ("Xor", ("Bitmap", self.a, int(rng.integers(self.na))),
                       ("Bitmap", self.b, int(rng.integers(self.nb))))
                out.append(("Difference", ("Union", self._pair(rng), self._pair(rng)), xor))
            else:
                out.append(self._pair(rng))
        return out

    def cover(self):
        calls = [("Union",) + tuple(("Bitmap", f["name"], r) for r in range(f["rows"]))
                 for f in self.frames]
        return [calls[j:j + self.calls] for j in range(0, len(calls), self.calls)]
