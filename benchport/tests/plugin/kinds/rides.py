"""The ``rides`` kind: every column is a ride, and each frame's rows
partition the rides: ride ``c`` is in exactly one row of every frame,
drawn from that frame's ``weights`` (``cfg["data"]["weights"][frame]``).
Rides fill each slice from its first column, ``rides_per_slice`` of
them.  Each slice's draws come from a generator of its own, so the
pairs do not depend on the block size."""

from __future__ import annotations

import torch

from benchport import schema
from benchport.datagen import SLICE_BITS, generator


def chunks(cfg, seed, device, block):
    n_slices, per = int(cfg["slices"]), int(cfg["data"]["rides_per_slice"])
    frames = schema.frames(cfg)
    cum = {}
    for f in frames:
        w = torch.tensor(cfg["data"]["weights"][f["name"]], dtype=torch.float64, device=device)
        if len(w) != f["rows"]:
            raise ValueError(f"{f['name']}: {len(w)} weights for {f['rows']} rows")
        cum[f["name"]] = (torch.cumsum(w, 0) / w.sum())[:-1]
    for s0 in range(0, n_slices, block):
        slices = range(s0, min(n_slices, s0 + block))
        cols = torch.cat([(s << SLICE_BITS) + torch.arange(per, device=device, dtype=torch.int64)
                          for s in slices])
        for k, f in enumerate(frames):
            u = torch.cat([torch.rand(per, generator=generator(device, seed, 1000 * (k + 1) + s),
                                      device=device, dtype=torch.float64) for s in slices])
            yield f["name"], torch.searchsorted(cum[f["name"]], u), cols
