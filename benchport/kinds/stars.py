"""The ``stars`` kind: one frame, user ``u`` stars ``n_u`` repositories.

The ``n_u`` are the quantiles of a log-uniform law over [``stars_min``,
``stars_max``] dealt in a seeded order (so every seed makes as many
stars); each star's repository rank is Zipf(``repo_zipf``) over the
columns (the continuous inverse of its CDF), and ranks map to columns
through a seeded bijection.  A user may star a repository twice: the
bitmap keeps one bit.
"""

from __future__ import annotations

import math

import torch

from benchport import schema
from benchport.datagen import SLICE_BITS, SLICE_WIDTH, cycle_walk, generator


def star_pairs(cfg, seed, device):
    """Every (user, repository) star, sorted by repository."""
    n_slices, n_users = int(cfg["slices"]), schema.frames(cfg)[0]["rows"]
    d = cfg["data"]
    n_cols = n_slices * SLICE_WIDTH
    g = generator(device, seed, 2)
    lo, hi = math.log(float(d["stars_min"])), math.log(float(d["stars_max"]) + 1.0)
    # The same star counts for every seed (the law's quantiles), dealt
    # to the users in a seeded order: the seed changes who, not how much.
    u = (torch.randperm(n_users, generator=g, device=device).to(torch.float64) + 0.5) / n_users
    n_stars = torch.exp(lo + u * (hi - lo)).floor().to(torch.int64)
    users = torch.arange(n_users, device=device, dtype=torch.int64).repeat_interleave(n_stars)
    # Zipf(s) ranks in [1, n_cols] by the inverse of the continuous CDF
    # (s = 1: the log of the rank is uniform; otherwise a power law).
    s = float(d["repo_zipf"])
    v = torch.rand(users.shape[0], generator=g, device=device, dtype=torch.float64)
    if abs(s - 1.0) < 1e-12:
        rank = torch.exp(v * math.log(n_cols))
    else:
        a = 1.0 - s
        rank = (1.0 + v * (n_cols ** a - 1.0)) ** (1.0 / a)
    rank = rank.floor().to(torch.int64).clamp_(1, n_cols) - 1
    half = (max(1, (n_cols - 1).bit_length()) + 1) // 2
    keys = torch.randint(0, 1 << 62, (4,), generator=g, device=device, dtype=torch.int64)
    cols = cycle_walk(rank, keys, half, n_cols)
    order = torch.argsort(cols, stable=True)
    return users[order], cols[order]


def chunks(cfg, seed, device, block):
    """The stars in blocks of ``block`` slices, in the frame."""
    frame = schema.frames(cfg)[0]["name"]
    users, cols = star_pairs(cfg, seed, device)
    n_slices = int(cfg["slices"])
    slices = cols >> SLICE_BITS
    edges = torch.searchsorted(
        slices, torch.arange(0, n_slices + block, block, device=device, dtype=torch.int64)
    ).tolist()
    for a, b in zip(edges, edges[1:]):
        if b > a:
            yield frame, users[a:b], cols[a:b]
