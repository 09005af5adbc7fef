"""Data of a configuration, made on the device from the seed.

``chunks(cfg, seed, device)`` yields the (row, column) pairs that the
harness hands to the port and that the reference reads, as int64 tensors
on ``device``, one block of slices at a time and in ascending slice
order.  The same seed on the same device gives the same pairs, so the
reference makes them again rather than keeping a copy.  Plain torch:
this module imports nothing of the program.

Kinds of data (``cfg["data"]["kind"]``):

- ``stars``: user ``u`` stars ``n_u`` repositories, the ``n_u`` the
  quantiles of a log-uniform law over [min, max] dealt in a seeded order
  (so every seed makes as many stars); each star's repository rank is Zipf(s) over the
  columns (the continuous inverse of its CDF), and ranks map to columns
  through a seeded bijection.  A user may star a repository twice: the
  bitmap keeps one bit.
"""

from __future__ import annotations

import math

import torch

SLICE_BITS = 20
SLICE_WIDTH = 1 << SLICE_BITS
_MIX = 0x9E3779B97F4A7C15 - (1 << 64)  # the golden ratio's odd constant, as int64


def torch_seed(seed: int, salt: int) -> int:
    """A ``torch.Generator`` seed for one use of a run's ``--seed``."""
    return (int(seed) * 1_000_003 + salt) % (1 << 63)


def generator(device, seed: int, salt: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, salt))
    return g


def _round(x: torch.Tensor, key: torch.Tensor, bits: int) -> torch.Tensor:
    """A Feistel round function: ``bits`` pseudo-random bits of (x, key)."""
    h = (x + key) * _MIX
    h = h ^ (h >> 29)
    h = h * _MIX
    return (h >> 31) & ((1 << bits) - 1)


def feistel(x: torch.Tensor, keys: torch.Tensor, half: int) -> torch.Tensor:
    """A bijection of ``[0, 2**(2*half))``: four Feistel rounds keyed by
    ``keys[..., r]`` (broadcast against ``x``)."""
    mask = (1 << half) - 1
    left, right = x >> half, x & mask
    for r in range(keys.shape[-1]):
        left, right = right, left ^ _round(right, keys[..., r], half)
    return (left << half) | right


def _cycle_walk(x: torch.Tensor, keys: torch.Tensor, half: int, n: int) -> torch.Tensor:
    """A bijection of ``[0, n)``: the Feistel bijection of the enclosing
    power of four, applied again to any value that lands at ``n`` or
    past it until it lands inside."""
    y = feistel(x, keys, half)
    for _ in range(256):
        out = y >= n
        if not bool(out.any()):
            return y
        y = torch.where(out, feistel(y, keys, half), y)
    raise RuntimeError("cycle walk did not settle")


def star_pairs(cfg, seed, device):
    """Every (user, repository) star, sorted by repository."""
    n_slices, n_users = int(cfg["slices"]), int(cfg["rows"])
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
    cols = _cycle_walk(rank, keys, half, n_cols)
    order = torch.argsort(cols, stable=True)
    return users[order], cols[order]


def _star_chunks(cfg, seed, device, block):
    users, cols = star_pairs(cfg, seed, device)
    n_slices = int(cfg["slices"])
    slices = cols >> SLICE_BITS
    edges = torch.searchsorted(
        slices, torch.arange(0, n_slices + block, block, device=device, dtype=torch.int64)
    ).tolist()
    for a, b in zip(edges, edges[1:]):
        if b > a:
            yield users[a:b], cols[a:b]


KINDS = {"stars": _star_chunks}


def chunks(cfg: dict, seed: int, device, block: int = 16):
    """(rows, cols) int64 tensors on ``device``, ``block`` slices at a time."""
    kind = cfg["data"]["kind"]
    if kind not in KINDS:
        raise ValueError(f"unknown data kind {kind!r}")
    return KINDS[kind](cfg, seed, device, int(block))
