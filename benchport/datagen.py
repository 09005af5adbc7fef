"""Data of a configuration, made on the device from the seed.

``chunks(cfg, seed, device, block)`` yields the ``(frame, rows, cols)``
pairs that the harness hands to the port and that the reference reads,
as int64 tensors on ``device``.  A data kind is a file,
``kinds/<kind>.py``, whose ``chunks(cfg, seed, device, block)`` yields
them by blocks of ``block`` slices, ``[b * block, (b + 1) * block)``, in
ascending order: every chunk lies in one block, and every frame's chunks
of a block come before the next block's.  The same seed on the same
device gives the same pairs, so the reference makes them again rather
than keeping a copy.  Plain torch: this module and the kinds import
nothing of the program.  The helpers here are for the kinds.
"""

from __future__ import annotations

import os

import torch

from benchport import schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def cycle_walk(x: torch.Tensor, keys: torch.Tensor, half: int, n: int) -> torch.Tensor:
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


def chunks(cfg: dict, seed: int, device, block: int = 16, root: str | None = None):
    """(frame, rows, cols): int64 tensors on ``device``, from the kind
    ``cfg["data"]["kind"]`` (``<root>/benchport/kinds/<kind>.py``'s
    ``chunks(cfg, seed, device, block)``), ``block`` slices at a time."""
    kind = schema.plugin(root or ROOT, "kinds", cfg["data"]["kind"])
    return kind.chunks(cfg, seed, device, int(block))
