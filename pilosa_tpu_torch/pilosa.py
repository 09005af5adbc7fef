"""Package-level errors, constants, and name validation.

Reference analog: pilosa.go (sentinel errors pilosa.go:25-49, name/label
validation regexes pilosa.go:52-55 and 111-124).
"""

from __future__ import annotations

import re

# Slice width: number of columns per slice. Reference: fragment.go:47
# (SliceWidth = 1048576 = 2^20). Everything hangs off this constant.
SLICE_WIDTH = 1 << 20


class PilosaError(Exception):
    """Base class for all framework errors."""


class ErrIndexExists(PilosaError):
    pass


class ErrIndexNotFound(PilosaError):
    pass


class ErrFrameExists(PilosaError):
    pass


class ErrFrameNotFound(PilosaError):
    pass


class ErrFrameInverseDisabled(PilosaError):
    pass


class ErrFragmentNotFound(PilosaError):
    pass


class ErrFragmentLocked(PilosaError):
    """Another process holds the fragment's exclusive file lock
    (fragment.go:179-234 flock analog)."""


class ErrFragmentClosed(PilosaError):
    """Read/write against a closed fragment — close() swaps in an empty
    bitmap to release the mmap, so without this guard a late reader
    would silently see no data instead of an error."""


class ErrQueryRequired(PilosaError):
    pass


class ErrInvalidView(PilosaError):
    pass


class ErrName(PilosaError):
    pass


class ErrLabel(PilosaError):
    pass


class ErrHostRequired(PilosaError):
    pass


class ErrFrameRequired(PilosaError):
    pass


class ErrColumnRowLabelEqual(PilosaError):
    pass


class ErrInvalidCacheType(PilosaError):
    pass


class ErrInvalidTimeQuantum(PilosaError):
    pass


class ErrTooManyWrites(PilosaError):
    pass


# Reference: pilosa.go:52-55 — names are lowercase alphanumeric with
# dash/underscore, a leading letter, at most 65 chars total.
_NAME_RE = re.compile(r"[a-z][a-z0-9_-]{0,64}")
_LABEL_RE = re.compile(r"[A-Za-z][A-Za-z0-9_-]{0,64}")


def validate_name(name: str) -> None:
    if not isinstance(name, str) or _NAME_RE.fullmatch(name) is None:
        raise ErrName(f"invalid index or frame name: {name!r}")


def validate_label(label: str) -> None:
    if not isinstance(label, str) or _LABEL_RE.fullmatch(label) is None:
        raise ErrLabel(f"invalid row or column label: {label!r}")


# ---------------------------------------------------------------------------
# Shared batch-chunk sizing for the multi-view OR gather (fused Range).
# One source of truth for the evaluators that materialize the gather (the
# numpy engine and the device engines' plain paths): a materialized [S, chunk, V, W] gather must
# stay under budget bytes.  Hosts chunk small (L3-cache friendly); device
# engines afford a larger HBM transient.
# ---------------------------------------------------------------------------

OR_MULTI_BUDGET_HOST = 32 << 20
OR_MULTI_BUDGET_DEVICE = 256 << 20


def or_multi_chunk_size(n_slices: int, n_views: int, n_words: int, budget: int) -> int:
    """Largest batch chunk whose gathered block fits ``budget`` bytes."""
    return max(1, budget // max(1, n_slices * n_views * n_words * 4))
