"""pilosa_tpu_torch — the bitmap index on PyTorch and CUDA (NVIDIA Hopper).

A port of ``pilosa_tpu`` with the same module names and layout, so each
module's counterpart is easy to find.  Host-side code (roaring storage,
fragments, the data model, PQL, the executor's strategy ladder, the row
pool, the HTTP server and CLI — ``python -m pilosa_tpu_torch.cli server``)
is carried over unchanged; the device layer is new:

- ``ops/bitwise.py`` — plain PyTorch versions of the fused counts, the
  exact all-pairs Gram, and the numpy host helpers;
- ``ops/kernels.py`` + ``csrc/*.cu`` — hand-written CUDA kernels for
  ``sm_90a`` (built with nvcc at first use, bound with ctypes);
- ``ops/dispatch.py`` — a CUDA tensor goes to its kernel, a CPU tensor
  to the plain version;
- ``engine.py`` — ``TorchEngine(device)``, the executor's engine.

Entry points run on the card: ``Executor(holder)`` resolves its engine to
``TorchEngine("cuda")`` and raises when CUDA is absent.  Tests ask for
the CPU explicitly (``TorchEngine("cpu")`` or ``engine="numpy"``).
"""

__version__ = "0.1.0"

from pilosa_tpu_torch.pilosa import (  # noqa: F401
    PilosaError,
    ErrIndexExists,
    ErrIndexNotFound,
    ErrFrameExists,
    ErrFrameNotFound,
    ErrFragmentNotFound,
    ErrQueryRequired,
    validate_name,
    validate_label,
)

# Lazy top-level API (PEP 562): `pilosa_tpu_torch.Holder` etc. without
# paying the torch import at package-import time.
_LAZY = {
    "Holder": ("pilosa_tpu_torch.core.holder", "Holder"),
    "Index": ("pilosa_tpu_torch.core.index", "Index"),
    "Frame": ("pilosa_tpu_torch.core.frame", "Frame"),
    "FrameOptions": ("pilosa_tpu_torch.core.frame", "FrameOptions"),
    "IndexOptions": ("pilosa_tpu_torch.core.index", "IndexOptions"),
    "Executor": ("pilosa_tpu_torch.executor", "Executor"),
    "TorchEngine": ("pilosa_tpu_torch.engine", "TorchEngine"),
}


__all__ = [
    "PilosaError", "ErrIndexExists", "ErrIndexNotFound", "ErrFrameExists",
    "ErrFrameNotFound", "ErrFragmentNotFound", "ErrQueryRequired",
    "validate_name", "validate_label", *sorted(_LAZY),
]


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    obj = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = obj  # cache: later accesses are plain dict hits
    return obj


def __dir__():
    return sorted(set(list(globals()) + list(_LAZY)))
