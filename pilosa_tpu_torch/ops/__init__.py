"""Device layer: dense packed-bitmap counts on PyTorch tensors.

- `bitwise` — plain PyTorch versions of every fused count (the CPU path
  and the reference each kernel is held against), the exact all-pairs
  Gram, and the numpy host helpers (packing, masks, ground truths).
- `kernels` — the hand-written CUDA kernels (``csrc/*.cu``, ``sm_90a``):
  build, ctypes binding, launch counters, and the wrappers.
- `dispatch` — picks the kernel for a CUDA tensor and the plain version
  for a CPU tensor.

Words are stored as ``int32``, a bit-exact view of the reference's
``uint32`` words: torch on the CPU has no ``>>`` or ``~`` for ``uint32``.
"""
