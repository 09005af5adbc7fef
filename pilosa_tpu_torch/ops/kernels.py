"""Hand-written CUDA kernels for the fused popcount counts (Hopper, sm_90a).

Each kernel's source is ``pilosa_tpu_torch/csrc/<name>.cu`` with a plain C
entry point.  At first use every source is compiled by its own ``nvcc``
(all started together) into a shared library under ``build/kernels/`` at
the repository root, named by the hash of the sources and flags, and
loaded with ctypes.  Pointers and the stream cross as ``c_void_p``; each
entry point returns ``cudaGetLastError()`` and the wrapper raises if it is
not 0.

Every wrapper:

- takes the plain PyTorch version (``*_plain`` below) for a tensor that
  lies on the CPU, and launches its kernel (or raises) for a CUDA tensor;
- checks device, dtype, contiguity, alignment and shape, and allocates
  its output with ``torch.empty``/``torch.zeros`` on the current stream;
- adds one to ``LAUNCHES[name]`` where it launches its kernel, and
  nowhere else.

Eleven kernels replace every Pallas kernel of
pilosa_tpu/ops/pallas_kernels.py: fused_count1 and fused_count2
(``count_rows``), fused_resident_count2 (``resident_count2``),
fused_gather_count2 (``gather_count2``), fused_gather_src_counts
(``gather_src_counts``), fused_gather_count_multi with
fused_gather_count_or (``gather_count_multi``), fused_gather_count_tree
(``gather_count_tree``, and its staged variant ``resident_count_tree`` for
batches that name the same rows many times), the row-major pair and fold
counts fused_gather_count2_rowmajor (``gather_count2_rowmajor``) and
fused_gather_count_multi_rowmajor (``gather_count_multi_rowmajor``),
fused_topn_counts (``topn_counts``), and the staged variant of both
multi folds, either layout, ``resident_count_multi``.  All eleven are
bound by device-memory bytes on this card; each source says what its
design does about that.  The three resident kernels stage the batch's
distinct rows through shared-memory tiles copied by cp.async
(``csrc/stage.cuh``); their wrappers compact the ids on the host first
(``compact_rows``).  The twelfth, ``pair_gram``, replaces the
reference's all-pairs Gram (pilosa_tpu/ops/bitwise.py pair_gram, an MXU
product rather than Pallas): it runs on the tensor cores (wgmma, 1-bit
AND-popc, both operands from shared memory).  The thirteenth,
``build_planes``, replaces the device half of the reference's bulk build
lane (pilosa_tpu/bulk/build.py build_planes_jax, a jitted sort, dedup and
scatter-add rather than Pallas): from keys in ascending order it writes
each word of the arena once, bound by the bytes of the arena and the
pairs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from pilosa_tpu_torch.analysis import lockcheck
from pilosa_tpu_torch.ops import bitwise
from pilosa_tpu_torch.pilosa import SLICE_WIDTH

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

KERNELS = (
    "count_rows", "resident_count2", "gather_count2", "gather_src_counts",
    "gather_count_multi", "gather_count_tree", "resident_count_tree",
    "gather_count2_rowmajor", "gather_count_multi_rowmajor", "topn_counts",
    "resident_count_multi", "pair_gram", "build_planes",
)

# Launch counters: one per kernel, bumped only where the kernel launches.
LAUNCHES = dict.fromkeys(KERNELS, 0)

OPS = {"none": 0, "and": 1, "or": 2, "xor": 3, "andnot": 4}

# Per-block shared memory on sm_90 (227 KB of the SM's 256 KB, dynamic
# allocation only above 48 KB).
SMEM_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    "count_rows": ("pk_count_rows", [_P, _P, _L, _P, _I, _I, _I, _I, _I, _P]),
    "resident_count2": ("pk_resident_count2", [_P, _P, _P, _P] + [_I] * 8 + [_P]),
    "gather_count2": ("pk_gather_count2", [_P, _P, _P] + [_I] * 7 + [_P]),
    "gather_src_counts": ("pk_gather_src_counts", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "gather_count_multi": ("pk_gather_count_multi", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "gather_count_tree": ("pk_gather_count_tree", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "resident_count_tree": ("pk_resident_count_tree", [_P] * 5 + [_I] * 8 + [_P]),
    "gather_count2_rowmajor": ("pk_gather_count2_rowmajor", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "gather_count_multi_rowmajor": (
        "pk_gather_count_multi_rowmajor", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "topn_counts": ("pk_topn_counts", [_P, _P, _P, _I, _I, _I, _P]),
    "resident_count_multi": ("pk_resident_count_multi", [_P] * 6 + [_I] * 10 + [_P]),
    "pair_gram": ("pk_pair_gram", [_P, _P, _I, _I, _I, _L, _L, _I, _P]),
    "build_planes": ("pk_build_planes", [_P, _L, _P, _L, _P, _I, _P]),
}

# One build at a time: the first launches of several threads wait for the
# one compile and load.  The loaded entry points live in a registered
# global, filled under the build lock and read by every launch.
_build_mu = lockcheck.named_lock("ops.kernels._build_mu")
_fns = lockcheck.named_global("ops.kernels.fns", max_entries=len(KERNELS))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        # analysis-ok: lockstep-determinism: locates the compiler only; a library is named by the hash of its sources and flags, so every rank binds the same kernels
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(_CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(_CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every kernel source that has no current library (one nvcc
    per source, all started together) and bind the entry points.
    Returns {name: seconds} for the sources compiled by this call."""
    import time

    with _build_mu:
        if len(_fns) == len(KERNELS):
            return {}
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in KERNELS:
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
            # The build lock exists to hold other threads across the compile.
            with lockcheck.allowed("subprocess"):
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
                ), tmp, path)
        took = {}
        for name, (p, tmp, path) in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{out.decode(errors='replace')}")
            os.replace(tmp, path)
            took[name] = time.perf_counter() - t0
        for name in KERNELS:
            sym, argtypes = _ARGTYPES[name]
            fn = getattr(ctypes.CDLL(_lib_path(name)), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns.put(name, fn)
        return took


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        build()
        fn = _fns.get(name)
    return fn


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_sms = lockcheck.named_global("ops.kernels.sms", max_entries=64)


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (read once a device): the launches
    size their waves and persistent grids by it."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    n = _sms.get(idx)
    if n is None:
        # Two threads that both miss read the same count: the last put wins.
        n = torch.cuda.get_device_properties(idx).multi_processor_count
        _sms.put(idx, n)
    return n


def _words(t: torch.Tensor, what: str, ndim: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.shape[-1] % 4 or t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned (W % 4 == 0)")


def _ints(a, device) -> torch.Tensor:
    """Host ints (numpy, list or CPU tensor) as a contiguous int32 tensor
    on the card: staged in pinned memory and copied on the current stream
    without waiting for it (no implicit device sync in a wrapper)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return t.pin_memory().to(device, non_blocking=True)


def _host_ids(ids, n_rows: int, what: str) -> np.ndarray:
    """Host row ids as a contiguous int32 array, bounds-checked: a kernel
    would read out of bounds."""
    a = np.ascontiguousarray(ids, dtype=np.int32)
    if a.size and (a.min() < 0 or a.max() >= n_rows):
        raise IndexError(f"{what}: row id out of range [0, {n_rows})")
    return a


def _ids(ids, n_rows: int, device, what: str) -> torch.Tensor:
    """Host row ids as a contiguous int32 tensor on ``device``,
    bounds-checked before upload."""
    return _ints(_host_ids(ids, n_rows, what), device)


# ---------------------------------------------------------------------------
# count_rows (fused_count1 / fused_count2)
# ---------------------------------------------------------------------------

def count_rows_plain(a, b=None, op: str = "none"):
    return bitwise.count_op(op, a, b)


# count_rows.cu's block step (256 threads x 8 16-byte vectors) and the
# waves of one block an SM that a launch's (row, segment) units cover.
COUNT_STEP_VECS = 256 * 8
COUNT_WAVES = 2


def count_rows_segments(m: int, w: int, sms: int) -> tuple[int, int]:
    """(n_seg, seg_vecs) of a count_rows launch on a card of ``sms`` SMs:
    each of the M rows of W words in n_seg segments of seg_vecs 16-byte
    vectors, one block each.  The segments double until the M x n_seg
    blocks cover COUNT_WAVES waves of one block an SM, while a segment
    keeps at least one block step.  Segment g covers vectors [g *
    seg_vecs, min((g + 1) * seg_vecs, W / 4))."""
    wv = w // 4
    n_seg = 1
    while m * n_seg < COUNT_WAVES * sms and -(-wv // (2 * n_seg)) >= COUNT_STEP_VECS:
        n_seg *= 2
    return n_seg, max(1, -(-wv // n_seg))


def count_rows(a: torch.Tensor, b=None, op: str = "none") -> torch.Tensor:
    """out[m] = popcount(op(a[m], b[m] or b)) summed over words -> int32[M].

    a: int32[M, W]; b: None (op "none"), int32[M, W] (per row) or
    int32[W] (one row shared by every a row, read with stride 0).  Each
    row in ``count_rows_segments`` segments."""
    code = OPS.get(op)
    if code is None:
        raise ValueError(f"unknown op {op!r}")
    if (code == 0) != (b is None):
        raise ValueError("op 'none' takes no b; a pair op needs one")
    if _on_cpu(a):
        return count_rows_plain(a, b, op)
    _words(a, "count_rows a", 2)
    m, w = a.shape
    stride = 0
    if b is not None:
        if b.device != a.device:
            raise ValueError("count_rows: a and b on different devices")
        _words(b, "count_rows b", b.dim())
        if b.shape == a.shape:
            stride = w
        elif b.shape != (w,):
            raise ValueError(f"count_rows: b shape {tuple(b.shape)} vs a {tuple(a.shape)}")
    out = a.new_empty(m)
    n_seg, seg_vecs = count_rows_segments(m, w, sm_count(a.device))
    err = _fn("count_rows")(
        a.data_ptr(), None if b is None else b.data_ptr(), stride, out.data_ptr(), m, w, code,
        n_seg, seg_vecs, _stream(a),
    )
    _check(err, "count_rows")
    LAUNCHES["count_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# Staged tiles (csrc/stage.cuh)
# ---------------------------------------------------------------------------

# A tile is one word chunk of the batch's U distinct rows in one slice,
# copied into shared memory by cp.async.  Chunks are powers of two from 64
# words (256 bytes a row: one int2 a lane in a warp step) to 512 (wider
# tiles were no faster on the H100); a launch narrows its chunk until it
# has at least _STAGE_TILES_MIN tiles (about 8 per block on 132 SMs), so
# the persistent blocks stay balanced.
_CHUNK_WORDS_MIN = 64
_CHUNK_WORDS_MAX = 512
_STAGE_TILES_MIN = 1024


def compact_rows(ids, n_rows: int, what: str) -> tuple[np.ndarray, np.ndarray]:
    """The distinct rows ``ids`` names, and ``ids`` remapped into them:
    ``(uniq int32[U], local int32[ids.shape])`` with ``uniq[local] ==
    ids``, so ``rm[:, uniq][:, local]`` is ``rm[:, ids]``.  Bounds-checked
    against ``n_rows`` first: a kernel would read out of bounds."""
    a = np.asarray(ids)
    flat = a.reshape(-1).astype(np.intp)
    if flat.size and (flat.min() < 0 or flat.max() >= n_rows):
        raise IndexError(f"{what}: row id out of range [0, {n_rows})")
    # A mark per matrix row and a running count of the marks: O(B x K + R),
    # a few microseconds at the executor's sizes (a sort costs tens).
    seen = np.zeros(n_rows, dtype=bool)
    seen[flat] = True
    slot = np.cumsum(seen, dtype=np.int32) - 1
    return np.flatnonzero(seen).astype(np.int32), slot[flat].reshape(a.shape)


def staged_smem_bytes(u: int, chunk_words: int, stages: int, own_ints: int) -> int:
    """Shared memory of a staged launch (stage.cuh's layout): the tiles,
    the U row ids and the kernel's own per-query ints."""
    return stages * u * chunk_words * 4 + 4 * u + 4 * own_ints


def staged_tiling(u: int, w: int, own_ints: int, n_slices: int) -> tuple[int, int]:
    """(chunk_words, stages) for U staged rows of W words: two stages of
    the widest chunk that fits one block's shared memory, narrowed while
    the launch has fewer than _STAGE_TILES_MIN (slice, chunk) tiles; one
    stage where two tiles of even the narrowest chunk do not fit; (0, 0)
    where nothing fits."""
    for stages in (2, 1):
        fits = []
        c = _CHUNK_WORDS_MIN
        while c <= min(w, _CHUNK_WORDS_MAX):
            if w % c == 0 and staged_smem_bytes(u, c, stages, own_ints) <= SMEM_BYTES:
                fits.append(c)
            c *= 2
        if fits:
            c = fits[-1]
            while c > fits[0] and n_slices * (w // c) < _STAGE_TILES_MIN:
                c //= 2
            return c, stages
    return 0, 0


# ---------------------------------------------------------------------------
# resident_count2 (fused_resident_count2)
# ---------------------------------------------------------------------------

# Pairs a group holds (8 warps x 32 pairs, partial sums in registers) and
# pairs a block serves (16 groups, each folding every staged tile in
# turn; a larger batch takes further spans): resident_count2.cu's kGroup
# and kSpan.
PAIR_GROUP = 256
PAIR_SPAN = 4096


def pair_span_ints(batch: int) -> int:
    """resident_count2's own shared ints: an offset pair and a sum for
    each pair of one span, rounded up to whole groups."""
    return 2 * -(-min(batch, PAIR_SPAN) // PAIR_GROUP) * PAIR_GROUP


def resident_tiling(u: int, w: int, batch: int, n_slices: int) -> tuple[int, int]:
    """(chunk_words, stages) of a resident_count2 launch over U distinct
    rows named by ``batch`` pairs; chunk_words 0 when nothing fits."""
    return staged_tiling(u, w, pair_span_ints(batch), n_slices)


def resident_count2_plain(op: str, row_matrix, pairs):
    return bitwise.gather_count(op, row_matrix, pairs)


def resident_count2(op: str, row_matrix: torch.Tensor, pairs) -> torch.Tensor:
    """Per-pair ``sum_s popcount(op(rm[s, p0], rm[s, p1]))`` -> int32[B],
    each distinct row the pairs name staged in shared memory once per
    word chunk.  On the CPU: the same remap, then the plain version over
    the compacted rows."""
    if op not in OPS or op == "none":
        raise ValueError(f"unknown pair op {op!r}")
    s, r, w = row_matrix.shape
    if np.ndim(pairs) != 2 or np.shape(pairs)[1] != 2:
        raise ValueError(f"resident_count2: pairs shape {np.shape(pairs)}, want [B, 2]")
    ids, local = compact_rows(pairs, r, "resident_count2 pairs")
    if _on_cpu(row_matrix):
        return resident_count2_plain(op, row_matrix[:, torch.from_numpy(ids).long()], local)
    _words(row_matrix, "resident_count2 matrix", 3)
    b, u = local.shape[0], ids.size
    out = torch.zeros(b, dtype=torch.int32, device=row_matrix.device)
    if b == 0:
        return out
    chunk, stages = resident_tiling(u, w, b, s)
    if chunk == 0:
        raise ValueError(f"resident_count2: {u} rows of {w} words do not fit shared memory")
    dev = _ints(np.concatenate([ids, local.reshape(-1)]), row_matrix.device)
    err = _fn("resident_count2")(
        row_matrix.data_ptr(), dev.data_ptr(), dev.data_ptr() + 4 * u, out.data_ptr(),
        s, r, w, u, b, chunk, stages, OPS[op], _stream(row_matrix),
    )
    _check(err, "resident_count2")
    LAUNCHES["resident_count2"] += 1
    return out


# ---------------------------------------------------------------------------
# gather_count2 (fused_gather_count2)
# ---------------------------------------------------------------------------

# Blocks of 256 threads an SM holds at once (a wave is that many per SM
# of the card), the 16-byte vectors of each row a block reads per step
# (256 threads x 4), and the most pairs a launch carries in its own
# parameters: gather_count2.cu's kThreads, kVecs and kParamPairs.
GATHER2_BLOCKS_PER_SM = 8
GATHER2_STEP_VECS = 256 * 4
GATHER2_PARAM_PAIRS = 500


def gather2_segments(b: int, s: int, w: int, sms: int) -> tuple[int, int]:
    """(n_seg, seg_vecs) of a gather_count2 launch on a card of ``sms``
    SMs: each row of W words in n_seg segments of seg_vecs 16-byte
    vectors, one block each.  The segments double until the B x S x
    n_seg blocks make two waves (GATHER2_BLOCKS_PER_SM an SM), while
    a segment keeps at least one block step (so wide batches keep whole
    rows).  Segment g covers vectors [g * seg_vecs, min((g + 1) *
    seg_vecs, W / 4))."""
    wv = w // 4
    n_seg = 1
    wave = GATHER2_BLOCKS_PER_SM * sms
    while b * s * n_seg < 2 * wave and -(-wv // (2 * n_seg)) >= GATHER2_STEP_VECS:
        n_seg *= 2
    return n_seg, max(1, -(-wv // n_seg))


def gather_count2_plain(op: str, row_matrix, pairs):
    return bitwise.gather_count(op, row_matrix, pairs)


def gather_count2(op: str, row_matrix: torch.Tensor, pairs) -> torch.Tensor:
    """Per-pair ``sum_s popcount(op(rm[s, p0], rm[s, p1]))`` -> int32[B],
    two rows gathered per (pair, slice), each row in
    ``gather2_segments`` segments.  Up to GATHER2_PARAM_PAIRS pairs cross
    in the launch's parameters (no upload); a larger batch is uploaded."""
    if op not in OPS or op == "none":
        raise ValueError(f"unknown pair op {op!r}")
    if _on_cpu(row_matrix):
        return gather_count2_plain(op, row_matrix, pairs)
    _words(row_matrix, "gather_count2 matrix", 3)
    s, r, w = row_matrix.shape
    p = _host_ids(pairs, r, "gather_count2 pairs")
    if p.ndim != 2 or p.shape[1] != 2:
        raise ValueError(f"gather_count2: pairs shape {p.shape}, want [B, 2]")
    b = p.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=row_matrix.device)
    n_seg, seg_vecs = gather2_segments(b, s, w, sm_count(row_matrix.device))
    dev = None if b <= GATHER2_PARAM_PAIRS else _ints(p, row_matrix.device)
    err = _fn("gather_count2")(
        row_matrix.data_ptr(), p.ctypes.data if dev is None else dev.data_ptr(), out.data_ptr(),
        s, r, w, b, OPS[op], n_seg, seg_vecs, _stream(row_matrix),
    )
    _check(err, "gather_count2")
    LAUNCHES["gather_count2"] += 1
    return out


# ---------------------------------------------------------------------------
# gather_src_counts (fused_gather_src_counts)
# ---------------------------------------------------------------------------

def gather_src_counts_plain(row_matrix, pos, src_stack):
    return bitwise.gather_src_counts(row_matrix, pos, src_stack)


def gather_src_counts(row_matrix: torch.Tensor, pos, src_stack: torch.Tensor) -> torch.Tensor:
    """Per-(slice, candidate) ``|rm[s, pos[k]] & src[s]|`` -> int32[S, K]."""
    if _on_cpu(row_matrix):
        return gather_src_counts_plain(row_matrix, pos, src_stack)
    _words(row_matrix, "gather_src_counts matrix", 3)
    _words(src_stack, "gather_src_counts src", 2)
    s, r, w = row_matrix.shape
    if tuple(src_stack.shape) != (s, w) or src_stack.device != row_matrix.device:
        raise ValueError(f"gather_src_counts: src {tuple(src_stack.shape)} vs matrix {(s, r, w)}")
    p = _ids(pos, r, row_matrix.device, "gather_src_counts pos")
    if p.dim() != 1:
        raise ValueError(f"gather_src_counts: pos shape {tuple(p.shape)}, want [K]")
    k = p.shape[0]
    out = torch.empty((s, k), dtype=torch.int32, device=row_matrix.device)
    err = _fn("gather_src_counts")(
        row_matrix.data_ptr(), p.data_ptr(), src_stack.data_ptr(), out.data_ptr(), s, r, w, k,
        _stream(row_matrix),
    )
    _check(err, "gather_src_counts")
    LAUNCHES["gather_src_counts"] += 1
    return out



# ---------------------------------------------------------------------------
# gather_count_multi (fused_gather_count_multi, fused_gather_count_or)
# ---------------------------------------------------------------------------

MULTI_OPS = ("and", "or", "andnot")


def gather_count_multi_plain(op: str, row_matrix, idx):
    return bitwise.gather_count_multi(op, row_matrix, idx)


def gather_count_multi(op: str, row_matrix: torch.Tensor, idx) -> torch.Tensor:
    """Per-query ``sum_s popcount(fold_j rm[s, idx[q, j]])`` -> int32[B]
    for a left fold of K >= 1 gathered rows (and / or / andnot, andnot
    folding ``acc & ~row``); any B and K run in one launch."""
    if op not in MULTI_OPS:
        raise ValueError(f"unsupported multi-op {op!r}")
    if _on_cpu(row_matrix):
        return gather_count_multi_plain(op, row_matrix, idx)
    _words(row_matrix, "gather_count_multi matrix", 3)
    s, r, w = row_matrix.shape
    ix = _ids(idx, r, row_matrix.device, "gather_count_multi idx")
    if ix.dim() != 2 or ix.shape[1] < 1:
        raise ValueError(f"gather_count_multi: idx shape {tuple(ix.shape)}, want [B, K >= 1]")
    b, k = ix.shape
    out = torch.zeros(b, dtype=torch.int32, device=row_matrix.device)
    err = _fn("gather_count_multi")(
        row_matrix.data_ptr(), ix.data_ptr(), out.data_ptr(), s, r, w, b, k, OPS[op],
        _stream(row_matrix),
    )
    _check(err, "gather_count_multi")
    LAUNCHES["gather_count_multi"] += 1
    return out


# ---------------------------------------------------------------------------
# gather_count_tree (fused_gather_count_tree)
# ---------------------------------------------------------------------------

# Leaf counts the tree kernel is built for: depths 1-4 (the executor's
# _TREE_DEPTH_MAX is 4).
TREE_LEAVES = (2, 4, 8, 16)
# The most ints a launch carries in its own parameters (B x K leaf ids and
# two opcode words a tree): gather_count_tree.cu's kParamInts.
TREE_PARAM_INTS = 1000


def _right_turns(k: int) -> np.ndarray:
    """float32[K - 1, K]: 1 where node i (level-major bottom-up, as the
    opcodes) lies on leaf j's path to the root and leaf j comes up to it
    from the right, so that a PASS at node i kills leaf j."""
    m = np.zeros((max(k - 1, 0), k), dtype=np.float32)
    for j in range(k):
        off, n, level = 0, k // 2, 0
        while n >= 1:
            if (j >> level) & 1:
                m[off + (j >> (level + 1)), j] = 1
            off += n
            n //= 2
            level += 1
    return m


_RIGHT_TURNS = {k: _right_turns(k) for k in TREE_LEAVES}


def tree_live_leaves(opc) -> np.ndarray:
    """Which leaves of each perfect tree reach its root -> bool[B, K], for
    opcodes int[B, K - 1] level-major bottom-up: the root is live, a node
    whose opcode is not 0-3 (TREE_PASS) passes its left child and drops
    its right one, and everything under a dead node is dead.  The rule
    gather_count_tree.cu applies in each block (the launch does not call
    this); a dead leaf's row never changes a count.  One small product a
    batch: the gate calls it on every batch its reuse clause admits."""
    oc = np.asarray(opc)
    k = oc.shape[1] + 1
    turns = _RIGHT_TURNS[k] if k in _RIGHT_TURNS else _right_turns(k)
    # A negative opcode wraps past 3 as uint32: it passes too.
    passing = (oc.astype(np.uint32) > 3).astype(np.float32)
    return passing @ turns == 0


# Opcode i of a tree times 16^(i % 8) in column i // 8: a tree's K - 1
# opcodes times the first K - 1 rows are its two packed words (the 4-bit
# fields never overlap, so the product's sums are their ORs).
_TREE_PACK = np.zeros((15, 2), dtype=np.uint64)  # K - 1 <= 15
_TREE_PACK[np.arange(15), np.arange(15) // 8] = np.uint64(16) ** (np.arange(15) % 8).astype(np.uint64)


def tree_opcode_words(opc) -> np.ndarray:
    """Each tree's K - 1 opcodes packed 4 bits apiece into two words ->
    int32[B, 2]: opcode i in bits 4 (i % 8) of word i // 8, every value
    outside 0-3 as TREE_PASS (the kernel's layout)."""
    oc = np.asarray(opc, dtype=np.int64)
    # A negative opcode wraps past 3 as uint64: it packs as TREE_PASS too.
    oc = np.minimum(oc.astype(np.uint64), bitwise.TREE_PASS)
    return (oc @ _TREE_PACK[:oc.shape[1]]).astype(np.uint32).view(np.int32)


def gather_count_tree_plain(row_matrix, leaves, opc):
    return bitwise.gather_count_tree(row_matrix, leaves, opc)


def gather_count_tree(row_matrix: torch.Tensor, leaves, opc) -> torch.Tensor:
    """Per-query ``sum_s popcount(tree(rm[s, leaves[q]]))`` -> int32[B] for
    a perfect tree of K = 2^D leaves and K - 1 opcodes, level-major
    bottom-up (``bitwise.gather_count_tree`` gives the encoding).  The
    kernel loads only live leaves (``tree_live_leaves``).  A batch of up
    to TREE_PARAM_INTS ids and opcode words crosses in the launch's
    parameters (no upload); a larger batch is uploaded."""
    if _on_cpu(row_matrix):
        return gather_count_tree_plain(row_matrix, leaves, opc)
    _words(row_matrix, "gather_count_tree matrix", 3)
    s, r, w = row_matrix.shape
    lv = _host_ids(leaves, r, "gather_count_tree leaves")
    if lv.ndim != 2 or lv.shape[1] not in TREE_LEAVES:
        raise ValueError(f"gather_count_tree: leaves shape {lv.shape}, want [B, K in {TREE_LEAVES}]")
    b, k = lv.shape
    oc = np.asarray(opc)
    if oc.shape != (b, k - 1):
        raise ValueError(f"gather_count_tree: opc shape {oc.shape}, want {(b, k - 1)}")
    ints = np.concatenate([lv.reshape(-1), tree_opcode_words(oc).reshape(-1)])
    out = row_matrix.new_empty(b)
    dev = None if ints.size <= TREE_PARAM_INTS else _ints(ints, row_matrix.device)
    err = _fn("gather_count_tree")(
        row_matrix.data_ptr(), ints.ctypes.data if dev is None else dev.data_ptr(),
        out.data_ptr(), s, r, w, b, k, _stream(row_matrix),
    )
    _check(err, "gather_count_tree")
    LAUNCHES["gather_count_tree"] += 1
    return out


# ---------------------------------------------------------------------------
# resident_count_tree (fused_gather_count_tree, staged)
# ---------------------------------------------------------------------------

# Trees a block holds (16 warps x 4 trees, partial sums in registers):
# resident_count_tree.cu's kGroup.  A larger batch takes further groups,
# each staging every tile.
TREE_GROUP = 64


def tree_tiling(u: int, w: int, k: int, n_slices: int) -> tuple[int, int]:
    """(chunk_words, stages) of a resident_count_tree launch over U
    distinct leaves of K-leaf trees; chunk_words 0 when nothing fits."""
    return staged_tiling(u, w, tree_group_ints(k), n_slices)


def tree_group_ints(k: int) -> int:
    """resident_count_tree's own shared ints: K leaf offsets and K - 1
    int4 node masks a tree of the group."""
    return TREE_GROUP * (k + 4 * (k - 1))


def resident_count_tree_plain(row_matrix, leaves, opc):
    return bitwise.gather_count_tree(row_matrix, leaves, opc)


def resident_count_tree(row_matrix: torch.Tensor, leaves, opc, compacted=None) -> torch.Tensor:
    """``gather_count_tree``'s function -> int32[B], each distinct leaf
    row of the batch staged in shared memory once per word chunk.
    ``compacted``: ``compact_rows(leaves, R, ...)`` where the caller has
    it already.  On the CPU: the same remap, then the plain version over
    the compacted rows."""
    s, r, w = row_matrix.shape
    if np.ndim(leaves) != 2 or np.shape(leaves)[1] not in TREE_LEAVES:
        raise ValueError(f"resident_count_tree: leaves shape {np.shape(leaves)}, "
                         f"want [B, K in {TREE_LEAVES}]")
    b, k = np.shape(leaves)
    oc = np.ascontiguousarray(opc, dtype=np.int32)
    if oc.shape != (b, k - 1):
        raise ValueError(f"resident_count_tree: opc shape {oc.shape}, want {(b, k - 1)}")
    ids, local = compacted or compact_rows(leaves, r, "resident_count_tree leaves")
    if _on_cpu(row_matrix):
        return resident_count_tree_plain(row_matrix[:, torch.from_numpy(ids).long()], local, oc)
    _words(row_matrix, "resident_count_tree matrix", 3)
    u = ids.size
    out = torch.zeros(b, dtype=torch.int32, device=row_matrix.device)
    if b == 0:
        return out
    chunk, stages = tree_tiling(u, w, k, s)
    if chunk == 0:
        raise ValueError(f"resident_count_tree: {u} rows of {w} words do not fit shared memory")
    dev = _ints(np.concatenate([ids, local.reshape(-1), oc.reshape(-1)]), row_matrix.device)
    base = dev.data_ptr()
    err = _fn("resident_count_tree")(
        row_matrix.data_ptr(), base, base + 4 * u, base + 4 * (u + b * k), out.data_ptr(),
        s, r, w, u, b, k, chunk, stages, _stream(row_matrix),
    )
    _check(err, "resident_count_tree")
    LAUNCHES["resident_count_tree"] += 1
    return out


# ---------------------------------------------------------------------------
# gather_count2_rowmajor (fused_gather_count2_rowmajor)
# ---------------------------------------------------------------------------

def gather_count2_rowmajor_plain(op: str, row_major, pairs):
    return bitwise.gather_count(op, row_major.transpose(0, 1), pairs)


def gather_count2_rowmajor(op: str, row_major: torch.Tensor, pairs) -> torch.Tensor:
    """Per-pair ``sum_s popcount(op(rm[p0, s], rm[p1, s]))`` -> int32[B]
    over a ROW-MAJOR int32[R, S, W] matrix (each row's slices contiguous)."""
    if op not in OPS or op == "none":
        raise ValueError(f"unknown pair op {op!r}")
    if _on_cpu(row_major):
        return gather_count2_rowmajor_plain(op, row_major, pairs)
    _words(row_major, "gather_count2_rowmajor matrix", 3)
    r, s, w = row_major.shape
    p = _ids(pairs, r, row_major.device, "gather_count2_rowmajor pairs")
    if p.dim() != 2 or p.shape[1] != 2:
        raise ValueError(f"gather_count2_rowmajor: pairs shape {tuple(p.shape)}, want [B, 2]")
    b = p.shape[0]
    out = torch.zeros(b, dtype=torch.int32, device=row_major.device)
    err = _fn("gather_count2_rowmajor")(
        row_major.data_ptr(), p.data_ptr(), out.data_ptr(), r, s, w, b, OPS[op],
        _stream(row_major),
    )
    _check(err, "gather_count2_rowmajor")
    LAUNCHES["gather_count2_rowmajor"] += 1
    return out


# ---------------------------------------------------------------------------
# gather_count_multi_rowmajor (fused_gather_count_multi_rowmajor)
# ---------------------------------------------------------------------------

def gather_count_multi_rowmajor_plain(op: str, row_major, idx):
    return bitwise.gather_count_multi(op, row_major.transpose(0, 1), idx)


def gather_count_multi_rowmajor(op: str, row_major: torch.Tensor, idx) -> torch.Tensor:
    """Per-query ``sum_s popcount(fold_j rm[idx[q, j], s])`` -> int32[B]
    over a ROW-MAJOR int32[R, S, W] matrix: the left fold of K >= 1 rows
    (and / or / andnot, andnot folding ``acc & ~row``); any B and K run in
    one launch."""
    if op not in MULTI_OPS:
        raise ValueError(f"unsupported multi-op {op!r}")
    if _on_cpu(row_major):
        return gather_count_multi_rowmajor_plain(op, row_major, idx)
    _words(row_major, "gather_count_multi_rowmajor matrix", 3)
    r, s, w = row_major.shape
    ix = _ids(idx, r, row_major.device, "gather_count_multi_rowmajor idx")
    if ix.dim() != 2 or ix.shape[1] < 1:
        raise ValueError(
            f"gather_count_multi_rowmajor: idx shape {tuple(ix.shape)}, want [B, K >= 1]")
    b, k = ix.shape
    out = torch.zeros(b, dtype=torch.int32, device=row_major.device)
    err = _fn("gather_count_multi_rowmajor")(
        row_major.data_ptr(), ix.data_ptr(), out.data_ptr(), r, s, w, b, k, OPS[op],
        _stream(row_major),
    )
    _check(err, "gather_count_multi_rowmajor")
    LAUNCHES["gather_count_multi_rowmajor"] += 1
    return out


# ---------------------------------------------------------------------------
# resident_count_multi (fused_gather_count_multi and its row-major form, staged)
# ---------------------------------------------------------------------------

# Queries a block holds (16 warps x 8 queries, partial sums in registers):
# resident_count_multi.cu's kGroup.  A larger batch takes further groups,
# each staging every tile.
MULTI_GROUP = 128


def multi_group_ints(batch: int, k: int) -> int:
    """resident_count_multi's own shared ints for one group, at most: each
    query's operand offsets (K, padded to a multiple of four), its count
    of groups of four and its index in the output."""
    return min(batch, MULTI_GROUP) * (-(-k // 4) * 4 + 2)


def multi_tiling(u: int, w: int, batch: int, k: int, n_slices: int) -> tuple[int, int]:
    """(chunk_words, stages) of a resident_count_multi launch over U
    distinct rows named by ``batch`` folds of K operands (K: the padded
    list width, which bounds the wrapper's lists); chunk_words 0 when
    nothing fits (at W = 32,768 about 860 rows at most)."""
    return staged_tiling(u, w, multi_group_ints(batch, k), n_slices)


def _multi_dims(matrix, row_major: bool) -> tuple[int, int, int]:
    """(S, R, W) of a slice-major [S, R, W] or row-major [R, S, W] matrix."""
    if matrix.dim() != 3:
        raise ValueError(f"multi fold: matrix shape {tuple(matrix.shape)}, want 3 dims")
    a, b, w = matrix.shape
    return (b, a, w) if row_major else (a, b, w)


def resident_count_multi_plain(op: str, matrix, idx, row_major: bool = False, compacted=None):
    """resident_count_multi's function on plain tensors: the compaction
    remap, then the plain fold over the compacted rows.  A fold of one
    operand is that row whatever the op (the plain andnot needs two)."""
    _, r, _ = _multi_dims(matrix, row_major)
    ids, local = compacted or compact_rows(idx, r, "resident_count_multi idx")
    rows = torch.from_numpy(ids).long().to(matrix.device)
    sub = matrix[rows].transpose(0, 1) if row_major else matrix[:, rows]
    return bitwise.gather_count_multi("and" if local.shape[1] == 1 else op, sub, local)


def resident_count_multi(op: str, matrix: torch.Tensor, idx, row_major: bool = False,
                         compacted=None) -> torch.Tensor:
    """``gather_count_multi``'s function (``row_major``:
    ``gather_count_multi_rowmajor``'s) -> int32[B], each distinct row the
    batch names staged in shared memory once per word chunk.
    ``compacted``: ``compact_rows(idx, R, ...)`` where the caller has it
    already.  On the CPU: the same remap, then the plain fold over the
    compacted rows."""
    if op not in MULTI_OPS:
        raise ValueError(f"unsupported multi-op {op!r}")
    if np.ndim(idx) != 2 or np.shape(idx)[1] < 1:
        raise ValueError(f"resident_count_multi: idx shape {np.shape(idx)}, want [B, K >= 1]")
    s, r, w = _multi_dims(matrix, row_major)
    ids, local = compacted or compact_rows(idx, r, "resident_count_multi idx")
    if _on_cpu(matrix):
        return resident_count_multi_plain(op, matrix, idx, row_major, (ids, local))
    _words(matrix, "resident_count_multi matrix", 3)
    b, k = local.shape
    out = torch.zeros(b, dtype=torch.int32, device=matrix.device)
    if b == 0:
        return out
    chunk, stages = multi_tiling(ids.size, w, b, k, s)
    if chunk == 0:
        raise ValueError(f"resident_count_multi: {ids.size} rows of {w} words and {b} x {k} "
                         "operands do not fit shared memory")
    return _launch_resident_multi(op, matrix, ids, local, chunk, stages, row_major, out)


def fold_lists(op: str, local: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each query's operands with the repeats the fold ignores dropped
    (and / or: every repeat; andnot: repeats after the first operand),
    padded to a common multiple of four with an operand whose repeat the
    fold ignores, rows ordered by their own length, longest first:
    ``(lists int32[B, K4], n_groups int32[B], order int32[B])`` with row i
    holding the operands of query ``order[i]`` in its first ``4 *
    n_groups[i]`` entries.  The values are the same: a fold repeats what
    it drops."""
    b, k = local.shape
    keep_first = op == "andnot" and k > 1
    rest = np.sort(local[:, 1:] if keep_first else local, axis=1)
    new = np.ones(rest.shape, dtype=bool)
    new[:, 1:] = rest[:, 1:] != rest[:, :-1]
    lead = int(keep_first)
    kq = lead + new.sum(axis=1)
    lists = np.repeat(rest[:, :1], -(-int(kq.max()) // 4) * 4, axis=1)
    rows, cols = np.nonzero(new)
    lists[rows, lead + np.cumsum(new, axis=1)[rows, cols] - 1] = rest[rows, cols]
    if keep_first:
        lists[:, 0] = local[:, 0]
    order = np.argsort(-kq, kind="stable").astype(np.int32)
    return lists[order], ((kq[order] + 3) // 4).astype(np.int32), order


def _launch_resident_multi(op, matrix, ids, local, chunk, stages, row_major, out):
    """One resident_count_multi launch at a given tiling (the wrapper's
    own, or another one a timing compares it with).  A fold of one
    operand is that row whatever the op."""
    s, r, w = _multi_dims(matrix, row_major)
    if local.shape[1] == 1:
        op = "and"
    lists, n_groups, order = fold_lists(op, local)
    u, (b, k4) = ids.size, lists.shape
    dev = _ints(np.concatenate([ids, lists.reshape(-1), n_groups, order]), matrix.device)
    base = dev.data_ptr()
    err = _fn("resident_count_multi")(
        matrix.data_ptr(), base, base + 4 * u, base + 4 * (u + b * k4),
        base + 4 * (u + b * k4 + b), out.data_ptr(),
        s, r, w, u, b, k4, chunk, stages, int(row_major), OPS[op], _stream(matrix),
    )
    _check(err, "resident_count_multi")
    LAUNCHES["resident_count_multi"] += 1
    return out


# ---------------------------------------------------------------------------
# topn_counts (fused_topn_counts)
# ---------------------------------------------------------------------------

def topn_counts_plain(row_matrix, src):
    return bitwise.count(row_matrix & src[:, None]).sum(dim=0, dtype=torch.int32)


def topn_counts(row_matrix: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``sum_s popcount(rm[s, r] & src[s])`` for every row r -> int32[R];
    rm int32[S, R, W], src int32[S, W]."""
    if _on_cpu(row_matrix):
        return topn_counts_plain(row_matrix, src)
    _words(row_matrix, "topn_counts matrix", 3)
    _words(src, "topn_counts src", 2)
    s, r, w = row_matrix.shape
    if tuple(src.shape) != (s, w) or src.device != row_matrix.device:
        raise ValueError(f"topn_counts: src {tuple(src.shape)} vs matrix {(s, r, w)}")
    out = torch.zeros(r, dtype=torch.int32, device=row_matrix.device)
    err = _fn("topn_counts")(
        row_matrix.data_ptr(), src.data_ptr(), out.data_ptr(), s, r, w, _stream(row_matrix),
    )
    _check(err, "topn_counts")
    LAUNCHES["topn_counts"] += 1
    return out


# ---------------------------------------------------------------------------
# pair_gram (the reference's all-pairs Gram, bitwise.py pair_gram)
# ---------------------------------------------------------------------------

# Per-pair counts must stay inside int32: at most S x 2^20 bits a pair.
GRAM_SLICES_MAX = 2047
# Output rows a block tile covers, words a k-tile covers, the depth of
# the staging ring (a stage: two 16 KiB operand tiles) and blocks of two
# consumer warpgroups and a producer warpgroup an SM: pair_gram.cu's
# kTile, kChunk, kStages and kBlocksPerSm.
GRAM_TILE = 128
GRAM_CHUNK_WORDS = 32
GRAM_STAGES = 4
GRAM_BLOCKS_PER_SM = 1


def gram_tile_pairs(n_t: int) -> list[tuple[int, int]]:
    """The upper tile pairs (ti, tj), ti <= tj, of n_t tiles a side, in
    the kernel's order (row-major)."""
    return [(i, j) for i in range(n_t) for j in range(i, n_t)]


def gram_jobs(n_t: int) -> list[tuple[int, int]]:
    """The kernel's jobs, as tile pairs: the upper tile pairs, or with two
    tiles (128 < R <= 256) the one job (0, 1) that covers the whole
    256-row square."""
    return [(0, 1)] if n_t == 2 else gram_tile_pairs(n_t)


def gram_schedule(r: int, s: int, w: int, sms: int) -> dict:
    """pair_gram's launch: the R x R output in ``n_t`` x ``n_t`` tiles of
    GRAM_TILE, computed as ``n_jobs`` jobs (``gram_jobs``); each job's
    contraction in ``n_k`` = S x ``n_chunks`` k-tiles (slice s, word chunk
    c of GRAM_CHUNK_WORDS; k-tile t = s * n_chunks + c); the ``n_units``
    (job, k-tile) units, job-major (unit u = p * n_k + t), walked by
    ``n_blocks`` persistent blocks (GRAM_BLOCKS_PER_SM an SM of ``sms``),
    block g taking ``gram_block_units``, each unit staged in ring stage
    ``i % GRAM_STAGES`` (i its place in the block's run)."""
    n_t = -(-r // GRAM_TILE)
    n_jobs = len(gram_jobs(n_t))
    n_chunks = -(-w // GRAM_CHUNK_WORDS)
    n_k = s * n_chunks
    n_units = n_jobs * n_k
    return {"n_t": n_t, "n_jobs": n_jobs, "n_chunks": n_chunks, "n_k": n_k,
            "n_units": n_units, "n_blocks": min(n_units, GRAM_BLOCKS_PER_SM * sms)}


def gram_block_units(sched: dict, g: int) -> range:
    """The units of block g in the order it walks them: with one job,
    g, g + B, g + 2B, ... of B blocks; otherwise the contiguous, balanced
    run [g*U/B, (g+1)*U/B)."""
    u, n = sched["n_units"], sched["n_blocks"]
    if sched["n_jobs"] == 1:
        return range(g, u, n)
    return range(g * u // n, (g + 1) * u // n)


def gram_unit(sched: dict, u: int) -> tuple[int, int, int, int]:
    """(ti, tj, slice, chunk) of unit u."""
    p, t = divmod(u, sched["n_k"])
    s, c = divmod(t, sched["n_chunks"])
    ti, tj = gram_jobs(sched["n_t"])[p]
    return ti, tj, s, c


def pair_gram_plain(row_matrix):
    return bitwise.pair_gram(row_matrix)


def pair_gram(row_matrix: torch.Tensor) -> torch.Tensor:
    """All-pairs AND-count Gram ``G[i, j] = sum_s popcount(rm[s, i] &
    rm[s, j])`` -> int64[R, R] for int32[S, R, W] (S <= GRAM_SLICES_MAX).
    On the card the matrix may be a view with any slice and row strides
    (multiples of 4 words; words contiguous): the executor's
    ``m[:, :bucket, :]`` of a pool is not copied.  The kernel counts in
    int32; the result is widened on the card."""
    if row_matrix.dtype != torch.int32:
        raise TypeError(f"pair_gram: expected int32 words, got {row_matrix.dtype}")
    if row_matrix.dim() != 3:
        raise ValueError(f"pair_gram: expected [S, R, W], got shape {tuple(row_matrix.shape)}")
    s, r, w = row_matrix.shape
    if s > GRAM_SLICES_MAX:
        raise ValueError(f"pair_gram: {s} slices overflow int32 counts "
                         f"(at most {GRAM_SLICES_MAX})")
    if _on_cpu(row_matrix):
        return pair_gram_plain(row_matrix)
    ss, rs, ws = row_matrix.stride()
    if (w and ws != 1) or w % 4 or ss % 4 or rs % 4 or row_matrix.data_ptr() % 16:
        raise ValueError("pair_gram: rows must be 16-byte aligned words (W, strides % 4 == 0)")
    out = torch.zeros((r, r), dtype=torch.int32, device=row_matrix.device)
    if s == 0 or r == 0 or w == 0:
        return out.to(torch.int64)
    sched = gram_schedule(r, s, w, sm_count(row_matrix.device))
    err = _fn("pair_gram")(
        row_matrix.data_ptr(), out.data_ptr(), s, r, w, ss, rs, sched["n_blocks"],
        _stream(row_matrix),
    )
    _check(err, "pair_gram")
    LAUNCHES["pair_gram"] += 1
    return out.to(torch.int64)


# ---------------------------------------------------------------------------
# build_planes (the reference's device bulk build, bulk/build.py build_planes_jax)
# ---------------------------------------------------------------------------

# Words a (slice, row) plane holds: the packed device row layout.
PLANE_WORDS = SLICE_WIDTH // 32
# Arena words a block tile covers (16 KiB of shared memory), threads a
# block (keys a window, probes a search step) and persistent blocks an
# SM: build_planes.cu's kTileWords, kThreads and kBlocksPerSm.
BUILD_TILE_WORDS = 4096
BUILD_THREADS = 256
BUILD_BLOCKS_PER_SM = 4


def build_schedule(n_groups: int, sms: int) -> dict:
    """build_planes' launch: the [G, PLANE_WORDS] arena in ``n_tiles``
    tiles of BUILD_TILE_WORDS words, walked by ``n_blocks`` persistent
    blocks (BUILD_BLOCKS_PER_SM an SM of ``sms``, at most one a tile),
    block b taking the tiles ``build_block_tiles``."""
    n_tiles = n_groups * PLANE_WORDS // BUILD_TILE_WORDS
    return {"n_tiles": n_tiles, "n_blocks": min(n_tiles, BUILD_BLOCKS_PER_SM * sms)}


def build_block_tiles(sched: dict, b: int) -> tuple[int, int]:
    """Tiles [t0, t1) of block b: a contiguous, balanced run."""
    t, n = sched["n_tiles"], sched["n_blocks"]
    return b * t // n, (b + 1) * t // n


def build_planes_plain(keys, n_groups: int):
    """The reference's steps: sort the keys, drop each key that repeats
    the one before it (and any key outside the arena, as the reference
    drops its pads), ``index_add_`` each bit value into an int64 arena
    (distinct powers of two never carry, so the sum is the OR), and read
    the low 32 bits of each int64 word as the int32 word."""
    keys = torch.sort(keys).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    k = keys[first & (keys >= 0) & (keys < n_groups * SLICE_WIDTH)]
    out = torch.zeros(n_groups * PLANE_WORDS, dtype=torch.int64, device=keys.device)
    out.index_add_(0, k >> 5, torch.ones_like(k) << (k & 31))
    # Little-endian int64 words: the int32 view's even entries are the low halves.
    return out.view(torch.int32)[0::2].reshape(n_groups, PLANE_WORDS)


def build_planes(keys: torch.Tensor, n_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Word planes of a bulk chunk -> ``(planes, descents)``: planes
    int32[G, PLANE_WORDS], bit ``key % 2^20`` of plane ``key // 2^20`` set
    for every key (int64[N], key = group * SLICE_WIDTH + local column, in
    ascending order, repeats allowed); keys outside [0, G * SLICE_WIDTH)
    are dropped.  ``descents`` (int32) is nonzero where a key lies below
    the one before it: the planes are then wrong, and the caller, once it
    has the flags on the host, raises (``raise_on_descent``).  On the card
    the kernel writes every word of the planes once and the flags in the
    same allocation right after them (``planes_and_descents``), so one
    copy brings both back; G = 0 launches nothing."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise TypeError(f"build_planes: expected int64[N] keys, got {keys.dtype}{tuple(keys.shape)}")
    if n_groups < 0:
        raise ValueError(f"build_planes: {n_groups} groups")
    if _on_cpu(keys):
        descents = (keys[1:] < keys[:-1]).sum(dtype=torch.int32).reshape(1)
        return build_planes_plain(keys, n_groups), descents
    if not keys.is_contiguous():
        raise ValueError("build_planes keys: must be contiguous")
    if n_groups == 0:
        return (torch.empty((0, PLANE_WORDS), dtype=torch.int32, device=keys.device),
                torch.zeros(0, dtype=torch.int32, device=keys.device))
    n_words = n_groups * PLANE_WORDS
    n_blocks = build_schedule(n_groups, sm_count(keys.device))["n_blocks"]
    buf = torch.empty(n_words + n_blocks, dtype=torch.int32, device=keys.device)
    ptr = buf.data_ptr()
    err = _fn("build_planes")(keys.data_ptr(), keys.numel(), ptr, n_words, ptr + 4 * n_words,
                              n_blocks, _stream(keys))
    _check(err, "build_planes")
    LAUNCHES["build_planes"] += 1
    planes, descents = buf.split((n_words, n_blocks))
    return planes.view(n_groups, PLANE_WORDS), descents


def planes_and_descents(planes: torch.Tensor, descents: torch.Tensor) -> torch.Tensor:
    """The one 1-D int32 run behind ``build_planes``' two results on the
    card (the planes, then the flags): one copy brings both back."""
    n = planes.numel()
    whole = torch.as_strided(planes, (n + descents.numel(),), (1,), planes.storage_offset())
    if descents.numel() and whole[n:].data_ptr() != descents.data_ptr():
        raise ValueError("build_planes: the descent flags do not follow the planes")
    return whole


def raise_on_descent(descents) -> None:
    """Raise if any of ``build_planes``' descent flags (read on the host)
    is set: its keys were not in ascending order."""
    if np.asarray(descents).any():
        raise ValueError("build_planes: keys not in ascending order")
