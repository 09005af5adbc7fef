"""Smoke run of pilosa_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Probes the card (fails without CUDA) and prints its name and power
   limit as nvidia-smi reports them.
2. Builds the four CUDA kernels from ``pilosa_tpu_torch/csrc`` with nvcc
   (one process per source, all started together).
3. Holds each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it, for every op variant; exact
   equality (integer counts), and times both with CUDA events beside the
   kernel's memory bound.
4. Drives the main path — ``Executor.execute`` over a ``Holder`` — at 64
   slices x 256 rows (the default 2 GiB row-pool budget holds all of them)
   with 2,000 seeded random bits per row per slice: batched pair Counts
   (direct resident kernel, then the cached Gram and the native lookup
   lane), pair Counts on a ``no_gram`` executor (gather kernel), Counts
   that reach the sequential path (count kernel), and a TopN with a
   source bitmap (both TopN kernels).  Every answer is checked against
   the same port's ``Executor(engine="numpy")`` on the same holder (for
   pair requests, a seeded 16-query subset of each request).
5. Fails unless every kernel's launch counter moved during the main path.

Prints a ``{"card": ..., "requests": [...]}`` line, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Any failure raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels

SLICE_WIDTH = 1 << 20
W = SLICE_WIDTH // 32

# Main-path size: 64 slices x 256 rows x 128 KiB = 2 GiB, exactly the
# default per-pool budget (PILOSA_TPU_POOL_BYTES); 64 slices is the most
# at which TopN's scorer pool still holds one 256-row candidate chunk.
N_SLICES = 64
N_ROWS = 256
BITS_PER_ROW = 2000
PAIR_BATCH = 256
GATHER_BATCH = 16
SUBSET = 16
SEED = 7

# H100 SXM published peaks (NVIDIA data sheet) used for the bounds: HBM3
# bandwidth, and the 32-bit non-tensor-core rate for the integer word ops.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# Integer ops per 32-bit word: pair op, popc, add (2 without a pair op).
OPS_PER_WORD = 3

SOURCES = {
    "count_rows": "pilosa_tpu_torch/csrc/count_rows.cu",
    "resident_count2": "pilosa_tpu_torch/csrc/resident_count2.cu",
    "gather_count2": "pilosa_tpu_torch/csrc/gather_count2.cu",
    "gather_src_counts": "pilosa_tpu_torch/csrc/gather_src_counts.cu",
}
REPLACES = {
    "count_rows": "pilosa_tpu/ops/pallas_kernels.py:82",  # fused_count2 (+ fused_count1 :668)
    "resident_count2": "pilosa_tpu/ops/pallas_kernels.py:186",
    "gather_count2": "pilosa_tpu/ops/pallas_kernels.py:240",
    "gather_src_counts": "pilosa_tpu/ops/pallas_kernels.py:342",
}
PAIR_OPS = ("and", "or", "xor", "andnot")
PQL_OPS = {"and": "Intersect", "or": "Union", "andnot": "Difference", "xor": "Xor"}


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush_buf = None


def _flush_l2() -> None:
    """Overwrite more than the 50 MB L2 so the next launch reads cold,
    as the main path's callers find the matrices."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _flush_buf.zero_()


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of fn() in ms: CUDA events around each launch,
    the L2 flushed before each."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        _flush_l2()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the 32-bit rate, in ms."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: card
# ---------------------------------------------------------------------------

def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs the card")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = out[0].strip()
    print(card, flush=True)
    # pair_gram's exactness needs full fp32 products (the default).
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_words(gen, shape) -> torch.Tensor:
    return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device="cuda", generator=gen)


def check_kernels() -> dict:
    """Every kernel == its plain version on the card for every op
    variant, at the main path's shapes; returns per-kernel timings."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rm = _rand_words(gen, (N_SLICES, N_ROWS, W))
    stack = _rand_words(gen, (N_SLICES, W))
    rows = rm[0].contiguous()  # [256, W]: a TopN candidate chunk
    src = _rand_words(gen, (W,))
    rng = np.random.default_rng(SEED)
    err = dict.fromkeys(kernels.KERNELS, 0)

    def diff(name, got, want):
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
        d = int((got.long() - want.long()).abs().max().item()) if got.numel() else 0
        err[name] = max(err[name], d)
        if d:
            raise AssertionError(f"{name}: kernel differs from its plain version by {d}")

    # count_rows: no op over a [64, W] stack (Count), every op against a
    # shared src (TopN scoring) and against per-row operands.
    diff("count_rows", kernels.count_rows(stack), kernels.count_rows_plain(stack))
    for op in PAIR_OPS:
        diff("count_rows", kernels.count_rows(rows, src, op), kernels.count_rows_plain(rows, src, op))
        other = rm[1].contiguous()
        diff("count_rows", kernels.count_rows(rows, other, op), kernels.count_rows_plain(rows, other, op))
    pairs_r = rng.integers(0, N_ROWS, size=(PAIR_BATCH, 2)).astype(np.int32)
    pairs_g = rng.integers(0, N_ROWS, size=(GATHER_BATCH, 2)).astype(np.int32)
    pos = rng.permutation(N_ROWS).astype(np.int32)
    for op in PAIR_OPS:
        diff("resident_count2", kernels.resident_count2(op, rm, pairs_r),
             kernels.resident_count2_plain(op, rm, pairs_r))
        diff("gather_count2", kernels.gather_count2(op, rm, pairs_g),
             kernels.gather_count2_plain(op, rm, pairs_g))
    diff("gather_src_counts", kernels.gather_src_counts(rm, pos, stack),
         kernels.gather_src_counts_plain(rm, pos, stack))
    torch.cuda.synchronize()

    # Timings at the main path's shapes; bytes count each input the
    # function needs once (the rows this run's ids reference).
    def uniq(ids):
        return len(np.unique(ids))

    row_b = W * 4
    res = {}
    nb, by = bound(N_ROWS * row_b + row_b + N_ROWS * 4, N_ROWS * W * OPS_PER_WORD)
    res["count_rows"] = dict(
        shape=f"[{N_ROWS}, {W}] & shared src (TopN phase 1)",
        ms=cuda_ms(lambda: kernels.count_rows(rows, src, "and")),
        plain_ms=cuda_ms(lambda: kernels.count_rows_plain(rows, src, "and"), reps=5),
        bound_ms=nb, bound_by=by,
    )
    nb, by = bound(N_SLICES * W * 4 + N_SLICES * 4, N_SLICES * W * 2)
    res["count_rows"]["count_path"] = dict(
        shape=f"[{N_SLICES}, {W}] no op (sequential Count)",
        ms=cuda_ms(lambda: kernels.count_rows(stack)),
        plain_ms=cuda_ms(lambda: kernels.count_rows_plain(stack), reps=5),
        bound_ms=nb, bound_by=by,
    )
    nb, by = bound(N_SLICES * uniq(pairs_r) * row_b + pairs_r.nbytes + PAIR_BATCH * 4,
                   N_SLICES * PAIR_BATCH * W * OPS_PER_WORD)
    res["resident_count2"] = dict(
        shape=f"rm [{N_SLICES}, {N_ROWS}, {W}], {PAIR_BATCH} pairs, and",
        ms=cuda_ms(lambda: kernels.resident_count2("and", rm, pairs_r)),
        plain_ms=cuda_ms(lambda: kernels.resident_count2_plain("and", rm, pairs_r), reps=3),
        bound_ms=nb, bound_by=by,
    )
    nb, by = bound(N_SLICES * uniq(pairs_g) * row_b + pairs_g.nbytes + GATHER_BATCH * 4,
                   N_SLICES * GATHER_BATCH * W * OPS_PER_WORD)
    res["gather_count2"] = dict(
        shape=f"rm [{N_SLICES}, {N_ROWS}, {W}], {GATHER_BATCH} pairs, and",
        ms=cuda_ms(lambda: kernels.gather_count2("and", rm, pairs_g)),
        plain_ms=cuda_ms(lambda: kernels.gather_count2_plain("and", rm, pairs_g), reps=5),
        bound_ms=nb, bound_by=by,
    )
    nb, by = bound(N_SLICES * uniq(pos) * row_b + N_SLICES * row_b + pos.nbytes
                   + N_SLICES * N_ROWS * 4, N_SLICES * N_ROWS * W * OPS_PER_WORD)
    res["gather_src_counts"] = dict(
        shape=f"rm [{N_SLICES}, {N_ROWS}, {W}], {N_ROWS} candidates",
        ms=cuda_ms(lambda: kernels.gather_src_counts(rm, pos, stack)),
        plain_ms=cuda_ms(lambda: kernels.gather_src_counts_plain(rm, pos, stack), reps=3),
        bound_ms=nb, bound_by=by,
    )
    for name in res:
        res[name]["max_abs_err"] = err[name]
    del rm, stack, rows
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path through Executor.execute
# ---------------------------------------------------------------------------

def build_holder(path: str, n_slices: int, n_rows: int, bits: int, seed: int):
    """Index ``i``, frame ``f``; every row gets ``bits`` distinct seeded
    random columns in every slice (so every row counts exactly ``bits``
    per slice and the TopN candidate order is the same in every slice),
    loaded with ``Frame.import_bits``."""
    from pilosa_tpu_torch.core.frame import FrameOptions
    from pilosa_tpu_torch.core.holder import Holder

    h = Holder(path)
    h.open()
    idx = h.create_index("i")
    idx.create_frame("f", FrameOptions())
    fr = idx.frame("f")
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.uint64), bits)
    for s in range(n_slices):
        cols = np.concatenate(
            [rng.choice(SLICE_WIDTH, size=bits, replace=False) for _ in range(n_rows)]
        ).astype(np.uint64) + np.uint64(s * SLICE_WIDTH)
        fr.import_bits(rows, cols)
    return h


def _pair_body(op: str, pairs) -> str:
    f = PQL_OPS[op]
    return "".join(
        f'Count({f}(Bitmap(rowID={a}, frame="f"), Bitmap(rowID={b}, frame="f")))'
        for a, b in pairs
    )


def _norm(res):
    """Results as plain values (TopN pairs -> (id, count) tuples)."""
    return [[(p.id, p.count) for p in r] if isinstance(r, list) else r for r in res]


def main_path(ex, ex_nogram, ex_ref, n_rows: int, sync=lambda: None) -> list[dict]:
    """Drive the requests; check every answer against ``ex_ref``.
    Returns per-request records (wall ms, launches by kernel)."""
    rng = np.random.default_rng(SEED + 1)
    records = []

    def run(name, executor, body, ref_body=None, pick=None, expect=()):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        got = _norm(executor.execute("i", body))
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] > before[k]}
        want = _norm(ex_ref.execute("i", ref_body if ref_body is not None else body))
        cmp = [got[i] for i in pick] if pick is not None else got
        if cmp != want:
            raise AssertionError(f"{name}: port answers differ from the numpy engine: {cmp[:4]} vs {want[:4]}")
        for k in expect:
            if not launched.get(k):
                raise AssertionError(f"{name}: expected {k} to launch, launches {launched}")
        records.append({"request": name, "ms": ms, "checked": len(cmp), "launches": launched})
        return got

    def pair_request(name, executor, op, n, expect=()):
        # Full batches name every row (first operands walk a permutation),
        # so the pool's working set is whole from the first request and
        # the second request against it finds the cache box warm.
        pairs = rng.integers(0, n_rows, size=(n, 2))
        if n >= n_rows:
            pairs[:, 0] = np.resize(rng.permutation(n_rows), n)
        sub = sorted(rng.choice(n, size=min(SUBSET, n), replace=False).tolist())
        run(name, executor, _pair_body(op, pairs), _pair_body(op, pairs[sub]), sub, expect)

    # Batched pair Counts: the first takes the direct resident kernel;
    # once the pool entry has 2 hits the Gram builds and answers, then
    # the native lookup lane serves.
    pair_request("pairs-1 Intersect", ex, "and", PAIR_BATCH, expect=("resident_count2",))
    pair_request("pairs-2 Union", ex, "or", PAIR_BATCH)
    pair_request("pairs-3 Difference", ex, "andnot", PAIR_BATCH)
    # A no-Gram executor: small batches against a taller pool -> gather.
    pair_request("gather-1 Xor", ex_nogram, "xor", GATHER_BATCH, expect=("gather_count2",))
    pair_request("gather-2 Intersect", ex_nogram, "and", GATHER_BATCH, expect=("gather_count2",))
    # Single Counts take the sequential path (count kernel): the flat
    # lane fuses only multi-call bodies, and a write in the body keeps
    # the fused lanes off it.
    a, b = (int(x) for x in rng.integers(0, n_rows, size=2))
    one = f'Count(Intersect(Bitmap(rowID={a}, frame="f"), Bitmap(rowID={b}, frame="f")))'
    run("count-single", ex, one, expect=("count_rows",))
    col = int(rng.integers(0, SLICE_WIDTH))
    got = run("setbit+count", ex, f'SetBit(rowID={a}, frame="f", columnID={col}) ' + one,
              ref_body=one, pick=[1], expect=("count_rows",))
    if not isinstance(got[0], bool):
        raise AssertionError(f"setbit+count: SetBit answered {got[0]!r}")
    # After the write: the pool patches the written row and repairs the
    # Gram (rank-k pair counts on the card) before serving.
    pair_request("pairs-4 Xor after write", ex, "xor", PAIR_BATCH)
    # TopN with a source bitmap: phase 1 scores each slice's candidates
    # (count kernel, shared src); the merged-id refetch asked by a second
    # slice upgrades to one all-slice launch (gather_src_counts).
    run("topn", ex, 'TopN(Bitmap(rowID=0, frame="f"), frame="f", n=10)',
        expect=("count_rows", "gather_src_counts"))
    return records


def main() -> int:
    card = probe()
    t0 = time.perf_counter()
    per_source = kernels.build()
    print(f"build_s {time.perf_counter() - t0:.3f} per-source {json.dumps(per_source)}", flush=True)

    timings = check_kernels()
    print("kernels match their plain versions on the card", flush=True)

    from pilosa_tpu_torch.executor import Executor

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        h = build_holder(d, N_SLICES, N_ROWS, BITS_PER_ROW, SEED)
        print(f"holder_s {time.perf_counter() - t0:.3f} ({N_SLICES} slices x {N_ROWS} rows)", flush=True)
        ex = Executor(h)  # engine "auto": TorchEngine("cuda")
        ex_nogram = Executor(h, no_gram=True)
        ex_ref = Executor(h, engine="numpy")
        if ex.engine.name != "torch" or ex.engine.device.type != "cuda":
            raise AssertionError(f"default engine is {ex.engine.name} on {ex.engine.device}")
        kernels.reset_launches()
        records = main_path(ex, ex_nogram, ex_ref, N_ROWS, sync=torch.cuda.synchronize)
        launches = dict(kernels.LAUNCHES)
        h.close()
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    line = []
    for name in kernels.KERNELS:
        t = timings[name]
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "shape": t["shape"],
        }
        if "count_path" in t:
            entry["count_path"] = t["count_path"]
        line.append(entry)
    print(json.dumps({"card": card, "requests": records}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
