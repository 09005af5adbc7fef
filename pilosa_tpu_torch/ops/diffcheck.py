"""Differential sweep: every kernel and strategy lane against numpy.

For each lane — whole-row counts, the resident, slice-major gather and
row-major gather pair kernels, the multi fold over both layouts, the
TopN scorer over every row, the three plain Gram tiers (one step, per
slice, word-chunked through ``bitwise.pair_gram``'s ``step_bytes``:
cross-checks of the plain version) and the dispatch layer, whose Gram
lane is the engine's route (``kernels.pair_gram``: the Gram kernel on
the card) — it generates random (shape, op, density) cases and requires
EXACT agreement with a pure-numpy ground truth.  The shapes, batch,
operand counts, densities and ground truths are the JAX package's
(``pilosa_tpu/ops/diffcheck.py``), so the same seed draws the same cases.

Every lane runs through the port's wrappers: on a CUDA device they
launch the hand-written kernels, on the CPU their plain PyTorch versions.
Two consumers: ``tests/test_torch_diffcheck.py`` (CPU) and
``chip_smoke.py``'s diffcheck phase (the card).

The port adds the staged tree kernel's lanes (``resident_tree:k{K}``,
K = 2, 4, 8, 16; opcodes 0-5, so pass nodes too) and the staged multi
fold's (``resident_multi:{op}`` slice-major and ``rmresident_multi:{op}``
row-major; K = 1, 3, 16, 23 in turn), each drawn from a generator of its
own so the shared lanes keep the JAX sweep's cases.  Two lanes
of the JAX sweep have no counterpart here: ``count2_tiled:*``
and ``dispatch4:*`` check the TPU's (8, 128)-tiled 4-D matrix form, and
the port stores every matrix as plain ``[S, R, W]`` (``lane_names`` leaves
them out).
"""

from __future__ import annotations

import numpy as np
import torch

from pilosa_tpu_torch.ops import bitwise as bw
from pilosa_tpu_torch.ops import dispatch, kernels

# Words must be a multiple of 4 (the kernels' 16-byte loads).
SHAPES = [  # (n_slices, n_rows, words)
    (1, 8, 1024),
    (2, 16, 2048),
    (3, 48, 1024),
    (2, 64, 3072),
]
B = 16  # queries per case
KS = (2, 4)  # multi-fold operand buckets
TREE_KS = (2, 4, 8, 16)  # staged tree lanes: leaves per tree
RESIDENT_MULTI_KS = (1, 3, 16, 23)  # staged multi lanes: operands per fold
PAIR_OPS = ("and", "or", "xor", "andnot")
MULTI_OPS = ("and", "or", "andnot")


def _random_words(rng: np.random.Generator, shape, density_k: int) -> np.ndarray:
    """uint32 words with controlled bit density: AND of k draws ~ 2^-k
    density, OR of k draws ~ 1 - 2^-k; k=0 -> all zeros, k=-1 -> all ones.
    Extreme densities are where popcount accumulators and fold-identity
    padding break."""
    if density_k == 0:
        return np.zeros(shape, dtype=np.uint32)
    if density_k == -1:
        return np.full(shape, 0xFFFFFFFF, dtype=np.uint32)
    out = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    for _ in range(abs(density_k) - 1):
        nxt = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
        out = (out & nxt) if density_k > 0 else (out | nxt)
    return out


_DENSITIES = (1, 3, -3, 0, -1)  # ~0.5, ~0.125, ~0.875, zeros, ones


def gen_case(rng: np.random.Generator, shape):
    """One random case for a shape bucket."""
    s, r, w = shape
    dk = int(rng.choice(_DENSITIES))
    rm = _random_words(rng, (s, r, w), dk)
    pairs = rng.integers(0, r, size=(B, 2), dtype=np.int32)
    idx = {k: rng.integers(0, r, size=(B, k), dtype=np.int32) for k in KS}
    src = _random_words(rng, (s, w), 1)
    return rm, pairs, idx, src


# ---- numpy ground truths ---------------------------------------------------

_np_pop = bw.np_popcount


def _np_pair(op: str, a: np.ndarray, b: np.ndarray) -> int:
    fn = {
        "and": bw.np_count_and,
        "or": bw.np_count_or,
        "xor": bw.np_count_xor,
        "andnot": bw.np_count_andnot,
    }[op]
    return int(fn(a, b))


def np_pair_counts(op: str, rm: np.ndarray, pairs: np.ndarray) -> list[int]:
    return [
        sum(_np_pair(op, rm[s, int(p0)], rm[s, int(p1)]) for s in range(rm.shape[0]))
        for p0, p1 in pairs
    ]


def np_multi_counts(op: str, rm: np.ndarray, idx: np.ndarray) -> list[int]:
    return [int(v) for v in bw.np_gather_count_multi(op, rm, idx)]


def np_topn_counts(rm: np.ndarray, src: np.ndarray) -> list[int]:
    return [
        int(_np_pop(rm[:, ri, :] & src).sum()) for ri in range(rm.shape[1])
    ]


def np_gram(rm: np.ndarray) -> np.ndarray:
    r = rm.shape[1]
    out = np.zeros((r, r), dtype=np.int64)
    for i in range(r):
        for j in range(r):
            out[i, j] = sum(
                _np_pop(rm[s, i] & rm[s, j]).sum() for s in range(rm.shape[0])
            )
    return out


# ---- lane runners ----------------------------------------------------------

def run_lanes(seed: int, cases_per_lane: int, device="cuda") -> list[str]:
    """Run every lane over generated cases on ``device`` ("cuda": the
    kernels; "cpu": their plain versions); returns failure descriptions
    (empty = all lanes agree with numpy everywhere)."""
    dev = torch.device(device)
    failures: list[str] = []
    rng = np.random.default_rng(seed)
    tree_rng = np.random.default_rng([seed, 1])
    multi_rng = np.random.default_rng([seed, 2])

    def check(lane: str, case_i: int, got, want) -> None:
        got = np.asarray(got.cpu() if torch.is_tensor(got) else got)
        got = got.astype(np.int64).reshape(-1).tolist()
        want = list(want) if isinstance(want, (list, tuple)) else [want]
        if got[: len(want)] != want:
            failures.append(
                f"{lane}[case {case_i}]: got {got[:len(want)][:6]}... want {want[:6]}..."
            )

    for ci in range(cases_per_lane):
        shape = SHAPES[ci % len(SHAPES)]
        s, r, w = shape
        rm, pairs, idx, src = gen_case(rng, shape)
        rmd = bw.to_words(rm, dev)
        rmt = bw.to_words(rm.transpose(1, 0, 2), dev)  # row-major [R, S, W]
        srcd = bw.to_words(src, dev)
        # Drawn in the JAX sweep's order, so a seed gives the same cases.
        op = PAIR_OPS[int(rng.integers(len(PAIR_OPS)))]
        mop = MULTI_OPS[int(rng.integers(len(MULTI_OPS)))]
        k = KS[int(rng.integers(len(KS)))]

        # Whole-row counts (fused_count1 / fused_count2: count_rows).
        a2, b2 = rm[0], rm[(s - 1) % s]
        a2d, b2d = rmd[0], rmd[(s - 1) % s]
        check("count1", ci, kernels.count_rows(a2d).sum(), int(_np_pop(a2).sum()))
        check(f"count2:{op}", ci, kernels.count_rows(a2d, b2d, op).sum(), _np_pair(op, a2, b2))

        want_pairs = np_pair_counts(op, rm, pairs)
        check(f"resident:{op}", ci, kernels.resident_count2(op, rmd, pairs), want_pairs)
        check(f"gather:{op}", ci, kernels.gather_count2(op, rmd, pairs), want_pairs)
        check(f"rmgather:{op}", ci, kernels.gather_count2_rowmajor(op, rmt, pairs), want_pairs)
        # Multi-fold lanes, both layouts.
        want_multi = np_multi_counts(mop, rm, idx[k])
        check(f"multi:{mop}:k{k}", ci, kernels.gather_count_multi(mop, rmd, idx[k]), want_multi)
        check(f"rmmulti:{mop}:k{k}", ci,
              kernels.gather_count_multi_rowmajor(mop, rmt, idx[k]), want_multi)
        # The staged tree fold (its own generator: the draws above stay
        # the JAX sweep's).
        tk = TREE_KS[ci % len(TREE_KS)]
        leaves = tree_rng.integers(0, r, size=(B, tk), dtype=np.int32)
        opc = tree_rng.integers(0, 6, size=(B, tk - 1), dtype=np.int32)
        check(f"resident_tree:k{tk}", ci, kernels.resident_count_tree(rmd, leaves, opc),
              [int(v) for v in bw.np_gather_count_tree(rm, leaves, opc)])
        # The staged multi fold, both layouts (a generator of its own too).
        rop = MULTI_OPS[ci % len(MULTI_OPS)]
        ridx = multi_rng.integers(0, r, size=(B, RESIDENT_MULTI_KS[ci % len(RESIDENT_MULTI_KS)]),
                                  dtype=np.int32)
        want_res = np_multi_counts(rop, rm, ridx)
        check(f"resident_multi:{rop}", ci, kernels.resident_count_multi(rop, rmd, ridx), want_res)
        check(f"rmresident_multi:{rop}", ci,
              kernels.resident_count_multi(rop, rmt, ridx, row_major=True), want_res)
        # TopN scorer over every row.
        check("topn", ci, kernels.topn_counts(rmd, srcd), np_topn_counts(rm, src))

        # Plain Gram tiers: one step, one slice per step, a quarter slice
        # per step.
        want_gram = np_gram(rm)
        tiers = (("gram_oneshot", bw.GRAM_STEP_BYTES), ("gram_scan", r * w * 32 * 4),
                 ("gram_chunked", r * (w // 4) * 32 * 4))
        for lane, step in tiers:
            got_g = bw.pair_gram(rmd, step_bytes=step)
            if not np.array_equal(got_g.cpu().numpy(), want_gram):
                failures.append(f"{lane}[case {ci}]: gram mismatch")
        # Gram count identities answer every pair op.
        pd = torch.as_tensor(pairs, device=dev).long()
        check(f"gram_pairs:{op}", ci,
              bw.gram_pair_counts(op, torch.as_tensor(want_gram, device=dev), pd), want_pairs)

        # Dispatch layer: its chosen pair kernel, the Gram lane as the
        # executor runs it (the engine's Gram route, then the identities),
        # the fold.
        got_one = kernels.pair_gram(rmd)
        if not np.array_equal(got_one.cpu().numpy(), want_gram):
            failures.append(f"dispatch_gram:{op}[case {ci}]: gram mismatch")
        check(f"dispatch:{op}", ci, dispatch.gather_count(op, rmd, pairs), want_pairs)
        check(f"dispatch_gram:{op}", ci, bw.gram_pair_counts(op, got_one, pd), want_pairs)
        check(f"dispatch_multi:{mop}", ci, dispatch.gather_count_multi(mop, rmd, idx[k]),
              want_multi)

    return failures


def lane_names() -> set[str]:
    """The lane identifiers run_lanes covers (for coverage assertions)."""
    lanes = {"count1", "topn", "gram_oneshot", "gram_scan", "gram_chunked"}
    lanes |= tree_lane_names() | resident_multi_lane_names()
    for op in PAIR_OPS:
        lanes |= {f"count2:{op}", f"resident:{op}", f"gather:{op}", f"rmgather:{op}",
                  f"gram_pairs:{op}", f"dispatch:{op}", f"dispatch_gram:{op}"}
    for mop in MULTI_OPS:
        for k in KS:
            lanes |= {f"multi:{mop}:k{k}", f"rmmulti:{mop}:k{k}"}
        lanes.add(f"dispatch_multi:{mop}")
    return lanes


def tree_lane_names() -> set[str]:
    """The staged tree kernel's lanes (the port's own, beyond the JAX
    sweep's)."""
    return {f"resident_tree:k{k}" for k in TREE_KS}


def resident_multi_lane_names() -> set[str]:
    """The staged multi fold's lanes, both layouts (the port's own)."""
    return {f"{p}resident_multi:{op}" for op in MULTI_OPS for p in ("", "rm")}
