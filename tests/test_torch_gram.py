"""The Gram kernel's and the redesigned gather_count2's host side against
the JAX package.

``kernels.pair_gram`` runs a tensor-core kernel on the card; on a CPU
tensor it takes its plain version (``bitwise.pair_gram``).  These tests
hold that path, the engine's Gram and the wrapper's checks against the
JAX Gram (``pilosa_tpu.ops.bitwise.pair_gram``), exactly (integer
counts, tolerance 0), including the strided ``m[:, :bucket, :]`` view of
a pool the executor hands the engine.  They cover the kernel's launch
schedule (``gram_schedule``: upper tiles x (slice, word chunk) units
walked by persistent blocks) unit by unit, and hold a numpy model of
the kernel — each unit staged in its ring stage under the 128-byte
swizzle and read back as the wgmma descriptors address it, two
warpgroups' row halves against the tile's columns (m64n128, or m64n64 on
a diagonal tile's lower half and a ragged edge), per-block partial Grams
added at each tile and, across 64-row bands, at its mirror — against
the JAX Gram.  The same for gather_count2's row
segments (``gather2_segments``), whose numpy model is held against the
Pallas kernel in interpret mode.  The constants the wrappers share with
the CUDA sources are pinned to those sources.
"""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pilosa_tpu.engine import JaxEngine
from pilosa_tpu.ops import bitwise as jbw
from pilosa_tpu.ops import pallas_kernels as pk
from pilosa_tpu_torch.engine import TorchEngine
from pilosa_tpu_torch.ops import bitwise, dispatch, kernels

OPS = ("and", "or", "xor", "andnot")
CSRC = os.path.join(os.path.dirname(__file__), "..", "pilosa_tpu_torch", "csrc")


def _words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(a):
    return bitwise.to_words(a)


def _jax_gram(rm):
    return np.asarray(jbw.pair_gram(jnp.asarray(np.ascontiguousarray(rm))))


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors never reach a kernel: the launch counters stay put."""
    kernels.reset_launches()
    yield
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


# ---------------------------------------------------------------------------
# pair_gram on the CPU: the plain version, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("r", [1, 3, 17, 64])
def test_pair_gram_matches_jax(r, s):
    rng = np.random.default_rng([r, s])
    rm = _words(rng, (s, r, 8))
    got = kernels.pair_gram(_t(rm))
    assert got.dtype == torch.int64 and tuple(got.shape) == (r, r)
    np.testing.assert_array_equal(got.numpy(), _jax_gram(rm))
    assert kernels.LAUNCHES["pair_gram"] == 0


@pytest.mark.parametrize("bucket", [1, 3, 17, 64])
def test_pair_gram_of_a_strided_pool_view_matches_jax(bucket):
    """The executor's ``matrix[:, :bucket, :]`` of a pool with spare rows:
    a view whose slice stride is the pool's, not the bucket's."""
    rng = np.random.default_rng(bucket + 40)
    pool = _words(rng, (3, 80, 12))
    view = _t(pool)[:, :bucket, :]
    assert not view.is_contiguous() or bucket == 80
    np.testing.assert_array_equal(kernels.pair_gram(view).numpy(), _jax_gram(pool[:, :bucket]))
    np.testing.assert_array_equal(TorchEngine("cpu").pair_gram(view), _jax_gram(pool[:, :bucket]))


def test_pair_gram_checks_its_input():
    with pytest.raises(TypeError, match="int32"):
        kernels.pair_gram(torch.zeros((1, 2, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="S, R, W"):
        kernels.pair_gram(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="2047"):
        kernels.pair_gram(torch.zeros((kernels.GRAM_SLICES_MAX + 1, 2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="device meta"):
        kernels.pair_gram(torch.empty((2, 4, 8), dtype=torch.int32, device="meta"))
    # The engine reaches the wrapper (and so the kernel on the card).
    with pytest.raises(ValueError, match="device meta"):
        TorchEngine("cpu").pair_gram(torch.empty((2, 4, 8), dtype=torch.int32, device="meta"))
    assert dispatch._GRAM_SLICES_MAX == kernels.GRAM_SLICES_MAX == 2047


@pytest.mark.parametrize("view", [False, True])
def test_engine_pair_gram_is_contiguous_int64_equal_to_jax_engine(view):
    rng = np.random.default_rng(int(view) + 50)
    host = _words(rng, (3, 24, 64))
    te, je = TorchEngine("cpu"), JaxEngine()
    m = te.matrix(host)
    if view:
        m, host = m[:, :16, :], host[:, :16]
    got = te.pair_gram(m)
    assert isinstance(got, np.ndarray) and got.dtype == np.int64
    assert got.flags["C_CONTIGUOUS"] and got.shape == (host.shape[1],) * 2
    np.testing.assert_array_equal(got, np.asarray(je.pair_gram(je.matrix(np.ascontiguousarray(host)))))


# ---------------------------------------------------------------------------
# The Gram kernel's schedule (pure Python: what the launch hands the kernel)
# ---------------------------------------------------------------------------

SCHEDULES = [  # (R, S, W, SMs)
    (1, 1, 4, 132), (17, 3, 100, 132), (128, 2, 64, 4), (129, 2, 130, 7),
    (256, 64, 32768, 132), (300, 5, 1000, 132), (1024, 16, 32768, 132), (4096, 4, 256, 132),
]


@pytest.mark.parametrize("r,s,w,sms", SCHEDULES)
def test_gram_schedule_covers_each_upper_tile_and_k_tile_once(r, s, w, sms):
    sched = kernels.gram_schedule(r, s, w, sms)
    n_t = -(-r // kernels.GRAM_TILE)
    n_chunks = -(-w // kernels.GRAM_CHUNK_WORDS)
    assert (sched["n_t"], sched["n_chunks"]) == (n_t, n_chunks)
    pairs = kernels.gram_tile_pairs(n_t)
    assert len(pairs) == n_t * (n_t + 1) // 2
    assert all(i <= j for i, j in pairs) and len(set(pairs)) == len(pairs)
    jobs = kernels.gram_jobs(n_t)
    # Two tiles make one 256-row job; otherwise a job is a tile pair.
    assert jobs == ([(0, 1)] if n_t == 2 else pairs) and sched["n_jobs"] == len(jobs)
    n_k = s * n_chunks
    assert sched["n_units"] == len(jobs) * n_k
    assert sched["n_blocks"] == min(kernels.GRAM_BLOCKS_PER_SM * sms, sched["n_units"])
    runs = [kernels.gram_block_units(sched, g) for g in range(sched["n_blocks"])]
    assert all(len(run) >= 1 for run in runs)
    if len(jobs) == 1:
        # One job: the blocks interleave.
        assert [run.start for run in runs] == list(range(sched["n_blocks"]))
        assert {run.step for run in runs} == {sched["n_blocks"]}
    else:
        # Contiguous, covering, balanced runs.
        assert runs[0].start == 0 and runs[-1].stop == sched["n_units"]
        assert all(a.stop == b.start for a, b in zip(runs, runs[1:]))
        sizes = [len(run) for run in runs]
        assert max(sizes) - min(sizes) <= 1
    if sched["n_units"] > 40000:  # the tall shapes: the runs alone
        return
    seen = Counter(kernels.gram_unit(sched, u) for run in runs for u in run)
    want = {(i, j, sl, c) for i, j in jobs for sl in range(s) for c in range(n_chunks)}
    assert set(seen) == want and set(seen.values()) == {1}


def _tile(rm, s, t, c):
    """Rows [t*T, (t+1)*T) of slice s, word chunk c, zero past R and W."""
    _, r, w = rm.shape
    size, cw = kernels.GRAM_TILE, kernels.GRAM_CHUNK_WORDS
    out = np.zeros((size, cw), dtype=np.uint32)
    blk = rm[s, t * size:(t + 1) * size, c * cw:(c + 1) * cw]
    out[: blk.shape[0], : blk.shape[1]] = blk
    return out


# Each staged row's 16-byte chunk v lies at chunk v ^ (row % 8): the
# 128-byte swizzle a TMA load writes and the wgmma descriptors read.
def _swz(n_rows):
    return (np.arange(8)[None, :] ^ (np.arange(n_rows)[:, None] % 8))[:, :, None]


def _swizzle(tile):
    out = np.empty_like(tile).reshape(tile.shape[0], 8, 4)
    np.put_along_axis(out, _swz(tile.shape[0]), tile.reshape(tile.shape[0], 8, 4), axis=1)
    return out.reshape(tile.shape)


def _unswizzle(staged):
    return np.take_along_axis(staged.reshape(staged.shape[0], 8, 4), _swz(staged.shape[0]),
                              axis=1).reshape(staged.shape)


def _bands(n_t, ti, tj, wg, r):
    """The products a consumer warpgroup runs on job (ti, tj): (A's first
    stage row, B's first stage row, columns) each, stage rows 0..127 the
    A tile and 128..255 the B tile.  The 256-row job: warpgroup 0 rows
    0..63 x 0..255 and 192..255 x 192..255, warpgroup 1 64..127 x 64..255
    and 128..191 x 128..255.  A tile pair: warpgroup g rows 64g.. against
    B from column col0 (64 for warpgroup 1 on a diagonal tile), 128 columns
    where more than 64 are live rows, else 64; none where its rows all lie
    past R."""
    size = kernels.GRAM_TILE
    if n_t == 2:
        bands = [(0, 0, 256), (192, 192, 64)] if wg == 0 else [(64, 64, 192), (128, 128, 128)]
        return [b for b in bands if b[0] < r]
    col0 = 64 if ti == tj and wg == 1 else 0
    if ti * size + wg * 64 >= r:
        return []
    cols = 128 if min(size, r - tj * size) - col0 > 64 else 64
    return [(wg * 64, (0 if ti == tj else size) + col0, cols)]


def _model_gram(rm, sms):
    """The kernel's arithmetic in numpy: each block walks its units, the
    producer stages unit i's operand tiles (one on a diagonal tile) in
    ring stage i % GRAM_STAGES under the swizzle, and each consumer
    warpgroup runs its bands (``_bands``) on the stage as the wgmma
    descriptors read it.  Where a block's run leaves a job, each band's
    partial sums add at (i, j) and, where i and j lie in different 64-row
    bands, at (j, i)."""
    s, r, w = rm.shape
    sched = kernels.gram_schedule(r, s, w, sms)
    size = kernels.GRAM_TILE
    n_t = sched["n_t"]
    n = n_t * size
    g = np.zeros((n, n), dtype=np.int64)

    def glob(stage_row, ti, tj):
        # A stage row's row of the matrix: A tile rows, then B tile rows
        # (the diagonal stages A alone).
        if stage_row < size:
            return ti * size + stage_row
        return (tj if ti != tj else ti) * size + stage_row - size

    for blk in range(sched["n_blocks"]):
        run = kernels.gram_block_units(sched, blk)
        ring = [None] * kernels.GRAM_STAGES
        acc = {}
        for i, u in enumerate(run):
            ti, tj, sl, c = kernels.gram_unit(sched, u)
            a = _swizzle(_tile(rm, sl, ti, c))
            ring[i % kernels.GRAM_STAGES] = np.concatenate(
                [a, a if ti == tj else _swizzle(_tile(rm, sl, tj, c))])
            stage = _unswizzle(ring[i % kernels.GRAM_STAGES])
            for wg in range(2):
                for a0, b0, cols in _bands(n_t, ti, tj, wg, r):
                    rows, bc = stage[a0:a0 + 64], stage[b0:b0 + cols]
                    acc[wg, a0, b0, cols] = acc.get((wg, a0, b0, cols), 0) + np.bitwise_count(
                        rows[:, None, :] & bc[None, :, :]).sum(axis=2, dtype=np.int64)
            if i + 1 == len(run) or kernels.gram_unit(sched, run[i + 1])[:2] != (ti, tj):
                for (wg, a0, b0, cols), v in acc.items():
                    ri = glob(a0, ti, tj) + np.arange(64)[:, None]
                    cj = glob(b0, ti, tj) + np.arange(cols)[None, :]
                    ri, cj = np.broadcast_arrays(ri, cj)
                    g[ri, cj] += v
                    mirror = ri // 64 != cj // 64
                    g[cj[mirror], ri[mirror]] += v[mirror]
                acc = {}
    return g[:r, :r]


@pytest.mark.parametrize("r,s,w,sms", [(5, 2, 8, 3), (64, 2, 36, 2), (130, 2, 72, 5),
                                      (200, 3, 132, 11), (256, 1, 64, 3), (150, 2, 64, 8),
                                      (300, 2, 64, 2), (400, 1, 40, 3)])
def test_numpy_model_of_the_gram_schedule_matches_jax(r, s, w, sms):
    rng = np.random.default_rng([r, s, w])
    rm = _words(rng, (s, r, w))
    np.testing.assert_array_equal(_model_gram(rm, sms), _jax_gram(rm))


# ---------------------------------------------------------------------------
# gather_count2's row segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,w,sms,want", [
    (16, 64, 32768, 132, (4, 2048)),   # gather-1: four segments, 4,096 blocks
    (4, 64, 32768, 132, (8, 1024)),    # a gather-3 group: narrowed to one block step
    (64, 64, 32768, 132, (1, 8192)),   # two waves already: whole rows
    (256, 64, 32768, 132, (1, 8192)),
    (2, 1, 1024, 132, (1, 256)),       # narrower than one step: one segment
    (16, 64, 32768, 114, (2, 4096)),   # a 114-SM card: 2,048 blocks make two waves
    (4, 64, 32768, 114, (8, 1024)),
    (64, 64, 32768, 66, (1, 8192)),
    (64, 16, 32768, 132, (4, 2048)),
])
def test_gather2_segments_at_the_paths_batches(b, s, w, sms, want):
    assert kernels.gather2_segments(b, s, w, sms) == want


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("b", [1, 3, 16, 64, 256, 600, 5000])
@pytest.mark.parametrize("s,w", [(1, 4), (2, 1024), (7, 4100), (64, 32768)])
def test_gather2_segments_cover_each_vector_once(b, s, w, sms):
    n_seg, seg = kernels.gather2_segments(b, s, w, sms)
    wv = w // 4
    cover = Counter(v for g in range(n_seg) for v in range(g * seg, min((g + 1) * seg, wv)))
    assert set(cover) == set(range(wv)) and set(cover.values()) == {1}
    # Segments double only while the launch is under two waves, and each
    # keeps at least one block step of a row.
    if n_seg > 1:
        assert b * s * (n_seg // 2) < 2 * kernels.GATHER2_BLOCKS_PER_SM * sms
        assert -(-wv // n_seg) >= kernels.GATHER2_STEP_VECS


def _model_gather2(op, rm, pairs, n_seg):
    """gather_count2's blocks in numpy: one partial per (pair, segment,
    slice), pair fastest, added into out[q]."""
    s, r, w = rm.shape
    wv = w // 4
    seg = -(-wv // n_seg)
    out = np.zeros(len(pairs), dtype=np.int64)
    for sl in range(s):
        for g in range(n_seg):
            lo, hi = 4 * g * seg, 4 * min((g + 1) * seg, wv)
            for q, (p0, p1) in enumerate(pairs):
                out[q] += getattr(jbw, f"np_count_{op}")(rm[sl, p0, lo:hi], rm[sl, p1, lo:hi])
    return out


@pytest.mark.parametrize("n_seg", [1, 2, 3, 8])
@pytest.mark.parametrize("op", OPS)
def test_numpy_model_of_the_gather2_segments_matches_pallas(op, n_seg):
    rng = np.random.default_rng([OPS.index(op), n_seg])
    s, r, w, b = 2, 12, 1024, 5
    rm = _words(rng, (s, r, w))
    pairs = rng.integers(0, r, size=(b, 2), dtype=np.int32)
    want = np.asarray(pk.fused_gather_count2(op, jnp.asarray(rm), jnp.asarray(pairs), interpret=True))
    np.testing.assert_array_equal(_model_gather2(op, rm, pairs, n_seg), want)
    np.testing.assert_array_equal(kernels.gather_count2(op, _t(rm), pairs).numpy(), want)


# ---------------------------------------------------------------------------
# Constants shared with the CUDA sources
# ---------------------------------------------------------------------------

def _constexpr(source, name):
    with open(os.path.join(CSRC, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not in {source}"
    return int(m.group(1))


def test_wrapper_constants_match_the_cuda_sources():
    assert kernels.GRAM_TILE == _constexpr("pair_gram.cu", "kTile")
    assert kernels.GRAM_CHUNK_WORDS == _constexpr("pair_gram.cu", "kChunk")
    assert kernels.GRAM_BLOCKS_PER_SM == _constexpr("pair_gram.cu", "kBlocksPerSm")
    assert kernels.GRAM_STAGES == _constexpr("pair_gram.cu", "kStages")
    assert kernels.BUILD_TILE_WORDS == _constexpr("build_planes.cu", "kTileWords")
    assert kernels.BUILD_THREADS == _constexpr("build_planes.cu", "kThreads")
    assert kernels.BUILD_BLOCKS_PER_SM == _constexpr("build_planes.cu", "kBlocksPerSm")
    assert kernels.GATHER2_PARAM_PAIRS == _constexpr("gather_count2.cu", "kParamPairs")
    assert kernels.GATHER2_STEP_VECS == (_constexpr("gather_count2.cu", "kThreads")
                                         * _constexpr("gather_count2.cu", "kVecs"))
    assert kernels.MIXED_PARAM_INTS == _constexpr("gather_count_multi_mixed.cu", "kParamInts")
    assert "pair_gram" in kernels.KERNELS and "build_planes" in kernels.KERNELS
    assert len(kernels.KERNELS) == 14
    assert set(kernels.KERNELS) == set(kernels._ARGTYPES) == set(kernels.LAUNCHES)
