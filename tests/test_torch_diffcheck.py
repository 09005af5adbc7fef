"""The port's differential sweep (``pilosa_tpu_torch/ops/diffcheck.py``)
on the CPU: every lane's plain PyTorch version against its numpy ground
truth, exactly, over seeded random cases (the card runs the same sweep
through the kernels in ``chip_smoke.py``).  Its lanes are the JAX
sweep's less the two that check the TPU's (8, 128)-tiled matrix form,
plus the staged tree and multi-fold kernels'.
"""

import pytest

from pilosa_tpu.ops import diffcheck as jdiffcheck
from pilosa_tpu_torch.ops import diffcheck


@pytest.mark.parametrize("seed", [11, 12])
def test_every_lane_matches_numpy(seed):
    failures = diffcheck.run_lanes(seed, 12, device="cpu")
    assert failures == [], failures[:10]


def test_lanes_are_the_jax_sweeps_less_the_tiled_ones():
    tiled = {n for n in jdiffcheck.lane_names() if n.startswith(("count2_tiled:", "dispatch4:"))}
    assert len(tiled) == 8
    assert diffcheck.tree_lane_names() == {f"resident_tree:k{k}" for k in (2, 4, 8, 16)}
    assert diffcheck.resident_multi_lane_names() == {
        f"{p}resident_multi:{op}" for op in ("and", "or", "andnot") for p in ("", "rm")}
    own = diffcheck.tree_lane_names() | diffcheck.resident_multi_lane_names()
    assert diffcheck.lane_names() - own == jdiffcheck.lane_names() - tiled
    assert (diffcheck.SHAPES, diffcheck.B, diffcheck.KS) == (jdiffcheck.SHAPES, jdiffcheck.B, jdiffcheck.KS)
