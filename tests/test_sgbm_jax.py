"""JAX SGM matcher vs the golden numpy implementation (bit-exact) and cv2.

The golden itself is held to the bad-pixel budget vs cv2.StereoSGBM in
test_golden_sgbm.py; here the jittable ops/sgbm.py path must reproduce the
golden exactly (all arithmetic is int32).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.golden.sgbm import (
    golden_stereo_sgbm,
    sgbm_cost_volume as golden_cost_volume,
)
from rt_depth_map.ops.sgbm import aggregate_cost, sgbm_cost_volume, stereo_sgbm
from rt_depth_map.golden.sgbm import _aggregate_dir as golden_aggregate_dir


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8)
    # cheap blur so the SAD surface has structure
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


def test_cost_volume_bit_exact():
    left, right = stereo_pair(0, 32, 96, 6)
    Cg, minX1g, w1g = golden_cost_volume(left, right, 16, 5, 0, 0)
    Cj, minX1, w1 = sgbm_cost_volume(jnp.asarray(left), jnp.asarray(right), 16, 5, 0, 0)
    assert (minX1, w1) == (minX1g, w1g)
    np.testing.assert_array_equal(np.asarray(Cj), Cg)


@pytest.mark.parametrize("dy,dx", [(0, 1), (0, -1), (1, 0), (-1, 0),
                                   (1, 1), (1, -1), (-1, 1), (-1, -1)])
def test_aggregate_one_direction_bit_exact(dy, dx):
    left, right = stereo_pair(1, 24, 80, 5)
    Cg, _, _ = golden_cost_volume(left, right, 16, 3, 0, 0)
    Lg = golden_aggregate_dir(Cg, 100, 400, dy, dx)
    from rt_depth_map.ops.sgbm import _aggregate_dir as jax_aggregate_dir

    Lj = jax_aggregate_dir(jnp.asarray(Cg), 100, 400, dy, dx)
    np.testing.assert_array_equal(np.asarray(Lj), Lg)


@pytest.mark.parametrize("paths", [4, 5, 8])
@pytest.mark.parametrize(
    "kw",
    [
        dict(uniqueness_ratio=0, speckle_window_size=0, disp12_max_diff=-1),
        dict(uniqueness_ratio=10, speckle_window_size=0, disp12_max_diff=-1),
        dict(uniqueness_ratio=10, speckle_window_size=100, speckle_range=32,
             disp12_max_diff=1),
    ],
)
def test_sgbm_jax_matches_golden(paths, kw):
    left, right = stereo_pair(2, 40, 112, 7)
    mode = {4: "sgbm4", 5: "sgbm", 8: "hh"}[paths]
    golden = golden_stereo_sgbm(left, right, 32, 5, mode=mode, **kw)
    cfg = MatcherConfig(
        kind="sgm", num_disparities=32, block_size=5, num_paths=paths,
        pre_filter_cap=0,
        uniqueness_ratio=kw.get("uniqueness_ratio", 10),
        speckle_window_size=kw.get("speckle_window_size", 0),
        speckle_range=kw.get("speckle_range", 32),
        disp12_max_diff=kw.get("disp12_max_diff", -1),
    )
    mine = np.asarray(stereo_sgbm(jnp.asarray(left), jnp.asarray(right), cfg))
    mismatch = (mine != golden).mean()
    np.testing.assert_array_equal(mine, golden, err_msg=f"mismatch={mismatch}")


def test_sgbm_jax_vs_cv2_budget():
    cv2 = pytest.importorskip("cv2")
    left, right = stereo_pair(5, 48, 128, 8)
    m = cv2.StereoSGBM_create(0, 32, 5)
    m.setP1(600)
    m.setP2(2400)
    m.setUniquenessRatio(10)
    m.setSpeckleWindowSize(100)
    m.setSpeckleRange(32)
    m.setDisp12MaxDiff(1)
    m.setPreFilterCap(0)
    ref = m.compute(left, right)
    cfg = MatcherConfig(kind="sgm", num_disparities=32, block_size=5,
                        num_paths=5, pre_filter_cap=0)
    mine = np.asarray(stereo_sgbm(jnp.asarray(left), jnp.asarray(right), cfg))
    INVALID = -16
    both = (ref != INVALID) & (mine != INVALID)
    bad = (np.abs(ref.astype(int) - mine.astype(int)) > 16) & both
    assert bad.sum() / max(both.sum(), 1) < 0.01
    assert ((ref != INVALID) != (mine != INVALID)).mean() < 0.02


def test_sgbm_jax_known_shift():
    left, right = stereo_pair(3, 48, 160, 12)
    cfg = MatcherConfig(kind="sgm", num_disparities=32, block_size=5,
                        num_paths=8, pre_filter_cap=0,
                        speckle_window_size=0, disp12_max_diff=1)
    mine = np.asarray(stereo_sgbm(jnp.asarray(left), jnp.asarray(right), cfg))
    valid = mine != -16
    assert valid.mean() > 0.5
    assert np.abs(mine[valid] / 16.0 - 12.0).mean() < 0.25
