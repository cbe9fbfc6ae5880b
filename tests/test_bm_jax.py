"""JAX stereo_bm vs the golden numpy implementation: exact equality.

(golden is itself bit-exact vs cv2.StereoBM -- see test_golden_bm.py.)
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.golden import golden_stereo_bm
from rt_depth_map.ops.bm import stereo_bm
from rt_depth_map.ops.speckle import filter_speckles
from rt_depth_map.golden.postproc import golden_filter_speckles


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8)
    # cheap smoothing for realistic texture
    k = np.ones(3) / 3
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


REF = dict(
    texture_threshold=10,
    uniqueness_ratio=10,
    speckle_window_size=100,
    speckle_range=32,
    disp12_max_diff=1,
)


@pytest.mark.parametrize(
    "kw",
    [
        dict(texture_threshold=0, uniqueness_ratio=0, speckle_window_size=0,
             disp12_max_diff=-1),
        dict(**REF),
        dict(min_disparity=3, **REF),
    ],
)
def test_stereo_bm_matches_golden(kw):
    left, right = stereo_pair(0, 48, 128, 8)
    ndisp, bs = 32, 9
    ref = golden_stereo_bm(left, right, ndisp, bs,
                           pre_filter_cap=31, **kw)
    cfg = MatcherConfig(
        kind="bm", num_disparities=ndisp, block_size=bs, pre_filter_cap=31,
        min_disparity=kw.get("min_disparity", 0),
        texture_threshold=kw.get("texture_threshold", 10),
        uniqueness_ratio=kw.get("uniqueness_ratio", 10),
        speckle_window_size=kw.get("speckle_window_size", 100),
        speckle_range=kw.get("speckle_range", 32),
        disp12_max_diff=kw.get("disp12_max_diff", 1),
    )
    fn = jax.jit(lambda l, r: stereo_bm(l, r, cfg))
    mine = np.asarray(fn(jnp.asarray(left), jnp.asarray(right)))
    np.testing.assert_array_equal(mine, ref)


def test_stereo_bm_dynamic_roi_matches_golden():
    left, right = stereo_pair(3, 48, 128, 8)
    ndisp, bs = 32, 9
    cfg = MatcherConfig(kind="bm", num_disparities=ndisp, block_size=bs)
    fn = jax.jit(
        lambda l, r, roi: stereo_bm(l, r, cfg, roi1=tuple(roi))
    )
    for roi in [(40, 6, 60, 30), (0, 0, 0, 0)]:  # incl. empty -> full frame
        ref = golden_stereo_bm(
            left, right, ndisp, bs, roi1=roi,
            texture_threshold=cfg.texture_threshold,
            uniqueness_ratio=cfg.uniqueness_ratio,
            speckle_window_size=cfg.speckle_window_size,
            speckle_range=cfg.speckle_range,
            disp12_max_diff=cfg.disp12_max_diff,
        )
        mine = np.asarray(
            fn(jnp.asarray(left), jnp.asarray(right), jnp.asarray(roi))
        )
        np.testing.assert_array_equal(mine, ref)


def test_filter_speckles_matches_golden(rng):
    d = rng.integers(-1, 20, size=(40, 60)).astype(np.int16) * 16
    d[d < 0] = -16
    ref = golden_filter_speckles(d, -16, 30, 2 * 16)
    mine = np.asarray(filter_speckles(jnp.asarray(d), -16, 30, 2 * 16))
    np.testing.assert_array_equal(mine, ref)


def test_filter_speckles_large_component_survives(rng):
    d = np.full((32, 48), 5 * 16, dtype=np.int16)  # one giant component
    out = np.asarray(filter_speckles(jnp.asarray(d), -16, 100, 32))
    np.testing.assert_array_equal(out, d)


def test_stereo_bm_batched_vmap():
    left0, right0 = stereo_pair(1, 32, 96, 5)
    left1, right1 = stereo_pair(2, 32, 96, 9)
    cfg = MatcherConfig(kind="bm", num_disparities=16, block_size=5,
                        speckle_window_size=0, disp12_max_diff=-1)
    fn = jax.jit(jax.vmap(lambda l, r: stereo_bm(l, r, cfg)))
    out = np.asarray(
        fn(jnp.stack([left0, left1]), jnp.stack([right0, right1]))
    )
    for i, (l, r) in enumerate([(left0, right0), (left1, right1)]):
        ref = golden_stereo_bm(
            l, r, 16, 5, speckle_window_size=0, disp12_max_diff=-1,
            texture_threshold=10, uniqueness_ratio=10,
        )
        np.testing.assert_array_equal(out[i], ref)
