"""Exact width-tiled SGM: bit-parity vs the single-device matcher.

SURVEY.md section 5.7 (chunked scans across chips): the wavefront
boundary-L_r exchange in parallel/exact_sgbm.py must reproduce
ops.sgbm.stereo_sgbm EXACTLY -- every pixel, full post-processing chain
(uniqueness, subpixel, LR check, speckle) -- unlike the overlap-margin mode
whose divergence is budgeted. Runs on the virtual 8-CPU mesh (conftest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import stereo_sgbm
from rt_depth_map.parallel import make_mesh
from rt_depth_map.parallel.exact_sgbm import exact_tiled_stereo_sgbm


def _pair(rng, H, W):
    """Synthetic stereo pair with real (shifted) structure + noise."""
    base = rng.integers(0, 256, (H, W + 24), np.uint8)
    left = base[:, 12 : 12 + W].copy()
    shift = 5
    right = base[:, 12 - shift : 12 - shift + W].copy()
    right = np.clip(
        right.astype(np.int32) + rng.integers(-4, 5, right.shape), 0, 255
    ).astype(np.uint8)
    return jnp.asarray(left), jnp.asarray(right)


@pytest.mark.parametrize("num_paths,n,row_block", [(8, 4, 6), (5, 4, 6)])
def test_exact_tiled_bit_parity(rng, num_paths, n, row_block):
    H, W, D = 48, 80, 16
    left, right = _pair(rng, H, W)
    cfg = MatcherConfig(
        kind="sgm", num_disparities=D, block_size=5, num_paths=num_paths,
        pre_filter_cap=0, backend="xla", p1=200, p2=800,
        uniqueness_ratio=10, disp12_max_diff=1,
        speckle_window_size=50, speckle_range=2,
    )
    ref = np.asarray(stereo_sgbm(left, right, cfg))
    mesh = make_mesh((1, n), devices=jax.devices()[:n])
    got = np.asarray(
        exact_tiled_stereo_sgbm(left, right, cfg, mesh, row_block=row_block)
    )
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_exact_tiled_narrow_tiles(rng):
    """Tile width far below the margin-mode minimum (margin + D + 2): the
    exact exchange has no tile-width floor."""
    H, W, D = 24, 48, 16
    left, right = _pair(rng, H, W)
    # num_paths=4 here keeps the 4-path direction family covered (the
    # 8-path family is covered by test_exact_tiled_bit_parity)
    cfg = MatcherConfig(
        kind="sgm", num_disparities=D, block_size=3, num_paths=4,
        pre_filter_cap=31, backend="xla", p1=72, p2=288,
        uniqueness_ratio=5, disp12_max_diff=-1, speckle_window_size=0,
    )
    ref = np.asarray(stereo_sgbm(left, right, cfg))
    mesh = make_mesh((1, 8), devices=jax.devices()[:8])
    got = np.asarray(
        exact_tiled_stereo_sgbm(left, right, cfg, mesh, row_block=3)
    )  # Wloc = 4 columns per tile
    np.testing.assert_array_equal(got, ref)


def test_exact_tiled_default_row_block(rng):
    """Default row_block selection + degenerate n=1 mesh both reproduce."""
    H, W, D = 32, 64, 16
    left, right = _pair(rng, H, W)
    cfg = MatcherConfig(
        kind="sgm", num_disparities=D, block_size=5, num_paths=4,
        pre_filter_cap=0, backend="xla", p1=120, p2=500,
        uniqueness_ratio=0, disp12_max_diff=-1, speckle_window_size=0,
    )
    ref = np.asarray(stereo_sgbm(left, right, cfg))
    for n in (1, 2):
        mesh = make_mesh((1, n), devices=jax.devices()[:n])
        got = np.asarray(exact_tiled_stereo_sgbm(left, right, cfg, mesh))
        np.testing.assert_array_equal(got, ref)


def test_exact_tiled_pallas_lr_in_shard_map(rng):
    """The flagship-shaped tile (D=128, W1=128) with the LR check and
    speckle filter running INSIDE the shard_map tile program must keep
    bit parity with the single-device matcher."""
    H, W, D = 16, 256, 128
    left, right = _pair(rng, H, W)
    cfg = MatcherConfig(
        kind="sgm", num_disparities=D, block_size=5, num_paths=8,
        pre_filter_cap=63, p1=600, p2=2400,
        uniqueness_ratio=10, disp12_max_diff=1,
        speckle_window_size=50, speckle_range=32,
    )
    ref = np.asarray(stereo_sgbm(left, right, cfg))
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    got = np.asarray(exact_tiled_stereo_sgbm(left, right, cfg, mesh))
    np.testing.assert_array_equal(got, ref)
