"""The GPU SGM kernel at matcher operating points (interpret mode).

Same stereo pairs and matcher parameters as the flagship-shaped CPU cases:
the cost volume is the matcher's own (`sgbm_cost_volume`), streamed to the
kernel in the dtype stereo_sgbm picks, and the kernel's S must equal the
XLA `aggregate_cost` bit for bit -- equal S gives equal disparities.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import (
    _aggregate_dir,
    aggregate_cost,
    sgbm_cost_volume,
    stereo_sgbm,
    stereo_sgbm_batch,
    wta_uniq_subpix,
)
from rt_depth_map.ops.sgm_kernel import (
    aggregate_cost_pallas,
    aggregate_dir_pallas,
)


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


def _kernel_vs_xla(left, right, D, bs, cap, paths, p1=600, p2=2400,
                   dtype=jnp.int16):
    C, _, _ = sgbm_cost_volume(jnp.asarray(left), jnp.asarray(right), D, bs,
                               0, cap)
    ref = aggregate_cost(C, p1, p2, paths)
    got = aggregate_cost_pallas(C.astype(dtype), p1, p2, paths,
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    return got


@pytest.mark.parametrize("paths,H", [(4, 16), (5, 16), (8, 16), (8, 24)])
def test_sgm_kernel_matches_xla(paths, H):
    left, right = stereo_pair(12, H, 192, 9)
    _kernel_vs_xla(left, right, 128, 5, 63, paths)


def test_sgm_kernel_ragged_height_strict():
    """H % 16 != 0 needs no padding: the kernel masks ragged rows, so the
    result is the strict one."""
    left, right = stereo_pair(12, 24, 192, 9)
    _kernel_vs_xla(left, right, 128, 5, 63, 8)


@pytest.mark.parametrize("D,W,H", [
    (48, 112, 16),   # D % 128 != 0 (the reference-default-D class)
    (48, 100, 16),   # W1 = 52: neither D nor W1 a power of two
    (48, 100, 24),   # same, ragged height
])
def test_sgm_kernel_nonmult128_disparities(D, W, H):
    left, right = stereo_pair(21, H, W, 9)
    _kernel_vs_xla(left, right, D, 5, 63, 8)


def test_sgm_kernel_int16_and_int32_volume():
    # block_size=5 fits C in int16 (the matcher streams int16 there);
    # block_size=11 does not and streams int32. Both must match XLA.
    left, right = stereo_pair(13, 16, 192, 5)
    for bs, dtype in ((5, jnp.int16), (11, jnp.int32)):
        _kernel_vs_xla(left, right, 128, bs, 63, 8, p1=8 * bs * bs,
                       p2=32 * bs * bs, dtype=dtype)


@pytest.mark.parametrize("dx", [1, -1])
def test_sgm_kernel_horizontal(dx):
    rng = np.random.default_rng(33)
    C = jnp.asarray(rng.integers(0, 1500, (16, 64, 128)).astype(np.int16))
    ref = _aggregate_dir(C.astype(jnp.int32), 600, 2400, 0, dx)
    got = aggregate_dir_pallas(C, None, 600, 2400, 0, dx, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("dtype", [jnp.int16, jnp.int32])
def test_sgm_kernel_both_horizontal_sweeps(rng, dtype):
    H, D, W1 = 24, 16, 64
    C = jnp.asarray(rng.integers(0, 2300, (H, W1, D)), dtype)
    C32 = C.astype(jnp.int32)
    ref = (_aggregate_dir(C32, 200, 801, 0, 1)
           + _aggregate_dir(C32, 200, 801, 0, -1))
    S = aggregate_dir_pallas(C, None, 200, 801, 0, 1, interpret=True)
    got = aggregate_dir_pallas(C, S, 200, 801, 0, -1, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("dtype", [jnp.int16, jnp.int32])
def test_sgm_kernel_vertical_family_then_wta(rng, dtype):
    """The six vertical/diagonal sweeps accumulated onto a horizontal
    partial, then WTA: every WTA output equals the XLA path's."""
    H, D, W1 = 24, 16, 64
    C = jnp.asarray(rng.integers(0, 2300, (H, W1, D)), dtype)
    Sh = jnp.asarray(rng.integers(0, 4600, (H, W1, D)), jnp.int32)
    C32 = C.astype(jnp.int32)
    vert = [(1, 1), (1, 0), (1, -1), (-1, -1), (-1, 0), (-1, 1)]
    ref, got = Sh, Sh
    for dy, dx in vert:
        ref = ref + _aggregate_dir(C32, 200, 801, dy, dx)
        got = aggregate_dir_pallas(C, got, 200, 801, dy, dx, interpret=True)
    for g, r, name in zip(wta_uniq_subpix(got, 10), wta_uniq_subpix(ref, 10),
                          ("best", "minS", "dval", "uniq")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r),
                                      err_msg=name)


def test_sgm_kernel_taller_than_wide(rng):
    H, D, W1 = 24, 8, 16
    C = jnp.asarray(rng.integers(0, 2300, (H, W1, D)), jnp.int16)
    ref = aggregate_cost(C.astype(jnp.int32), 200, 801, 8)
    got = aggregate_cost_pallas(C, 200, 801, 8, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("B", [2, 3])
def test_batch_bit_identical_to_per_frame(B):
    H, D, W1 = 16, 16, 64
    W = W1 + D
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (B, H, W + 24), dtype=np.uint8)
    lefts = jnp.asarray(base[:, :, 12 : 12 + W])
    rights = jnp.asarray(np.stack(
        [np.roll(base[i], 3 + i, axis=1)[:, 12 : 12 + W] for i in range(B)]))
    cfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                        num_paths=8)
    out_b = np.asarray(stereo_sgbm_batch(lefts, rights, cfg))
    for i in range(B):
        ref = np.asarray(stereo_sgbm(lefts[i], rights[i], cfg))
        np.testing.assert_array_equal(out_b[i], ref, err_msg=f"frame {i}")
