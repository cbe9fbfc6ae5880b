"""WLS post-filter behavioral tests (ENABLE_POST_FILTER feature).

cv2.ximgproc is not available as an oracle, so assertions are on the defining
properties of the algorithm: confidence gating by left-right consistency,
edge-aware smoothing (noise suppressed, guide edges preserved), and invalid
region fill from confident neighbors.
"""

import numpy as np
import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.bm import stereo_bm
from rt_depth_map.ops.wls import (
    fast_global_smoother,
    lr_confidence,
    right_matcher_config,
    wls_filter,
)


def test_right_matcher_config_mirrors_range():
    cfg = MatcherConfig(num_disparities=32, min_disparity=0)
    rc = right_matcher_config(cfg)
    assert rc.min_disparity == -31
    assert rc.num_disparities == 32


def test_right_matcher_produces_negative_disparities():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (48, 128 + 16), dtype=np.uint8).astype(float)
    k = np.ones(5) / 5
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = base.astype(np.uint8)
    left, right = base[:, :128], base[:, 8 : 136]
    cfg = MatcherConfig(num_disparities=32, block_size=9,
                        speckle_window_size=0, disp12_max_diff=-1)
    dr = np.asarray(
        stereo_bm(jnp.asarray(right), jnp.asarray(left), right_matcher_config(cfg))
    )
    valid = dr != (right_matcher_config(cfg).min_disparity - 1) * 16
    assert valid.mean() > 0.3
    med = np.median(dr[valid]) / 16.0
    assert abs(med + 8.0) < 1.0  # right-view disparity ~ -8


def test_lr_confidence_gates_consistency():
    H, W = 8, 64
    dl = np.full((H, W), 8 * 16, np.int16)
    dr = np.full((H, W), -8 * 16, np.int16)  # perfectly consistent
    conf = np.asarray(lr_confidence(jnp.asarray(dl), jnp.asarray(dr)))
    assert (conf[:, 8:] == 1.0).all()  # x - d >= 0 region
    dr_bad = np.full((H, W), -20 * 16, np.int16)
    conf2 = np.asarray(lr_confidence(jnp.asarray(dl), jnp.asarray(dr_bad)))
    assert (conf2 == 0.0).all()


def test_fgs_smooths_noise_but_keeps_guide_edges():
    rng = np.random.default_rng(1)
    H, W = 48, 64
    guide = np.zeros((H, W), np.uint8)
    guide[:, W // 2 :] = 200  # hard edge in the guide
    x = np.where(np.arange(W)[None, :] < W // 2, 10.0, 30.0)
    x = np.broadcast_to(x, (H, W)).copy()
    noisy = x + rng.normal(0, 2.0, (H, W))
    conf = np.ones((H, W), np.float32)
    out = np.asarray(
        fast_global_smoother(jnp.asarray(noisy, jnp.float32),
                             jnp.asarray(guide), jnp.asarray(conf))
    )
    # noise within each flat region is reduced
    assert out[:, 5 : W // 2 - 5].std() < noisy[:, 5 : W // 2 - 5].std() * 0.5
    # the disparity step across the guide edge survives
    assert out[:, W // 2 + 3 :].mean() - out[:, : W // 2 - 3].mean() > 15.0


def test_wls_fills_invalid_from_confident_neighbors():
    H, W = 32, 64
    dl = np.full((H, W), 12 * 16, np.int16)
    dl[10:20, 20:40] = -16  # invalid hole
    dr = np.full((H, W), -12 * 16, np.int16)
    guide = np.full((H, W), 128, np.uint8)
    cfg = MatcherConfig(num_disparities=32)
    out, conf = wls_filter(jnp.asarray(dl), jnp.asarray(dr),
                           jnp.asarray(guide), cfg)
    out = np.asarray(out)
    # the hole is filled toward the surrounding disparity
    assert abs(out[15, 30] / 16.0 - 12.0) < 2.0


def test_tridiag_sweep_matches_dense_solve(rng):
    """Numeric oracle for the Thomas-algorithm sweep: solve the same
    (W_conf + lam*L) u = W_conf x system densely with numpy per row
    (independent construction of the weighted 1-D Laplacian)."""
    from rt_depth_map.ops.wls import _tridiag_smooth_rows

    H, W = 6, 40
    lam, sigma = 37.5, 1.5
    x = rng.normal(size=(H, W)).astype(np.float32) * 10
    conf = rng.uniform(0.01, 1.0, size=(H, W)).astype(np.float32)
    guide = rng.integers(0, 256, (H, W)).astype(np.uint8)

    got = np.asarray(
        _tridiag_smooth_rows(
            jnp.asarray(x), jnp.asarray(conf), jnp.asarray(guide), lam, sigma
        )
    )

    g = guide.astype(np.float64)
    wgt = np.exp(-np.abs(g[:, 1:] - g[:, :-1]) / sigma)
    for y in range(H):
        A = np.zeros((W, W))
        for j in range(W):
            A[j, j] = conf[y, j]
            if j > 0:
                A[j, j] += lam * wgt[y, j - 1]
                A[j, j - 1] = -lam * wgt[y, j - 1]
            if j < W - 1:
                A[j, j] += lam * wgt[y, j]
                A[j, j + 1] = -lam * wgt[y, j]
        u = np.linalg.solve(A, conf[y] * x[y])
        np.testing.assert_allclose(got[y], u, rtol=2e-3, atol=2e-3)
