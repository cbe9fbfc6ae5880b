"""WLS disparity post-filter (the reference's ENABLE_POST_FILTER feature).

Re-creates the compile-gated confidence-aware disparity refinement of
estimator.cpp:59-71: a right-view matcher (createRightMatcher semantics), a
left-right confidence map, and edge-preserving weighted-least-squares
smoothing of the disparity guided by the left image, with the reference's
lambda=8000, sigma_color=1.5 (estimator.cpp:63-64).

The smoother is the Fast Global Smoother of cv2.ximgproc's
DisparityWLSFilter (Min et al., "Fast Global Image Smoothing Based on
Spectral Decomposition", TIP 2014): T=3 sweeps of separable 1-D weighted
least squares, each a tridiagonal solve with per-sweep lambda
  lambda_t = 1.5 * lambda * 4^(T-t) / (4^T - 1)
and neighbor weights w(p,q) = exp(-|I_p - I_q| / sigma_color) on the guide.
The tridiagonal (Thomas) solves are lax.scans along rows/columns, batched
over the perpendicular axis. cv2.ximgproc is not installable here, so parity
is algorithm-level (same paper, same parameters), validated by behavioral
tests (edge-aware smoothing, confidence gating, invalid filling).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig

DISP_SCALE = 16


def right_matcher_config(cfg: MatcherConfig) -> MatcherConfig:
    """cv2.ximgproc.createRightMatcher parity: same search range mirrored,
    so the right view's disparities are negative and the left-right check in
    the confidence map can subtract them directly."""
    return cfg.replace(
        min_disparity=-(cfg.min_disparity + cfg.num_disparities) + 1,
        # the right matcher never needs its own postprocessing
        speckle_window_size=0,
        disp12_max_diff=-1,
    )


def lr_confidence(
    disp_left: jnp.ndarray,
    disp_right: jnp.ndarray,
    lrc_thresh: int = 24,
    invalid_left: int | None = None,
    invalid_right: int | None = None,
) -> jnp.ndarray:
    """(H, W) float32 confidence in [0, 1]: 1 where the right view agrees
    within lrc_thresh (x16 units; cv2 default 24 = 1.5 px), 0 elsewhere or
    where either view is invalid.

    invalid_left/right: the matcher's invalid markers ((min_disparity-1)*16);
    pixels holding them get zero confidence. When omitted, only sentinel
    int16-min values are treated as invalid."""
    H, W = disp_left.shape
    dl = disp_left.astype(jnp.int32)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    x2 = xs - ((dl + DISP_SCALE // 2) >> 4)
    ok = (x2 >= 0) & (x2 < W)
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    lin = rows * W + jnp.clip(x2, 0, W - 1)
    dr_at = disp_right.astype(jnp.int32).reshape(-1)[lin.reshape(-1)].reshape(H, W)
    # right-view disparities are negative (mirrored range): consistent when
    # dl + dr ~ 0
    consistent = jnp.abs(dl + dr_at) <= lrc_thresh
    valid = (dl > jnp.iinfo(jnp.int16).min) & ok
    if invalid_left is not None:
        valid = valid & (dl != invalid_left)
    if invalid_right is not None:
        valid = valid & (dr_at != invalid_right)
    return (consistent & valid).astype(jnp.float32)


def _tridiag_smooth_rows(x, w_conf, guide, lam, sigma_color):
    """One horizontal WLS sweep: for each row solve
    (W_conf + lam * L) u = W_conf * x, L the 1-D weighted Laplacian with
    weights from the guide. Thomas algorithm as two lax.scans over columns,
    batched over rows."""
    H, W = x.shape
    g = guide.astype(jnp.float32)
    diff = jnp.abs(g[:, 1:] - g[:, :-1])
    wgt = jnp.exp(-diff / sigma_color)  # (H, W-1) neighbor weights

    # tridiagonal coefficients per column j:
    #   a_j = -lam * w_{j-1,j}, c_j = -lam * w_{j,j+1},
    #   b_j = w_conf_j + lam * (w_{j-1,j} + w_{j,j+1})
    zero = jnp.zeros((H, 1), jnp.float32)
    wl = jnp.concatenate([zero, wgt], axis=1)  # weight to left neighbor
    wr = jnp.concatenate([wgt, zero], axis=1)  # weight to right neighbor
    a = -lam * wl
    c = -lam * wr
    b = w_conf + lam * (wl + wr)
    d = w_conf * x

    # forward elimination scanning columns
    def fwd(carry, cols):
        cp_prev, dp_prev = carry
        aj, bj, cj, dj = cols
        denom = bj - aj * cp_prev
        denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        cp = cj / denom
        dp = (dj - aj * dp_prev) / denom
        return (cp, dp), (cp, dp)

    cols = (a.T, b.T, c.T, d.T)  # scan over W, batched over H
    (_, _), (cps, dps) = jax.lax.scan(
        fwd, (jnp.zeros(H), jnp.zeros(H)), cols
    )

    def back(u_next, cols):
        cp, dp = cols
        u = dp - cp * u_next
        return u, u

    _, us = jax.lax.scan(back, jnp.zeros(H), (cps, dps), reverse=True)
    return us.T


def fast_global_smoother(
    x: jnp.ndarray,
    guide: jnp.ndarray,
    confidence: jnp.ndarray,
    lam: float = 8000.0,
    sigma_color: float = 1.5,
    num_iter: int = 3,
) -> jnp.ndarray:
    """FGS smoothing of x (float32) guided by `guide` (uint8 gray), weighted
    by per-pixel confidence."""
    u = x.astype(jnp.float32)
    # Confidence floor 1e-2 (not smaller): with lambda ~3e3 the tridiagonal
    # system over a zero-confidence run is near-singular and float32 Thomas
    # elimination cancels catastrophically below ~1e-6 relative diagonal
    # perturbation. The residual pull toward the data is lambda/floor ~ 3e5x
    # weaker than smoothing -- negligible bias.
    conf = jnp.maximum(confidence.astype(jnp.float32), 1e-2)
    denom = 4.0 ** num_iter - 1.0
    for t in range(1, num_iter + 1):
        lam_t = 1.5 * lam * (4.0 ** (num_iter - t)) / denom
        u = _tridiag_smooth_rows(u, conf, guide, lam_t, sigma_color)
        u = _tridiag_smooth_rows(u.T, conf.T, guide.T, lam_t, sigma_color).T
    return u


def wls_filter(
    disp_left: jnp.ndarray,
    disp_right: jnp.ndarray,
    guide_gray: jnp.ndarray,
    cfg: MatcherConfig,
    lam: float = 8000.0,
    sigma_color: float = 1.5,
    lrc_thresh: int = 24,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Confidence-weighted WLS refinement of the left disparity
    (DisparityWLSFilter.filter parity at the reference's parameter point).

    disp_left/right: int16 x16 maps (right from the mirrored matcher).
    guide_gray: (H, W) uint8 rectified left image.
    Returns (filtered_disp int16 x16, confidence float32 in [0,1])."""
    INVALID = (cfg.min_disparity - 1) * DISP_SCALE
    # right matcher runs the mirrored range (see right_matcher_config)
    INVALID_R = (-(cfg.min_disparity + cfg.num_disparities)) * DISP_SCALE
    conf = lr_confidence(
        disp_left, disp_right, lrc_thresh,
        invalid_left=INVALID, invalid_right=INVALID_R,
    )
    valid = disp_left != INVALID
    w = conf * valid.astype(jnp.float32)
    # prefill zero-confidence pixels with the confident mean so the floored
    # data term pulls toward a plausible value instead of zero
    vsum = jnp.sum(jnp.where(valid, disp_left.astype(jnp.float32), 0.0))
    vmean = vsum / jnp.maximum(jnp.sum(valid), 1)
    x = jnp.where(valid, disp_left.astype(jnp.float32), vmean)
    u = fast_global_smoother(x, guide_gray, w, lam, sigma_color)
    out = jnp.clip(jnp.round(u), -32768, 32767).astype(jnp.int16)
    return out, conf
