"""Semi-global matching as a jittable JAX program (cv::StereoSGBM parity).

Bit-exact vs the golden numpy implementation (golden/sgbm.py), which pins the
SWSemiGlobalMatcher semantics of the reference (sgbm-sw.cpp:12-25,
SURVEY.md section 2.9b): Birchfield-Tomasi pixel cost on the clipped x-Sobel
response plus quarter-weighted raw BT, replicated block window sums, SGM path
aggregation over 4 (MODE_SGBM) or 8 (MODE_HH) directions, WTA with smallest-d
tie-break, SGBM uniqueness test, parabolic subpixel, inline cost-based
left-right check, speckle filter.

Formulation notes (SURVEY.md section 7 step 6):
  * The cost volume is laid out (H, W1, D) with D minor; all arithmetic is
    int32.
  * Each SGM direction is one `lax.scan` whose carry is the previous
    scanline's L_r -- (H, D) for horizontal scans over W1 steps, (W1, D) for
    vertical/diagonal scans over H steps. This is the reference formulation
    on every platform; on a GPU the same recurrences run as one Pallas
    kernel per direction (ops/sgm_kernel.py), bit-exact with it.
  * Diagonal directions shift the carry by +/-1 column with zero fill each
    step, which reproduces OpenCV's zero border initialization exactly
    (zero rows have min 0, so delta = P2 and m = 0 at borders).
  * The left-right consistency check packs (cost, d) keys and resolves the
    per-right-pixel winner with shift-reduces over the candidate disparities
    (no scatter/gather) while reproducing the sequential "first
    strictly-lower-cost wins" update order.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.speckle import filter_speckles


DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
MAX_COST = 32767  # python int: jnp scalars at module scope become lifted consts (jit fast-path bug)


def _clip_tab(v: jnp.ndarray, ftzero: int) -> jnp.ndarray:
    return jnp.clip(v, -ftzero, ftzero) + ftzero


def sgbm_preprocess(img: jnp.ndarray, ftzero: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(sobel-clipped, raw) planes; golden/sgbm.py `sgbm_preprocess` parity."""
    x = img.astype(jnp.int32)
    up = jnp.concatenate([x[:1], x[:-1]], axis=0)
    down = jnp.concatenate([x[1:], x[-1:]], axis=0)

    def dx(row):
        left = jnp.concatenate([row[:, :1], row[:, :-1]], axis=1)
        right = jnp.concatenate([row[:, 1:], row[:, -1:]], axis=1)
        return right - left

    sob = _clip_tab(2 * dx(x) + dx(up) + dx(down), ftzero)
    sob = sob.at[:, 0].set(0).at[:, -1].set(0)
    raw = x.at[:, 0].set(0).at[:, -1].set(0)
    return sob, raw


def _halfpix(p: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    left = jnp.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = jnp.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    al = (p + left) // 2
    ar = (p + right) // 2
    al = al.at[:, 0].set(p[:, 0])
    ar = ar.at[:, -1].set(p[:, -1])
    mn = jnp.minimum(p, jnp.minimum(al, ar))
    mx = jnp.maximum(p, jnp.maximum(al, ar))
    return mn, mx


def _bt_cost_plane(pl: jnp.ndarray, pr: jnp.ndarray, min_disp: int,
                   num_disp: int) -> jnp.ndarray:
    """Sampling-insensitive BT cost, (H, W, D) int32 (golden `_bt_cost_plane`).

    fori_loop over d with dynamic slices of the once-padded right-image
    planes (the D-unrolled plane stack made XLA compiles take minutes)."""
    H, W = pl.shape
    u0, u1 = _halfpix(pl)
    v0, v1 = _halfpix(pr)
    M = num_disp + abs(min_disp) + 1
    padc = ((0, 0), (M, M))
    pr_pad = jnp.pad(pr, padc)
    v0_pad = jnp.pad(v0, padc)
    v1_pad = jnp.pad(v1, padc)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

    def body(i, vol):
        dd = min_disp + i
        # right-image planes sampled at x - dd (zero outside the image)
        start = (0, M - dd)
        v = jax.lax.dynamic_slice(pr_pad, start, (H, W))
        vv0 = jax.lax.dynamic_slice(v0_pad, start, (H, W))
        vv1 = jax.lax.dynamic_slice(v1_pad, start, (H, W))
        c0 = jnp.maximum(0, jnp.maximum(pl - vv1, vv0 - pl))
        c1 = jnp.maximum(0, jnp.maximum(v - u1, u0 - v))
        inb = (xs - dd >= 0) & (xs - dd < W)
        c = jnp.where(inb, jnp.minimum(c0, c1), 0)
        return jax.lax.dynamic_update_slice(vol, c[..., None], (0, 0, i))

    return jax.lax.fori_loop(
        0, num_disp, body, jnp.zeros((H, W, num_disp), jnp.int32)
    )


def sgbm_cost_volume(
    left: jnp.ndarray,
    right: jnp.ndarray,
    num_disp: int,
    block_size: int,
    min_disp: int = 0,
    pre_filter_cap: int = 0,
) -> Tuple[jnp.ndarray, int, int]:
    """Windowed BT cost C: (H, width1, D) int32; golden `sgbm_cost_volume`."""
    ftzero = max(pre_filter_cap, 15) | 1
    H, W = left.shape
    minX1 = max(min_disp + num_disp, 0)
    maxX1 = W + min(min_disp, 0)
    width1 = maxX1 - minX1

    ls, lr = sgbm_preprocess(left, ftzero)
    rs, rr = sgbm_preprocess(right, ftzero)
    pix = _bt_cost_plane(ls, rs, min_disp, num_disp) + (
        _bt_cost_plane(lr, rr, min_disp, num_disp) >> 2
    )
    pix = pix[:, minX1:maxX1]  # (H, W1, D)

    sw2 = block_size // 2
    acc = _sliding_sum_replicate(pix, block_size, axis=1)
    out = _sliding_sum_replicate(acc, block_size, axis=0)
    del sw2
    return out, minX1, width1


def _sliding_sum_replicate(x: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """out[i] = sum_{o=-w2..w2} x[clamp(i+o, 0, N-1)] along `axis` --
    replicate-border window sum as prefix sums plus border-multiplicity
    corrections (no gathers)."""
    w2 = size // 2
    N = x.shape[axis]
    c = jnp.cumsum(x, axis=axis, dtype=x.dtype)
    pad_hi = [(0, 0)] * x.ndim
    pad_hi[axis] = (0, w2)
    pad_lo = [(0, 0)] * x.ndim
    pad_lo[axis] = (w2 + 1, 0)
    ext = jnp.pad(jnp.pad(c, pad_hi, mode="edge"), pad_lo)
    hi = jax.lax.slice_in_dim(ext, 2 * w2 + 1, 2 * w2 + 1 + N, axis=axis)
    lo = jax.lax.slice_in_dim(ext, 0, N, axis=axis)
    interior = hi - lo  # zero-padded window sum

    # replicate semantics: clamped out-of-range taps read the border element
    idx_shape = [1] * x.ndim
    idx_shape[axis] = N
    i = jax.lax.broadcasted_iota(jnp.int32, tuple(idx_shape), axis)
    low_cnt = jnp.maximum(w2 - i, 0).astype(x.dtype)
    hi_cnt = jnp.maximum(i + w2 - (N - 1), 0).astype(x.dtype)
    first = jax.lax.slice_in_dim(x, 0, 1, axis=axis)
    last = jax.lax.slice_in_dim(x, N - 1, N, axis=axis)
    return interior + low_cnt * first + hi_cnt * last


def _sgm_step(Crow: jnp.ndarray, Lp: jnp.ndarray, p1: int, p2: int) -> jnp.ndarray:
    """One SGM recurrence step; Crow/Lp: (N, D). Zero Lp rows reproduce the
    OpenCV zero border (min over zeros = 0 -> delta = p2, m = 0)."""
    N = Lp.shape[0]
    minLp = jnp.min(Lp, axis=1, keepdims=True)
    lm = jnp.concatenate([jnp.full((N, 1), MAX_COST), Lp[:, :-1]], axis=1)
    lp_ = jnp.concatenate([Lp[:, 1:], jnp.full((N, 1), MAX_COST)], axis=1)
    delta = minLp + p2
    m = jnp.minimum(jnp.minimum(Lp, lm + p1), jnp.minimum(lp_ + p1, delta))
    return Crow + m - delta


def _aggregate_dir(C: jnp.ndarray, p1: int, p2: int, dy: int, dx: int) -> jnp.ndarray:
    """One-direction SGM aggregation; golden `_aggregate_dir` parity.

    C: (H, W1, D) int32. Horizontal directions scan over x with an (H, D)
    carry; all others scan over y with a (W1, D) carry shifted by dx/step.
    """
    H, W1, D = C.shape

    if dy == 0:
        # scan along x in direction of travel; carry = previous column's L
        xsC = jnp.swapaxes(C, 0, 1)  # (W1, H, D)
        if dx < 0:
            xsC = xsC[::-1]

        def stepx(Lp, Crow):
            L = _sgm_step(Crow, Lp, p1, p2)
            return L, L

        _, Ls = jax.lax.scan(stepx, jnp.zeros((H, D), jnp.int32), xsC)
        if dx < 0:
            Ls = Ls[::-1]
        return jnp.swapaxes(Ls, 0, 1)

    rows = C if dy > 0 else C[::-1]

    def stepy(Lprev, Crow):
        if dx == 0:
            Lp = Lprev
        elif dx > 0:
            Lp = jnp.concatenate(
                [jnp.zeros((dx, D), jnp.int32), Lprev[:-dx]], axis=0
            )
        else:
            Lp = jnp.concatenate(
                [Lprev[-dx:], jnp.zeros((-dx, D), jnp.int32)], axis=0
            )
        L = _sgm_step(Crow, Lp, p1, p2)
        return L, L

    _, Ls = jax.lax.scan(stepy, jnp.zeros((W1, D), jnp.int32), rows)
    return Ls if dy > 0 else Ls[::-1]


_DIRS_PASS1 = [(0, 1), (1, 1), (1, 0), (1, -1)]
_DIRS_PASS2 = [(0, -1), (-1, -1), (-1, 0), (-1, 1)]


def sgm_directions(num_paths: int):
    """(dy, dx) aggregation directions. num_paths: 5 (cv2 MODE_SGBM
    single-pass parity: the 4 causal directions + the within-row reverse
    horizontal -- golden/sgbm.py note), 8 (MODE_HH), or 4 (causal only,
    kept for the tiled/sharded direction-family tests)."""
    dirs = list(_DIRS_PASS1)
    if num_paths == 5:
        dirs += [(0, -1)]
    elif num_paths >= 8:
        dirs += list(_DIRS_PASS2)
    return dirs


def aggregate_cost(C: jnp.ndarray, p1: int, p2: int, num_paths: int) -> jnp.ndarray:
    """Sum of directional aggregations over sgm_directions(num_paths)."""
    S = jnp.zeros_like(C)
    for dy, dx in sgm_directions(num_paths):
        S = S + _aggregate_dir(C, p1, p2, dy, dx)
    return S


def wta_uniq_subpix(
    S: jnp.ndarray, uniqueness_ratio: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-pixel WTA + uniqueness + parabolic subpixel from an aggregated
    cost volume S (..., D) int32. Returns (best, minS, dval_x16, bad_uniq);
    dval excludes the min_disparity offset (caller adds minD * DISP_SCALE).

    WTA ties -> smallest d via one packed-key (S, d) reduction (yields
    min cost AND argmin in a single volume pass); |S| < 2^19 so S*D + d
    fits int32. Golden parity: golden/sgbm.py WTA/uniqueness/subpixel."""
    D = S.shape[-1]
    ish = (1,) * (S.ndim - 1) + (D,)
    di = jax.lax.broadcasted_iota(jnp.int32, ish, S.ndim - 1)
    kmin = jnp.min(S * D + di, axis=-1)
    best = kmin % D
    minS = kmin // D

    # uniqueness (SGBM form): reject if any d outside best+/-1 has
    # S[d]*(100-ratio) < minS*100
    outside = jnp.abs(di - best[..., None]) > 1
    bad_uniq = jnp.any(
        outside & (S * (100 - uniqueness_ratio) < minS[..., None] * 100),
        axis=-1,
    )

    # parabolic subpixel (only with both neighbors in range)
    has_nb = (best > 0) & (best < D - 1)
    BIGS = jnp.int32(2**30)
    sm = jnp.min(jnp.where(di == best[..., None] - 1, S, BIGS), axis=-1)
    sp = jnp.min(jnp.where(di == best[..., None] + 1, S, BIGS), axis=-1)
    sm = jnp.where(best > 0, sm, minS)
    sp = jnp.where(best < D - 1, sp, minS)
    denom2 = jnp.maximum(sm + sp - 2 * minS, 1)
    num = (sm - sp) * DISP_SCALE + denom2
    sub = jnp.sign(num) * (jnp.abs(num) // (denom2 * 2))
    dval = jnp.where(has_nb, best * DISP_SCALE + sub, best * DISP_SCALE)
    return best, minS, dval, bad_uniq


def _lr_check_sgbm(
    disp: jnp.ndarray, best: jnp.ndarray, minS: jnp.ndarray,
    minX1: int, width1: int, min_disp: int, num_disp: int, max_diff: int,
) -> jnp.ndarray:
    """Inline SGBM left-right check (golden lines: disp2 from integer bestDisp
    with minS cost; invalidate when BOTH floor and ceil candidates disagree).

    disp: (H, W) int16 x16; best/minS: (H, W1) over the computed x range.
    """
    H, W = disp.shape
    INVALID = (min_disp - 1) * DISP_SCALE
    d16 = disp.astype(jnp.int32)

    ys1 = jax.lax.broadcasted_iota(jnp.int32, (H, width1), 0)
    xs1 = jax.lax.broadcasted_iota(jnp.int32, (H, width1), 1) + minX1
    d_int = best + min_disp
    valid1 = d16[:, minX1 : minX1 + width1] != INVALID
    x2 = xs1 - d_int
    in_rng = valid1 & (x2 >= 0) & (x2 < W)

    # Packed (cost, best) key: within one bin x2 the left x ascends exactly
    # with the integer disparity (x = x2 + d_int), so lexicographic
    # (minS, best) reproduces the sequential strict-lower-cost, leftmost-
    # first update order AND carries the winner's disparity in the key.
    # minS < 8 paths * win^2 * 236 < 2^23; Dpow = 256. The winner per right
    # pixel and the read-backs are shift-reduces over the D candidate
    # integer disparities -- no scatter, no gather (ops/bm.py _lr_check) --
    # run as fori_loops over dynamic slices of once-padded planes (the
    # D-unrolled form cost the flagship program minutes of XLA compile).
    Dpow = 256  # best in [0, D), D <= 255 at any supported operating point
    BIGKEY = jnp.iinfo(jnp.int32).max
    SENT = jnp.iinfo(jnp.int32).min

    key1 = jnp.where(in_rng, minS * Dpow + best, BIGKEY)
    # full-width planes (computed range only)
    keyW = jnp.full((H, W), BIGKEY, jnp.int32)
    keyW = jax.lax.dynamic_update_slice(keyW, key1, (0, minX1))
    d_intW = jnp.full((H, W), SENT, jnp.int32)
    d_intW = jax.lax.dynamic_update_slice(d_intW, d_int, (0, minX1))

    xsW = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    ok_range = (xsW >= minX1) & (xsW < minX1 + width1)
    d1 = d16
    validW = ok_range & (d1 != INVALID)
    _d = d1 >> DISP_SHIFT
    d_ = (d1 + DISP_SCALE - 1) >> DISP_SHIFT
    _x = xsW - _d
    x_ = xsW - d_
    oka = (_x >= 0) & (_x < W)
    okb = (x_ >= 0) & (x_ < W)

    M = num_disp + abs(min_disp) + 2
    d_intW_pad = jnp.pad(d_intW, ((0, 0), (M, M)), constant_values=SENT)
    keyW_pad = jnp.pad(keyW, ((0, 0), (M, M)), constant_values=BIGKEY)

    def win_body(i, acc):
        dd = min_disp + i
        ds = jax.lax.dynamic_slice(d_intW_pad, (0, M + dd), (H, W))
        ks = jax.lax.dynamic_slice(keyW_pad, (0, M + dd), (H, W))
        return jnp.minimum(acc, jnp.where(ds == dd, ks, BIGKEY))

    best_key = jax.lax.fori_loop(
        0, num_disp, win_body, jnp.full((H, W), BIGKEY, jnp.int32)
    )
    has = best_key != BIGKEY
    disp2 = jnp.where(has, best_key % Dpow + min_disp, INVALID)

    # validate every computed-range pixel against both floor & ceil
    # candidates via two more shift-reduces (_d and d_ each span at most
    # [minD-1, minD+D]).
    disp2_pad = jnp.pad(disp2, ((0, 0), (M, M)), constant_values=INVALID)

    def rb_body(i, acc):
        dd = min_disp - 1 + i
        sh = jax.lax.dynamic_slice(disp2_pad, (0, M - dd), (H, W))
        a, b = acc
        return jnp.where(_d == dd, sh, a), jnp.where(d_ == dd, sh, b)

    d2a, d2b = jax.lax.fori_loop(
        0, num_disp + 2, rb_body,
        (jnp.full((H, W), INVALID, jnp.int32),
         jnp.full((H, W), INVALID, jnp.int32)),
    )
    d2a = jnp.where(oka, d2a, INVALID)
    d2b = jnp.where(okb, d2b, INVALID)
    bad = (
        validW
        & oka & (d2a >= min_disp) & (jnp.abs(d2a - _d) > max_diff)
        & okb & (d2b >= min_disp) & (jnp.abs(d2b - d_) > max_diff)
    )
    return jnp.where(bad, jnp.asarray(INVALID, disp.dtype), disp)


def stereo_sgbm(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: MatcherConfig,
) -> jnp.ndarray:
    """int16 x16 disparity map, cv::StereoSGBM parity (golden bit-exact).

    left/right: (H, W) uint8 rectified grayscale. The directional
    aggregation runs as the GPU kernel (ops/sgm_kernel.py) where
    `sgm_kernel_selected` picks it, else as XLA scans; both are bit-exact.
    """
    from rt_depth_map.ops.sgm_kernel import (
        aggregate_cost_pallas,
        sgm_kernel_selected,
    )

    H, W = left.shape
    D = cfg.num_disparities
    minD = cfg.min_disparity
    INVALID = (minD - 1) * DISP_SCALE
    p1 = cfg.p1
    p2 = max(cfg.p2, p1 + 1)
    num_paths = 8 if cfg.num_paths >= 8 else (5 if cfg.num_paths == 5 else 4)

    C, minX1, width1 = sgbm_cost_volume(
        left, right, D, cfg.block_size, minD, cfg.pre_filter_cap
    )
    if sgm_kernel_selected(cfg.backend):
        # every direction re-reads C: stream it as int16 where it provably
        # fits (pixel cost <= 2*ftzero + 255>>2, C <= block_size^2 * that)
        ftzero = max(cfg.pre_filter_cap, 15) | 1
        c_max = cfg.block_size * cfg.block_size * (2 * ftzero + (255 >> 2))
        if c_max <= 32767:
            C = C.astype(jnp.int16)
        S = aggregate_cost_pallas(C, p1, p2, num_paths)
    else:
        S = aggregate_cost(C, p1, p2, num_paths)
    best, minS, dval, bad_uniq = wta_uniq_subpix(S, cfg.uniqueness_ratio)
    dval = dval + minD * DISP_SCALE

    disp1 = jnp.where(bad_uniq, INVALID, dval).astype(jnp.int16)
    disp = jnp.full((H, W), INVALID, dtype=jnp.int16)
    disp = jax.lax.dynamic_update_slice(disp, disp1, (0, minX1))

    if cfg.disp12_max_diff >= 0:
        disp = _lr_check_sgbm(
            disp, best, minS, minX1, width1, minD, D, cfg.disp12_max_diff,
        )
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(
            disp, INVALID, cfg.speckle_window_size, cfg.speckle_range * DISP_SCALE
        )
    return disp


def stereo_sgbm_batch(
    lefts: jnp.ndarray,
    rights: jnp.ndarray,
    cfg: MatcherConfig,
) -> jnp.ndarray:
    """(B, H, W) uint8 pairs -> (B, H, W) int16 disparities, each frame
    stereo_sgbm's (a static per-frame loop)."""
    return jnp.stack(
        [stereo_sgbm(lefts[i], rights[i], cfg) for i in range(lefts.shape[0])]
    )
