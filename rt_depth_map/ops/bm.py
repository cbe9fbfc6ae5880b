"""Konolige SAD block matcher as a jittable JAX program.

Semantics identical to the golden numpy implementation (golden/bm.py), which
is itself bit-exact vs the cv::StereoBM configuration the reference uses
(main.cpp:130, bm-sw.cpp:16-25).

Formulation notes:
  * The cost volume is built as a (D, H, W) int32 tensor -- W minor, D as
    the outermost axis (cheap to shard or scan over).
  * Window sums are prefix-sum sliding windows (no reduce_window/gather).
  * WTA tie-break toward the LARGEST disparity is expressed as an argmin
    over the d-reversed volume.
  * The left-right check packs (cost, d) keys and resolves winners with
    shift-reduces over candidate disparities (no scatter), reproducing
    cv2's first-lowest-cost-wins semantics.
  * Dynamic per-frame ROIs (estimator.cpp:54-56 re-ROIs every frame) are
    traced scalars turned into masks via broadcasted iota -- static shapes,
    no recompilation per frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.prefilter import xsobel_prefilter
from rt_depth_map.ops.speckle import filter_speckles

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
_BIGCOST = 2**28  # python int, see ops/cc.py note on module-scope jnp scalars


def _sliding_sum(x: jnp.ndarray, size: int, axis: int) -> jnp.ndarray:
    """Centered zero-padded sliding sum along `axis` via prefix sums:
    out[i] = sum x[i-w2 .. i+w2] -- two static slices of the cumsum, no
    reduce_window and no gathers."""
    w2 = size // 2
    c = jnp.cumsum(x, axis=axis, dtype=x.dtype)
    N = x.shape[axis]
    # ext[k] = cumsum up to (exclusive) clamp(k - w2, 0, N)
    pad_hi = [(0, 0)] * x.ndim
    pad_hi[axis] = (0, w2)
    pad_lo = [(0, 0)] * x.ndim
    pad_lo[axis] = (w2 + 1, 0)
    ext = jnp.pad(jnp.pad(c, pad_hi, mode="edge"), pad_lo)
    hi = jax.lax.slice_in_dim(ext, 2 * w2 + 1, 2 * w2 + 1 + N, axis=axis)
    lo = jax.lax.slice_in_dim(ext, 0, N, axis=axis)
    return hi - lo


def _box_filter_2d(x: jnp.ndarray, size: int) -> jnp.ndarray:
    """Centered (size x size) zero-padded sliding sum over the last two dims;
    border outputs are garbage (masked by the caller's valid region)."""
    s = _sliding_sum(x, size, x.ndim - 2)
    return _sliding_sum(s, size, x.ndim - 1)


def _cost_volume(lp: jnp.ndarray, rp: jnp.ndarray, num_disp: int, min_disp: int,
                 block_size: int) -> jnp.ndarray:
    """(D, H, W) windowed SAD of prefiltered images; invalid columns get a
    huge cost so they never win WTA.

    A `fori_loop` over d with dynamic slices of the once-padded right image
    (not a D-unrolled plane stack: 128 unrolled (H, W) subgraphs made the
    flagship program's XLA compile take minutes)."""
    H, W = lp.shape
    lp32 = lp.astype(jnp.int32)
    rp32 = rp.astype(jnp.int32)
    M = num_disp + abs(min_disp) + 1
    rp_pad = jnp.pad(rp32, ((0, 0), (M, M)))
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

    def body(i, vol):
        dd = min_disp + i
        # r[:, x] = rp[:, x - dd] (zero outside)
        r = jax.lax.dynamic_slice(rp_pad, (0, M - dd), (H, W))
        inb = (xs - dd >= 0) & (xs - dd < W)
        ad = jnp.where(inb, jnp.abs(lp32 - r), 0)
        return jax.lax.dynamic_update_slice(vol, ad[None], (i, 0, 0))

    vol = jax.lax.fori_loop(
        0, num_disp, body, jnp.zeros((num_disp, H, W), jnp.int32)
    )
    return _box_filter_2d(vol, block_size)


def _shift_cols_i32(a: jnp.ndarray, n: int, fill: int) -> jnp.ndarray:
    """out[:, x] = a[:, x + n] with fill (static n, either sign)."""
    H, W = a.shape
    if n == 0:
        return a
    if n > 0:
        n = min(n, W)
        return jnp.concatenate(
            [a[:, n:], jnp.full((H, n), fill, a.dtype)], axis=1
        )
    n = min(-n, W)
    return jnp.concatenate([jnp.full((H, n), fill, a.dtype), a[:, :-n]], axis=1)


def _lr_check(disp: jnp.ndarray, cost: jnp.ndarray, min_disp: int,
              num_disp: int, max_diff: int) -> jnp.ndarray:
    """cv::validateDisparity parity (see golden/postproc.py).

    Formulated as shift-reduces instead of the per-pixel scatter-min +
    gather: for each right pixel x2, its candidate left
    pixels are exactly {x2 + dd : d_int[x2 + dd] == dd}, so the winner is a
    min over D+2 statically shifted masked key planes. The packed
    (cost, d32) key reproduces the sequential first-lowest-cost, leftmost-
    wins order because within a bin the left x ascends with d32."""
    H, W = disp.shape
    invalid = (min_disp - 1) * DISP_SCALE
    d32 = disp.astype(jnp.int32)
    ok = d32 != invalid
    d_int = (d32 + DISP_SCALE // 2) >> DISP_SHIFT
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    x2 = xs - d_int
    in_range = ok & (x2 >= 0) & (x2 < W)

    Dpow = 1 << 13
    off = 1 << 11
    BIG = jnp.iinfo(jnp.int32).max
    SENT = jnp.iinfo(jnp.int32).min
    key = cost * Dpow + (d32 + off)
    key = jnp.where(in_range, key, BIG)

    # Both shift-reduces run as fori_loops over the candidate disparities
    # with dynamic slices of once-padded planes (a D-unrolled loop here cost
    # the flagship program minutes of XLA compile time).
    M = num_disp + abs(min_disp) + 1
    d_int_pad = jnp.pad(d_int, ((0, 0), (M, M)), constant_values=SENT)
    key_pad = jnp.pad(key, ((0, 0), (M, M)), constant_values=BIG)

    # winner per right pixel: min over candidate integer disparities
    def win_body(i, best):
        dd = min_disp + i
        ds = jax.lax.dynamic_slice(d_int_pad, (0, M + dd), (H, W))
        ks = jax.lax.dynamic_slice(key_pad, (0, M + dd), (H, W))
        return jnp.minimum(best, jnp.where(ds == dd, ks, BIG))

    best_key = jax.lax.fori_loop(
        0, num_disp + 1, win_body, jnp.full((H, W), BIG, jnp.int32)
    )
    has_winner = best_key != BIG
    disp2 = jnp.where(has_winner, best_key % Dpow - off, invalid)

    # disp2 read back at each left pixel's own x2: another shift-reduce
    disp2_pad = jnp.pad(disp2, ((0, 0), (M, M)), constant_values=invalid)

    def rb_body(i, acc):
        dd = min_disp + i
        sh = jax.lax.dynamic_slice(disp2_pad, (0, M - dd), (H, W))
        return jnp.where(d_int == dd, sh, acc)

    disp2_at = jax.lax.fori_loop(
        0, num_disp + 1, rb_body, jnp.full((H, W), invalid, jnp.int32)
    )
    disp2_at = jnp.where(in_range, disp2_at, invalid)
    bad = ok & in_range & (jnp.abs(disp2_at - d32) > max_diff * DISP_SCALE)
    # out-of-range projections: cv2 leaves them untouched
    return jnp.where(bad, jnp.asarray(invalid, disp.dtype), disp)


def stereo_bm(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: MatcherConfig,
    roi1: Optional[Tuple] = None,
    roi2: Optional[Tuple] = None,
) -> jnp.ndarray:
    """Compute the int16 x16 disparity map (cv::StereoBM parity).

    left/right: (H, W) uint8 rectified grayscale. roi1/roi2: optional
    (x, y, w, h) -- python ints or traced scalars (dynamic per-frame ROI).
    """
    H, W = left.shape
    D = cfg.num_disparities
    minD = cfg.min_disparity
    bs = cfg.block_size
    w2 = bs // 2
    maxD = minD + D - 1
    INVALID = (minD - 1) * DISP_SCALE

    lp = xsobel_prefilter(left, cfg.pre_filter_cap)
    rp = xsobel_prefilter(right, cfg.pre_filter_cap)
    cost = _cost_volume(lp, rp, D, minD, bs)  # (D, H, W)

    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    valid = (
        (ys >= w2) & (ys < H - w2) & (xs >= max(maxD, 0) + w2) & (xs < W - w2)
    )

    def norm_roi(r):
        if r is None:
            return (0, 0, W, H)
        return r

    if roi1 is not None or roi2 is not None:
        r1x, r1y, r1w, r1h = norm_roi(roi1)
        r2x, r2y, r2w, r2h = norm_roi(roi2)
        # empty ROI behaves as full frame (cv2 parity, golden/bm.py)
        r1x, r1y, r1w, r1h = [
            jnp.where(r1w * r1h > 0, v, f)
            for v, f in zip((r1x, r1y, r1w, r1h), (0, 0, W, H))
        ]
        r2x, r2y, r2w, r2h = [
            jnp.where(r2w * r2h > 0, v, f)
            for v, f in zip((r2x, r2y, r2w, r2h), (0, 0, W, H))
        ]
        rxmin = jnp.maximum(r1x, r2x + maxD) + w2
        rxmax = jnp.minimum(r1x + r1w, r2x + r2w) - w2
        rymin = jnp.maximum(r1y, r2y) + w2
        rymax = jnp.minimum(r1y + r1h, r2y + r2h) - w2
        valid = valid & (xs >= rxmin) & (xs < rxmax) & (ys >= rymin) & (ys < rymax)

    # WTA, ties -> largest disparity. One packed-key (cost, D-1-d)
    # reduction over the D axis yields min cost and the largest-d
    # tie-broken argmin in a single volume pass; cost < 2^18 so
    # cost*D + d fits int32.
    di0 = jax.lax.broadcasted_iota(jnp.int32, (D, 1, 1), 0)
    kmin = jnp.min(cost * D + (D - 1 - di0), axis=0)
    best_i = D - 1 - (kmin % D)
    best_cost = kmin // D

    # texture check
    texture = _box_filter_2d(
        jnp.abs(lp.astype(jnp.int32) - cfg.pre_filter_cap), bs
    )
    tex_ok = texture >= cfg.texture_threshold

    # uniqueness check
    thresh = best_cost + (best_cost * cfg.uniqueness_ratio) // 100
    di = jax.lax.broadcasted_iota(jnp.int32, (D, 1, 1), 0)
    outside = jnp.abs(di - best_i[None]) > 1
    uniq_bad = jnp.any(outside & (cost <= thresh[None]), axis=0)

    # subpixel neighbor costs
    BIGS = jnp.int32(2**30)
    c_p1 = jnp.min(jnp.where(di == best_i[None] + 1, cost, BIGS), axis=0)
    c_m1 = jnp.min(jnp.where(di == best_i[None] - 1, cost, BIGS), axis=0)
    c_m1 = jnp.where(best_i == 0, c_p1, c_m1)
    c_p1 = jnp.where(best_i == D - 1, c_m1, c_p1)
    p, n = c_m1, c_p1
    denom = p + n - 2 * best_cost + jnp.abs(p - n)
    num = (p - n) * 256
    delta = jnp.where(
        denom != 0,
        jnp.sign(num) * (jnp.abs(num) // jnp.maximum(denom, 1)),
        0,
    )
    packed = ((best_i + minD) * 256 + delta + 15) >> 4

    disp = jnp.where(valid & tex_ok & ~uniq_bad, packed, INVALID).astype(jnp.int16)

    if cfg.disp12_max_diff >= 0:
        disp = _lr_check(disp, best_cost, minD, D, cfg.disp12_max_diff)
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(
            disp, INVALID, cfg.speckle_window_size, cfg.speckle_range * DISP_SCALE
        )
    return disp
