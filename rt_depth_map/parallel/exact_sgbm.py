"""Exact width-tiled semi-global matching: chunked scans across chips.

`parallel/tiled_sgbm.py` tiles SGM with overlap margins (approximate, fast:
tiles never talk during aggregation). This module is the EXACT counterpart
-- the SURVEY section 5.7 "long sequence" design: the directional
recurrences whose paths cross tile boundaries exchange their boundary-column
L_r state between neighbor devices with `ppermute`, pipelined over row
blocks in a wavefront so every chip streams its own rows while the carry
ripples across the mesh. Output is bit-identical to the single-device
`ops.sgbm.stereo_sgbm` (XLA path) for every pixel, with no tile-width
constraint (margin mode needs tile_w >= margin + D + 2; exact mode works at
any tile width that divides W1).

How each direction family is tiled (image width W1 split into n tiles of
Wloc columns; rows split into K blocks of Rb):

  * vertical (dy=+-1, dx=0): columns are independent -- fully tile-local.
  * horizontal (dy=0): the (row, D) carry leaving a tile's last column is
    exactly the carry entering its neighbor's first column, same row.
  * diagonal (dy=+-1, dx=+-1): the carry column shifts one lane per row, so
    the value shifted in at a tile's edge column on row r is the neighbor's
    edge-column L_r at row r-+1.

A tile can therefore process row-block k of a left-to-right direction as
soon as its left neighbor has finished block k (the dependency never skips
ahead more than one row inside the block). That gives a wavefront: at
global step t, tile i processes block t - i; right-to-left directions run
the mirror wavefront from the last tile, concurrently. Each step exchanges
one (Rb+1, D) boundary strip per direction (stacked into a single
`ppermute` per family). Pipeline fill costs (n-1)/(K+n-1) idle fraction --
row_block defaults to ~K = 4n blocks (80% steady-state occupancy).

All six cross-tile directions reduce to two scan cores (down-right
diagonal, left-to-right horizontal) by flipping the row/column axes of the
block in "core space"; messages stay in global row order.

The cost volume is computed tile-locally and exactly: border-sensitive
preprocess planes (Sobel clip, raw, half-pixel envelopes) are built on the
replicated full images (O(H W), cheap), the BT cost + window sums only for
the tile's own W1 columns (the O(H W1 D / n) part). The W1-space replicate
border of the window sum is re-imposed on the two edge tiles.

Post-aggregation (WTA, uniqueness, subpixel) is per-tile elementwise; the
LR check and speckle filter run replicated on the gathered (H, W1) maps,
exactly as the margin-mode tiling does.

Reference parity: this distributes /root/reference's single-threaded
cv::StereoSGBM call (stereo-matcher/sw/semi-global-matcher-sw.cpp) across a
device mesh with zero approximation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import (
    DISP_SCALE,
    _aggregate_dir,
    _halfpix,
    _lr_check_sgbm,
    _sgm_step,
    _sliding_sum_replicate,
    sgbm_preprocess,
    wta_uniq_subpix,
)
from rt_depth_map.ops.speckle import filter_speckles


def _tile_cost_volume(
    lF: jnp.ndarray,
    rF: jnp.ndarray,
    cfg: MatcherConfig,
    idx: jnp.ndarray,
    Wloc: int,
) -> jnp.ndarray:
    """Exact (H, Wloc, D) windowed BT cost of tile `idx` from replicated
    full images; bit-equal to sgbm_cost_volume(...)[:, idx*Wloc:(idx+1)*Wloc].
    """
    H, W = lF.shape
    D = cfg.num_disparities
    minD = cfg.min_disparity
    minX1 = max(minD + D, 0)
    maxX1 = W + min(minD, 0)
    W1 = maxX1 - minX1
    bs = cfg.block_size
    w2 = bs // 2
    ftzero = max(cfg.pre_filter_cap, 15) | 1

    ls, lrw = sgbm_preprocess(lF, ftzero)
    rs, rrw = sgbm_preprocess(rF, ftzero)
    u0s, u1s = _halfpix(ls)
    u0r, u1r = _halfpix(lrw)
    v0s, v1s = _halfpix(rs)
    v0r, v1r = _halfpix(rrw)

    We = Wloc + 2 * w2
    # global image x of extended column 0 (may undershoot minX1 by w2 on
    # tile 0 -- those columns are replaced by the replicate border below)
    startx = minX1 + idx * Wloc - w2
    M = D + abs(minD) + w2 + 2

    def lslice(p):
        return jax.lax.dynamic_slice(
            jnp.pad(p, ((0, 0), (M, M))), (0, M + startx), (H, We)
        )

    pls, pu0s, pu1s = lslice(ls), lslice(u0s), lslice(u1s)
    plr, pu0r, pu1r = lslice(lrw), lslice(u0r), lslice(u1r)
    rpad = [jnp.pad(p, ((0, 0), (M, M))) for p in (rs, v0s, v1s, rrw, v0r, v1r)]
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, We), 1) + startx

    def bt(u, u0, u1, v, v0, v1):
        c0 = jnp.maximum(0, jnp.maximum(u - v1, v0 - u))
        c1 = jnp.maximum(0, jnp.maximum(v - u1, u0 - v))
        return jnp.minimum(c0, c1)

    def body(i, vol):
        dd = minD + i
        start = (0, M + startx - dd)
        vs, vv0s, vv1s, vr, vv0r, vv1r = (
            jax.lax.dynamic_slice(p, start, (H, We)) for p in rpad
        )
        pix = bt(pls, pu0s, pu1s, vs, vv0s, vv1s) + (
            bt(plr, pu0r, pu1r, vr, vv0r, vv1r) >> 2
        )
        inb = (xs - dd >= 0) & (xs - dd < W)
        c = jnp.where(inb, pix, 0)
        return jax.lax.dynamic_update_slice(vol, c[..., None], (0, 0, i))

    pix_ext = jax.lax.fori_loop(
        0, D, body, jnp.zeros((H, We, D), jnp.int32)
    )

    # W1-space replicate border of the horizontal window (edge tiles only)
    gj = (jax.lax.broadcasted_iota(jnp.int32, (1, We, 1), 1)
          + idx * Wloc - w2)
    pix_ext = jnp.where(gj < 0, pix_ext[:, w2 : w2 + 1, :], pix_ext)
    pix_ext = jnp.where(
        gj > W1 - 1, pix_ext[:, We - w2 - 1 : We - w2, :], pix_ext
    )

    # valid horizontal window sum (the replicate taps are materialized in
    # the extension), then the replicate-border vertical sum (H unsharded)
    cs = jnp.cumsum(pix_ext, axis=1)
    hi = jax.lax.slice_in_dim(cs, 2 * w2, We, axis=1)
    lo = jnp.concatenate(
        [jnp.zeros((H, 1, D), jnp.int32),
         jax.lax.slice_in_dim(cs, 0, Wloc - 1, axis=1)],
        axis=1,
    )
    return _sliding_sum_replicate(hi - lo, bs, axis=0)


def _diag_core(Cblk, inrows, Lp0, p1, p2):
    """Down-right scan over a (Rb, Wloc, D) block in core orientation.
    inrows[r]: (D,) boundary L shifted in at column 0 of row r (the left
    neighbor's edge column, previous row). Lp0: own previous-row carry."""

    def step(Lprev, xs):
        Crow, fill = xs
        Lp = jnp.concatenate([fill[None], Lprev[:-1]], axis=0)
        L = _sgm_step(Crow, Lp, p1, p2)
        return L, L

    _, Ls = jax.lax.scan(step, Lp0, (Cblk, inrows))
    return Ls


def _horiz_core(Cblk, carry0, p1, p2):
    """Left-to-right scan over a (Rb, Wloc, D) block; carry0: (Rb, D) from
    the left neighbor's edge column, same rows."""
    xsC = jnp.swapaxes(Cblk, 0, 1)  # (Wloc, Rb, D)

    def stepx(Lp, Crow):
        L = _sgm_step(Crow, Lp, p1, p2)
        return L, L

    _, Ls = jax.lax.scan(stepx, carry0, xsC)
    return jnp.swapaxes(Ls, 0, 1)


def _exact_cross_aggregate(
    C_loc: jnp.ndarray,
    p1: int,
    p2: int,
    num_paths: int,
    space_axis: str,
    Rb: int,
) -> jnp.ndarray:
    """Sum of the cross-tile directions' L volumes for this tile, exact.

    Wavefront over K = H // Rb row blocks; one fori_loop of K + n - 1 steps.
    Message layout per direction (Rb+1, D), global row order:
      down dirs (dy >= 0): m[i] = edge-column L at row a - 1 + i
      up dirs   (dy == -1): m[i] = edge-column L at row a + i
    where a is the block's first row; index 0 / Rb carries the adjacent
    block's row so diagonals see row a-1 (resp. a+Rb) across the exchange.
    """
    H, Wloc, D = C_loc.shape
    if H % Rb:
        raise ValueError((H, Rb))
    K = H // Rb
    n = jax.lax.axis_size(space_axis)
    idx = jax.lax.axis_index(space_axis)

    # (dy, dx): dx=+1 dirs wave from tile 0, dx=-1 from tile n-1
    if num_paths >= 8:
        dirs = [(0, 1), (1, 1), (-1, 1), (0, -1), (1, -1), (-1, -1)]
    elif num_paths == 5:
        # cv2 MODE_SGBM single-pass parity: 4 causal + reverse horizontal
        dirs = [(0, 1), (1, 1), (1, -1), (0, -1)]
    else:
        dirs = [(0, 1), (1, 1), (1, -1)]
    fwd = [i for i, (_, dx) in enumerate(dirs) if dx == 1]
    bwd = [i for i, (_, dx) in enumerate(dirs) if dx == -1]
    perm_fwd = [(i, i + 1) for i in range(n - 1)]
    perm_bwd = [(i, i - 1) for i in range(1, n)]

    zstrip = jnp.zeros((Rb + 1, D), jnp.int32)
    zprev = jnp.zeros((Wloc, D), jnp.int32)
    outboxes = [zstrip for _ in dirs]
    prevs = [zprev for _ in dirs]
    Sacc = jnp.zeros((H, Wloc, D), jnp.int32)

    def body(t, carry):
        Sacc, outboxes, prevs = carry
        # exchange last step's boundary strips (one collective per family;
        # ppermute zero-fills the mesh-edge tiles = the OpenCV zero border)
        inboxes = [None] * len(dirs)
        if fwd:
            got = jax.lax.ppermute(
                jnp.stack([outboxes[i] for i in fwd]), space_axis, perm_fwd
            )
            for j, i in enumerate(fwd):
                inboxes[i] = got[j]
        if bwd:
            got = jax.lax.ppermute(
                jnp.stack([outboxes[i] for i in bwd]), space_axis, perm_bwd
            )
            for j, i in enumerate(bwd):
                inboxes[i] = got[j]

        new_out = list(outboxes)
        new_prev = list(prevs)
        for i, (dy, dx) in enumerate(dirs):
            lag = idx if dx == 1 else n - 1 - idx
            k = t - lag
            active = (k >= 0) & (k < K)
            kc = jnp.clip(k, 0, K - 1)
            up = dy == -1
            start = H - (kc + 1) * Rb if up else kc * Rb
            blk = jax.lax.dynamic_slice(
                C_loc, (start, 0, 0), (Rb, Wloc, D)
            )
            if up:
                blk = blk[::-1]
            if dx == -1:
                blk = blk[:, ::-1]
            inbox = inboxes[i]
            if dy == 0:
                Ls = _horiz_core(blk, inbox[1:], p1, p2)
            else:
                inrows = inbox[1:][::-1] if up else inbox[:Rb]
                Ls = _diag_core(blk, inrows, prevs[i], p1, p2)
                new_prev[i] = jnp.where(active, Ls[-1], prevs[i])
            brows = Ls[:, -1, :]  # core row order
            if up:
                no = jnp.concatenate([brows[::-1], outboxes[i][:1]], axis=0)
            else:
                no = jnp.concatenate([outboxes[i][-1:], brows], axis=0)
            new_out[i] = jnp.where(active, no, outboxes[i])
            Lg = Ls
            if dx == -1:
                Lg = Lg[:, ::-1]
            if up:
                Lg = Lg[::-1]
            Lg = jnp.where(active, Lg, 0)
            s = jax.lax.dynamic_slice(Sacc, (start, 0, 0), (Rb, Wloc, D))
            Sacc = jax.lax.dynamic_update_slice(Sacc, s + Lg, (start, 0, 0))
        return Sacc, tuple(new_out), tuple(new_prev)

    Sacc, _, _ = jax.lax.fori_loop(
        0, K + n - 1, body, (Sacc, tuple(outboxes), tuple(prevs))
    )
    return Sacc


def _default_row_block(H: int, n: int) -> int:
    """Largest divisor of H giving >= 4n row blocks (80% wavefront
    occupancy); falls back toward 1 (always a divisor)."""
    target = max(1, H // (4 * n))
    for rb in range(target, 0, -1):
        if H % rb == 0:
            return rb
    return 1


def exact_sgbm_tile_program(
    l_loc: jnp.ndarray,
    r_loc: jnp.ndarray,
    cfg: MatcherConfig,
    space_axis: str,
    row_block: int | None = None,
) -> jnp.ndarray:
    """Per-device tile program (callable inside any shard_map over
    `space_axis`; the swappable matcher-slot contract of
    parallel/pipeline_sharded.py). l/r_loc: (H, W/n) uint8 column tiles of
    the full rectified pair. Returns the full (H, W) int16 disparity,
    replicated along the space axis, BIT-EXACT vs single-device
    `ops.sgbm.stereo_sgbm`."""
    lF = jax.lax.all_gather(l_loc, space_axis, axis=1, tiled=True)
    rF = jax.lax.all_gather(r_loc, space_axis, axis=1, tiled=True)
    H, W = lF.shape
    n = jax.lax.axis_size(space_axis)
    D = cfg.num_disparities
    minD = cfg.min_disparity
    minX1 = max(minD + D, 0)
    maxX1 = W + min(minD, 0)
    W1 = maxX1 - minX1
    if W1 % n:
        raise ValueError(f"W1={W1} must divide n={n} tiles")
    Wloc = W1 // n
    Rb = row_block if row_block is not None else _default_row_block(H, n)
    p1 = cfg.p1
    p2 = max(cfg.p2, p1 + 1)
    INVALID = (minD - 1) * DISP_SCALE
    num_paths = (8 if cfg.num_paths >= 8
                 else (5 if cfg.num_paths == 5 else 4))

    idx = jax.lax.axis_index(space_axis)
    C_loc = _tile_cost_volume(lF, rF, cfg, idx, Wloc)
    S = _aggregate_dir(C_loc, p1, p2, 1, 0)
    if num_paths == 8:
        S = S + _aggregate_dir(C_loc, p1, p2, -1, 0)
    S = S + _exact_cross_aggregate(
        C_loc, p1, p2, num_paths, space_axis, Rb
    )
    best, minS, dval, bad_uniq = wta_uniq_subpix(S, cfg.uniqueness_ratio)
    dval = dval + minD * DISP_SCALE
    disp1_loc = jnp.where(bad_uniq, INVALID, dval).astype(jnp.int16)

    disp1 = jax.lax.all_gather(disp1_loc, space_axis, axis=1, tiled=True)
    bestF = jax.lax.all_gather(best, space_axis, axis=1, tiled=True)
    minSF = jax.lax.all_gather(minS, space_axis, axis=1, tiled=True)
    disp = jnp.full((H, W), INVALID, jnp.int16)
    disp = jax.lax.dynamic_update_slice(disp, disp1, (0, minX1))
    if cfg.disp12_max_diff >= 0:
        disp = _lr_check_sgbm(
            disp, bestF, minSF, minX1, W1, minD, D, cfg.disp12_max_diff,
        )
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(
            disp, INVALID, cfg.speckle_window_size,
            cfg.speckle_range * DISP_SCALE,
        )
    return disp


def exact_tiled_stereo_sgbm(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
    row_block: int | None = None,
) -> jnp.ndarray:
    """Single-frame width-tiled StereoSGBM over `mesh`, BIT-EXACT vs the
    single-device `ops.sgbm.stereo_sgbm` (XLA path). See module docstring;
    `parallel.tiled_sgbm.tiled_stereo_sgbm` is the faster approximate mode.
    """
    W = left.shape[1]
    n = mesh.shape[space_axis]
    if W % n:
        raise ValueError(f"W={W} must divide n={n} tiles")
    fn = jax.shard_map(
        lambda a, b: exact_sgbm_tile_program(a, b, cfg, space_axis,
                                             row_block),
        mesh=mesh,
        in_specs=(P(None, space_axis), P(None, space_axis)),
        out_specs=P(None, None),
        check_vma=False,
    )
    return fn(left, right)
