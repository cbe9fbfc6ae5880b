"""Width-tiled block matching over a device mesh with halo exchange.

The TP analog of SURVEY.md section 2.10: the image width is sharded over the
mesh's "space" axis; each device matches its own column tile. Correctness
needs a halo: disparity at global column x reads left-image columns
[x-w2, x+w2] and right-image columns [x-maxD-w2, x+w2] (w2 = blockSize//2,
maxD = minDisparity + numDisparities - 1), so each device fetches
  * w2 columns of the prefiltered left image from both neighbors, and
  * maxD+w2 columns of the prefiltered right image from its left neighbor
    (+ w2 from the right neighbor)
via `jax.lax.ppermute` -- one neighbor exchange per direction. Cost volume, WTA, and
the per-pixel validity checks are then tile-local and bit-identical to the
single-device path (integer math). The left-right consistency and speckle
passes are global (they chase matches/components across the whole row/image),
so the per-tile disparities and costs are `all_gather`ed (tiled) and the
postprocessing runs replicated -- its cost is tiny next to the cost volume.

Requires tile width >= maxD + w2 (single-hop halo); at the 1280x720/D=128
operating point that is satisfied from 2 to 8 devices.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.bm import (
    DISP_SCALE,
    _box_filter_2d,
    _lr_check,
)
from rt_depth_map.ops.prefilter import xsobel_prefilter
from rt_depth_map.ops.speckle import filter_speckles


def _halo_from_left(x: jnp.ndarray, n: int, axis_name: str) -> jnp.ndarray:
    """Receive the last `n` columns of the left neighbor (zeros at tile 0)."""
    k = jax.lax.axis_size(axis_name)
    perm = [(i, i + 1) for i in range(k - 1)]
    return jax.lax.ppermute(x[:, -n:], axis_name, perm)


def _halo_from_right(x: jnp.ndarray, n: int, axis_name: str) -> jnp.ndarray:
    k = jax.lax.axis_size(axis_name)
    perm = [(i + 1, i) for i in range(k - 1)]
    return jax.lax.ppermute(x[:, :n], axis_name, perm)


def _tile_cost_volume(lp_ext, rp_ext, num_disp, min_disp, bs, max_d):
    """(D, H, Wext) windowed SAD on halo-extended tiles.

    lp_ext column k is global x = x0 - w2 + k; rp_ext column k is global
    x = x0 - max_d - w2 + k, so disparity d pairs lp_ext[:, k] with
    rp_ext[:, k + max_d - d] -- a contiguous slice per d.
    """
    H, We = lp_ext.shape
    lp32 = lp_ext.astype(jnp.int32)
    rp32 = rp_ext.astype(jnp.int32)

    def body(i, vol):
        d = min_disp + i
        r = jax.lax.dynamic_slice(rp32, (0, max_d - d), (H, We))
        return jax.lax.dynamic_update_slice(
            vol, jnp.abs(lp32 - r)[None], (i, 0, 0)
        )

    vol = jax.lax.fori_loop(
        0, num_disp, body, jnp.zeros((num_disp, H, We), jnp.int32)
    )
    return _box_filter_2d(vol, bs)


def _tile_wta(cost, lp_ext, cfg: MatcherConfig, x0, W_full):
    """WTA + texture/uniqueness/subpixel on one tile; returns
    (disp int16 pre-postproc, best_cost). cost: (D, H, Wext); outputs are the
    core (H, Wloc) columns. Mirrors ops/bm.py stereo_bm exactly."""
    D = cfg.num_disparities
    minD = cfg.min_disparity
    bs = cfg.block_size
    w2 = bs // 2
    maxD = minD + D - 1
    INVALID = (minD - 1) * DISP_SCALE
    H, We = lp_ext.shape
    Wloc = We - 2 * w2

    core = slice(w2, w2 + Wloc)
    cost_c = cost[:, :, core]  # (D, H, Wloc)

    ys = jax.lax.broadcasted_iota(jnp.int32, (H, Wloc), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, Wloc), 1) + x0  # global x
    valid = (
        (ys >= w2) & (ys < H - w2)
        & (xs >= max(maxD, 0) + w2) & (xs < W_full - w2)
    )

    di0 = jax.lax.broadcasted_iota(jnp.int32, (D, 1, 1), 0)
    kmin = jnp.min(cost_c * D + (D - 1 - di0), axis=0)
    best_i = D - 1 - (kmin % D)
    best_cost = kmin // D

    texture = _box_filter_2d(
        jnp.abs(lp_ext.astype(jnp.int32) - cfg.pre_filter_cap), bs
    )[:, core]
    tex_ok = texture >= cfg.texture_threshold

    thresh = best_cost + (best_cost * cfg.uniqueness_ratio) // 100
    di = jax.lax.broadcasted_iota(jnp.int32, (D, 1, 1), 0)
    outside = jnp.abs(di - best_i[None]) > 1
    uniq_bad = jnp.any(outside & (cost_c <= thresh[None]), axis=0)

    BIGS = jnp.int32(2**30)
    c_p1 = jnp.min(jnp.where(di == best_i[None] + 1, cost_c, BIGS), axis=0)
    c_m1 = jnp.min(jnp.where(di == best_i[None] - 1, cost_c, BIGS), axis=0)
    c_m1 = jnp.where(best_i == 0, c_p1, c_m1)
    c_p1 = jnp.where(best_i == D - 1, c_m1, c_p1)
    p, n = c_m1, c_p1
    denom = p + n - 2 * best_cost + jnp.abs(p - n)
    num = (p - n) * 256
    delta = jnp.where(
        denom != 0, jnp.sign(num) * (jnp.abs(num) // jnp.maximum(denom, 1)), 0
    )
    packed = ((best_i + minD) * 256 + delta + 15) >> 4
    disp = jnp.where(valid & tex_ok & ~uniq_bad, packed, INVALID).astype(jnp.int16)
    return disp, best_cost


def bm_tile_program(
    lp_loc: jnp.ndarray,
    rp_loc: jnp.ndarray,
    cfg: MatcherConfig,
    W_full: int,
    space_axis: str,
) -> jnp.ndarray:
    """The per-device tile program, callable inside any shard_map over
    `space_axis`: halo exchange -> local cost/WTA -> gathered global
    postprocessing. lp/rp_loc: (H, Wloc) prefiltered tiles. Returns the full
    (H, W_full) disparity, replicated along the space axis."""
    D = cfg.num_disparities
    minD = cfg.min_disparity
    maxD = minD + D - 1
    bs = cfg.block_size
    w2 = bs // 2
    INVALID = (minD - 1) * DISP_SCALE
    Wloc = lp_loc.shape[1]

    idx = jax.lax.axis_index(space_axis)
    x0 = idx * Wloc
    # halo exchange with the neighbor tiles
    lp_ext = jnp.concatenate(
        [
            _halo_from_left(lp_loc, w2, space_axis),
            lp_loc,
            _halo_from_right(lp_loc, w2, space_axis),
        ],
        axis=1,
    )
    rp_ext = jnp.concatenate(
        [
            _halo_from_left(rp_loc, maxD + w2, space_axis),
            rp_loc,
            _halo_from_right(rp_loc, w2, space_axis),
        ],
        axis=1,
    )
    cost = _tile_cost_volume(lp_ext, rp_ext, D, minD, bs, maxD)
    disp_t, cost_t = _tile_wta(cost, lp_ext, cfg, x0, W_full)
    # global postprocessing on gathered tiles (replicated)
    disp_full = jax.lax.all_gather(disp_t, space_axis, axis=1, tiled=True)
    cost_full = jax.lax.all_gather(cost_t, space_axis, axis=1, tiled=True)
    if cfg.disp12_max_diff >= 0:
        disp_full = _lr_check(
            disp_full, cost_full, minD, D, cfg.disp12_max_diff,
        )
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp_full = filter_speckles(
            disp_full, INVALID, cfg.speckle_window_size,
            cfg.speckle_range * DISP_SCALE,
        )
    return disp_full


def tiled_stereo_bm(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
) -> jnp.ndarray:
    """Single-frame width-tiled StereoBM over `mesh`; bit-identical to
    ops.bm.stereo_bm (full-frame ROI). Returns the full (H, W) int16 map,
    replicated across the space axis."""
    H, W = left.shape
    n_space = mesh.shape[space_axis]
    assert W % n_space == 0, (W, n_space)
    Wloc = W // n_space
    D = cfg.num_disparities
    minD = cfg.min_disparity
    maxD = minD + D - 1
    bs = cfg.block_size
    w2 = bs // 2
    if Wloc < maxD + w2:
        raise ValueError(
            f"tile width {Wloc} < halo {maxD + w2}; use fewer space shards"
        )
    INVALID = (minD - 1) * DISP_SCALE

    lp = xsobel_prefilter(left, cfg.pre_filter_cap)
    rp = xsobel_prefilter(right, cfg.pre_filter_cap)

    def local(lp_loc, rp_loc):
        return bm_tile_program(lp_loc, rp_loc, cfg, W, space_axis)

    other_axes = tuple(a for a in mesh.axis_names if a != space_axis)
    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, space_axis), P(None, space_axis)),
        out_specs=P(None, None),
        check_vma=False,
    )
    del other_axes
    return fn(lp, rp)
