"""Width-tiled semi-global matching over a device mesh.

SGM's directional scans are global recurrences (the "long sequence" analog,
SURVEY.md section 5.7), so exact tiling would serialize chips along each
scan direction. Production SGM tilings instead use overlapped tiles: the
P2 cap (delta = min_k L + P2) bounds how far a path's influence travels, so
an overlap margin of a few dozen columns makes tile-local aggregation
match the global result except on a vanishing set of pixels -- the
approximation budget is the judged <=1% bad-pixel bound (BASELINE.md), and
tests hold it to ~0.1%.

Each device holds columns [x0, x0 + Wloc) of the rectified pair and fetches
  * margin + maxD + 2 left-halo columns (margin for path convergence, maxD
    so its leftmost outputs can see their full disparity search window, 2
    for the BT/Sobel stencils), and
  * margin + 2 right-halo columns
from its neighbors with one `ppermute` hop each way, runs the FULL
single-device stereo_sgbm on the extended tile (minus the global speckle
pass), crops its core columns, `all_gather`s the disparity, and runs
speckle replicated -- identical structure to parallel/tiled_bm.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import DISP_SCALE, stereo_sgbm
from rt_depth_map.ops.speckle import filter_speckles
from rt_depth_map.parallel.tiled_bm import _halo_from_left, _halo_from_right


def sgbm_tile_program(
    left_loc: jnp.ndarray,
    right_loc: jnp.ndarray,
    cfg: MatcherConfig,
    W_full: int,
    space_axis: str,
    margin: int = 64,
) -> jnp.ndarray:
    """Per-device tile program (callable inside any shard_map over
    `space_axis`). left/right_loc: (H, Wloc) uint8 tiles. Returns the full
    (H, W_full) int16 disparity, replicated along the space axis."""
    H, Wloc = left_loc.shape
    maxD = cfg.min_disparity + cfg.num_disparities - 1
    hl = margin + max(maxD, 0) + 2
    hr = margin + 2
    if Wloc < max(hl, hr):
        raise ValueError(
            f"tile width {Wloc} < halo {max(hl, hr)}; use fewer space shards "
            f"or a smaller margin"
        )
    INVALID = (cfg.min_disparity - 1) * DISP_SCALE

    idx = jax.lax.axis_index(space_axis)
    n = jax.lax.axis_size(space_axis)

    def extend(img):
        return jnp.concatenate(
            [
                _halo_from_left(img, hl, space_axis),
                img,
                _halo_from_right(img, hr, space_axis),
            ],
            axis=1,
        )

    le = extend(left_loc)
    re = extend(right_loc)

    local_cfg = cfg.replace(speckle_window_size=0)  # speckle is global
    disp_ext = stereo_sgbm(le, re, local_cfg)
    core = disp_ext[:, hl : hl + Wloc]

    # Re-impose the GLOBAL computed-x restriction: the single-device matcher
    # leaves x < maxD invalid (minX1), but tile 0's extended coordinates
    # shift that bound into its (zero-filled) halo, so its first maxD core
    # columns would otherwise be computed from garbage. The rightmost tile's
    # last two columns saw a zero halo instead of the true border stencil --
    # invalidate them (2 columns of budgeted divergence).
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, Wloc), 1) + idx * Wloc
    core = jnp.where(xs < max(maxD, 0), jnp.int16(INVALID), core)
    core = jnp.where(
        (idx == n - 1) & (xs >= W_full - 2), jnp.int16(INVALID), core
    )

    disp_full = jax.lax.all_gather(core, space_axis, axis=1, tiled=True)
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp_full = filter_speckles(
            disp_full, INVALID, cfg.speckle_window_size,
            cfg.speckle_range * DISP_SCALE,
        )
    return disp_full


def tiled_stereo_sgbm(
    left: jnp.ndarray,
    right: jnp.ndarray,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
    margin: int = 64,
) -> jnp.ndarray:
    """Single-frame width-tiled StereoSGBM over `mesh`. Near-exact vs
    ops.sgbm.stereo_sgbm (overlap approximation, see module docstring)."""
    H, W = left.shape
    n_space = mesh.shape[space_axis]
    if W % n_space:
        raise ValueError((W, n_space))

    def local(l_loc, r_loc):
        return sgbm_tile_program(l_loc, r_loc, cfg, W, space_axis, margin)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, space_axis), P(None, space_axis)),
        out_specs=P(None, None),
        check_vma=False,
    )
    return fn(left, right)
