"""The multi-chip frame step: DP over streams x TP over image width.

The production sharding layout (SURVEY.md section 2.10):
  * "data" axis: independent camera streams / frame batches -- each device
    group processes its own frames (the reference is a single stream; here N
    hosts each feed their own rigs).
  * "space" axis: image-width tiles inside the matcher, with ppermute halo
    exchange (parallel/tiled_bm.py) -- the hot cost volume scales across
    chips while elementwise stages (gray/HSV/morph) are auto-partitioned by
    XLA over the data axis.

`make_sharded_step` builds ONE jitted program over the mesh doing the full
per-frame pipeline of pipeline/engine.py on a batch of stereo pairs. The
detection/reprojection stages run data-sharded on gathered full-width frames
(they are global ops and tiny next to the cost volume).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rt_depth_map.config import EngineConfig
from rt_depth_map.ops import (
    ellipse_kernel,
    in_range,
    morph_open_close,
    remap_bilinear,
    rgb_to_gray,
    rgb_to_hsv,
)
from rt_depth_map.ops.detect import detect_objects
from rt_depth_map.ops.prefilter import xsobel_prefilter
from rt_depth_map.ops.reproject import (
    calc_depth,
    disparity_fixed_to_float,
    reproject_to_3d,
)
from rt_depth_map.parallel.tiled_bm import bm_tile_program
from rt_depth_map.parallel.tiled_sgbm import sgbm_tile_program

MORPH_DX = MORPH_DY = 10


def _map_frames(fn, *arrays):
    """Per-frame map as a static python loop + stack."""
    B = arrays[0].shape[0]
    outs = [fn(*(a[i] for a in arrays)) for i in range(B)]
    if isinstance(outs[0], (tuple, list)):
        return tuple(
            jnp.stack([o[j] for o in outs]) for j in range(len(outs[0]))
        )
    return jnp.stack(outs)


def make_sharded_step(
    mesh: Mesh,
    cfg: EngineConfig,
    image_size: Tuple[int, int],
    Q: Optional[np.ndarray] = None,
    remap_grid: Optional[np.ndarray] = None,
) -> Callable:
    """Returns jitted step(left_rgb, right_rgb) for (B, H, W, 3) uint8
    batches, B divisible by mesh.shape['data']. Outputs: dict with the
    (B, H, W) disparity, per-frame boxes and depth stats."""
    W, H = image_size
    mcfg = cfg.matcher
    grid = (
        jnp.asarray(remap_grid)
        if remap_grid is not None
        else None
    )
    Qc = jnp.asarray(
        Q
        if Q is not None
        else np.diag([1.0, 1.0, 1.0, 1.0]), jnp.float32
    )
    kernel = ellipse_kernel(MORPH_DX, MORPH_DY)
    hsv = cfg.hsv_range()
    hsv_low = jnp.asarray(hsv.low, jnp.uint8)
    hsv_high = jnp.asarray(hsv.high, jnp.uint8)
    min_size = cfg.scaled_min_object_size(W, H)

    data_sharding = NamedSharding(mesh, P("data", None, None, None))

    def matcher_tiles(lp, rp):
        """(B, H, W) inputs, space-sharded inside: prefiltered planes for
        BM, raw rectified gray for SGM (stereo_sgbm does its own BT
        preprocessing per tile). The matcher slot is swappable exactly like
        the reference's BlockMatcher wiring (stereo-matcher.h:13-19,
        main.cpp:128-136): cfg.matcher.kind selects the tile program."""

        def local(lp_loc, rp_loc):  # (Bloc, H, Wloc)
            if mcfg.kind == "sgm":
                if getattr(mcfg, "tile_mode", "margin") == "exact":
                    from rt_depth_map.parallel.exact_sgbm import (
                        exact_sgbm_tile_program,
                    )

                    return _map_frames(
                        lambda a, b: exact_sgbm_tile_program(
                            a, b, mcfg, "space"
                        ), lp_loc, rp_loc)
                return _map_frames(
                    lambda a, b: sgbm_tile_program(a, b, mcfg, W, "space"),
                    lp_loc, rp_loc)
            return _map_frames(
                lambda a, b: bm_tile_program(a, b, mcfg, W, "space"),
                lp_loc, rp_loc)

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("data", None, "space"), P("data", None, "space")),
            out_specs=P("data", None, None),
            check_vma=False,
        )(lp, rp)

    def per_frame_tail(rgbr, disp):
        mask = in_range(rgb_to_hsv(rgbr), hsv_low, hsv_high)
        filt = morph_open_close(mask, kernel)
        boxes = detect_objects(filt, min_size, cfg.max_objects)
        dint = disparity_fixed_to_float(disp)
        xyz = reproject_to_3d(dint, Qc, mcfg.min_disparity, True)
        depth_cm, mean_z, count = calc_depth(
            xyz, filt, boxes, cfg.calibration_unit_mm
        )
        return boxes, depth_cm, mean_z, count, filt

    def step(left_rgb, right_rgb):
        lg = rgb_to_gray(left_rgb)
        rg = rgb_to_gray(right_rgb)
        rgbr = left_rgb
        if grid is not None:
            # left gray + RGB share one map -> one packed 4-channel gather
            # (same trick as pipeline/engine.py frame_fn)
            lstack = jnp.concatenate([lg[..., None], left_rgb], axis=-1)
            l4 = jax.vmap(lambda x: remap_bilinear(x, grid))(lstack)
            lg, rgbr = l4[..., 0], l4[..., 1:]
            rg = jax.vmap(lambda x: remap_bilinear(x, grid))(rg)
        if mcfg.kind == "sgm":
            disp = matcher_tiles(lg, rg)
        else:
            lp = jax.vmap(
                lambda x: xsobel_prefilter(x, mcfg.pre_filter_cap)
            )(lg)
            rp = jax.vmap(
                lambda x: xsobel_prefilter(x, mcfg.pre_filter_cap)
            )(rg)
            disp = matcher_tiles(lp, rp)
        boxes, depth_cm, mean_z, count, filt = _map_frames(
            per_frame_tail, rgbr, disp
        )
        return dict(
            disparity=disp,
            boxes=boxes,
            depth_cm=depth_cm,
            mean_z=mean_z,
            count=count,
            mask=filt,
        )

    jitted = jax.jit(step, in_shardings=(data_sharding, data_sharding))
    return jitted, data_sharding
