"""Engine.step_batch parity: each batched frame must equal Engine.step."""

import numpy as np
import pytest

from rt_depth_map.calib import RectificationResult
from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.pipeline import Engine
from rt_depth_map.sources import SyntheticStereoSource


@pytest.mark.parametrize("kind", ["bm", "sgm"])
def test_step_batch_matches_step(kind):
    W, H, B = 192, 64, 2
    mcfg = MatcherConfig(
        kind=kind, num_disparities=32, block_size=9 if kind == "bm" else 5,
        speckle_window_size=20, speckle_range=32, disp12_max_diff=1,
    )
    src = SyntheticStereoSource(W, H, seed=3)
    cfg = EngineConfig(width=W, height=H, number_of_disparities=32,
                       matcher=mcfg, batch=B)
    eng = Engine(cfg, source=src)
    ref_eng = Engine(cfg.replace(batch=1), source=SyntheticStereoSource(
        W, H, seed=3))

    frames = [src.render(i)[:2] for i in range(B)]
    out = eng._step_batch(
        np.stack([f[0] for f in frames]),
        np.stack([f[1] for f in frames]),
        np.asarray(eng.hsv_low), np.asarray(eng.hsv_high),
        np.int32(eng.min_object_size),
    )
    # pipelined multi-stream mode (the production default): B independent
    # single-frame dispatches -- must agree with both the fused batch
    # program and the per-frame reference
    assert eng.batch_mode == "pipelined"
    piped = eng.process_batch(
        np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])
    )
    for b in range(B):
        ref = ref_eng._step(
            frames[b][0], frames[b][1],
            np.asarray(eng.hsv_low), np.asarray(eng.hsv_high),
            np.int32(eng.min_object_size),
        )
        for key in ("disparity", "depth_cm", "count", "boxes"):
            np.testing.assert_array_equal(
                np.asarray(out[key][b]), np.asarray(ref[key]),
                err_msg=f"{kind} frame {b} key {key}",
            )
            np.testing.assert_array_equal(
                np.asarray(getattr(piped[b], key)), np.asarray(ref[key]),
                err_msg=f"{kind} pipelined frame {b} key {key}",
            )


def test_step_batch_out_of_image_maps():
    """Fused-batch row-stacked remap with a calibration whose maps sample
    OUTSIDE the frame: without per-frame border handling, frame b's
    edge-straddling bilinear windows would sample frame b+/-1's edge rows
    of the stacked source (advisor round-4 medium finding). The guard-row
    + per-frame validity fix must keep every batched frame bit-identical
    to the single-frame path."""
    W, H, B = 192, 64, 3
    mcfg = MatcherConfig(kind="bm", num_disparities=32, block_size=9,
                         speckle_window_size=20, speckle_range=32,
                         disp12_max_diff=1)
    cfg = EngineConfig(width=W, height=H, number_of_disparities=32,
                       matcher=mcfg, batch=B)

    # map whose source y spans [-4, H+4): the top rows are fully outside
    # (invalid), the rows near y=0 and y=H-1 straddle the frame border
    # (partial bilinear windows), plus a fractional x shear
    oy, ox = np.mgrid[0:H, 0:W].astype(np.float32)
    my = oy * (H + 8.0) / H - 4.0
    mx = ox + 0.3
    grid = np.stack([mx, my], axis=-1).astype(np.float32)
    rect = RectificationResult(
        map_left=grid, map_right=grid.copy(),
        Q=np.asarray(np.diag([1.0, 1.0, 1.0, 1.0]), np.float64),
        roi=(0, 0, W, H), image_size=(W, H), rectify=None,
    )

    def make(batch):
        src = SyntheticStereoSource(W, H, seed=5)
        src.rectified = False  # engine must apply the custom maps
        return Engine(cfg.replace(batch=batch), rectification=rect,
                      source=src)

    eng = make(B)
    ref_eng = make(1)
    src = SyntheticStereoSource(W, H, seed=5)
    frames = [src.render(i)[:2] for i in range(B)]
    out = eng._step_batch(
        np.stack([f[0] for f in frames]),
        np.stack([f[1] for f in frames]),
        np.asarray(eng.hsv_low), np.asarray(eng.hsv_high),
        np.int32(eng.min_object_size),
    )
    for b in range(B):
        ref = ref_eng._step(
            frames[b][0], frames[b][1],
            np.asarray(eng.hsv_low), np.asarray(eng.hsv_high),
            np.int32(eng.min_object_size),
        )
        for key in ("disparity", "depth_cm", "count", "boxes"):
            np.testing.assert_array_equal(
                np.asarray(out[key][b]), np.asarray(ref[key]),
                err_msg=f"oob-map frame {b} key {key}",
            )
