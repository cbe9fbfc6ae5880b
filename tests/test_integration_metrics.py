"""End-to-end accuracy: the engine's disparity vs cv2 on the same frames.

The judged metric (BASELINE.md): bad-pixel fraction <= 1% against the
OpenCV-configured reference matchers, on deterministic synthetic sequences.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.metrics import disparity_report
from rt_depth_map.pipeline import Engine
from rt_depth_map.sources import SyntheticStereoSource


def run_engine(kind, src, W, H, D):
    if kind == "sgm":
        mcfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                             num_paths=4, pre_filter_cap=0, backend="xla")
    else:
        mcfg = MatcherConfig(kind="bm", num_disparities=D, block_size=13,
                             backend="xla")
    cfg = EngineConfig(width=W, height=H, number_of_disparities=D, matcher=mcfg)
    return Engine(cfg, source=src)


def cv_disp(kind, left, right, D):
    lg = cv2.cvtColor(left, cv2.COLOR_RGB2GRAY)
    rg = cv2.cvtColor(right, cv2.COLOR_RGB2GRAY)
    if kind == "sgm":
        m = cv2.StereoSGBM_create(0, D, 5)
        m.setP1(600)
        m.setP2(2400)
        m.setUniquenessRatio(10)
        m.setSpeckleWindowSize(100)
        m.setSpeckleRange(32)
        m.setDisp12MaxDiff(1)
        m.setPreFilterCap(0)
    else:
        m = cv2.StereoBM_create(D, 13)
        m.setPreFilterCap(31)
        m.setTextureThreshold(10)
        m.setUniquenessRatio(10)
        m.setSpeckleWindowSize(100)
        m.setSpeckleRange(32)
        m.setDisp12MaxDiff(1)
    return m.compute(lg, rg)


@pytest.mark.parametrize("kind", ["bm", "sgm"])
def test_engine_disparity_vs_cv2_budget(kind):
    W, H, D = 320, 240, 64
    src = SyntheticStereoSource(W, H, seed=7)
    eng = run_engine(kind, src, W, H, D)
    worst = 0.0
    for i in range(2):
        left, right, _, _ = src.render(i)
        result = eng.process_pair(left, right)
        ref = cv_disp(kind, left, right, D)
        if kind == "bm":
            # the engine restricts BM to the detected-object ROI
            # (reference estimator.cpp:53-56); compare inside it
            rep_mask = result.disparity != -16
            both = rep_mask & (ref != -16)
            if both.sum() == 0:
                continue
            bad = (np.abs(result.disparity.astype(int) - ref.astype(int)) > 16)
            frac = float((bad & both).sum() / both.sum())
        else:
            rep = disparity_report(result.disparity, ref)
            frac = rep["bad_pixel_fraction"]
        worst = max(worst, frac)
    assert worst <= 0.01, worst
