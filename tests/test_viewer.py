"""Runtime-adjustment (-a) callback path, driven headlessly.

The live cv2 windows need a display, but the trackbar -> engine wiring
(reference create_adjustment_track_bars, estimator.cpp:294-304) is testable
without one: AdjustState owns the six named trackbar values and pushes them
into Engine.set_hsv_thresholds, and the detection output must follow the
new thresholds WITHOUT recompiling (they enter the jitted program as traced
scalars).
"""

import numpy as np
import pytest

from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.pipeline import Engine
from rt_depth_map.sources import SyntheticStereoSource
from rt_depth_map.utils.viewer import TRACKBARS, AdjustState


@pytest.fixture(scope="module")
def engine():
    W, H = 128, 96
    cfg = EngineConfig(
        width=W, height=H, number_of_disparities=16, minimal_object_size=10,
        matcher=MatcherConfig(num_disparities=16, block_size=9),
    )
    src = SyntheticStereoSource(W, H, seed=1, num_objects=1)
    return Engine(cfg, source=src)


def test_trackbar_names_match_reference():
    labels = [t[0] for t in TRACKBARS]
    assert labels == [
        "hue low", "hue high", "saturation low", "saturation high",
        "value low", "value high",
    ]


def test_adjuststate_updates_engine_thresholds(engine):
    st = AdjustState(engine)
    # reference defaults: iLowH=0 iHighH=9 iLowS=150 (estimator.cpp:108-113)
    assert st.get("hue high") == engine.hsv_high[0]
    st.set("saturation low", 42)
    assert engine.hsv_low[1] == 42
    st.set("hue high", 200)
    assert engine.hsv_high[0] == 200
    with pytest.raises(KeyError):
        st.set("bogus", 1)


def test_adjustment_changes_detection_without_recompile(engine):
    left, right = engine.source.render(0)[:2]
    st = AdjustState(engine)

    r1 = engine.process_pair(left, right)
    assert r1.has_objects  # synthetic object matches the default color range

    # close the V range to something nothing satisfies -> no detections
    st.set("value low", 255)
    r2 = engine.process_pair(left, right)
    assert not r2.has_objects

    st.set("value low", 0)
    r3 = engine.process_pair(left, right)
    assert r3.has_objects
    np.testing.assert_array_equal(r3.boxes, r1.boxes)

    # traced scalars: all three ran the same compiled program
    compiled = engine._step._cache_size()
    assert compiled == 1
