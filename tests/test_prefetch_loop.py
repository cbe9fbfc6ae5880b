"""The prefetch-threaded frame loop (engine.run host-ingest path).

Round-4 ingest redesign: grab+decode run in a background producer with a
bounded queue (SURVEY.md section 7 hard part 6). These tests pin the
loop's contract: same frames processed as the serial loop, source
failures propagate to the caller instead of dying in the thread, and the
producer shuts down with the loop.
"""

import threading

import numpy as np
import pytest

from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.pipeline import Engine
from rt_depth_map.sources import SyntheticStereoSource


def _engine(W=160, H=64, **src_kw):
    cfg = EngineConfig(
        width=W, height=H, number_of_disparities=16,
        matcher=MatcherConfig(kind="bm", num_disparities=16, block_size=9),
    )
    src = SyntheticStereoSource(W, H, seed=5, **src_kw)
    return Engine(cfg, source=src)


def test_prefetch_processes_requested_frames():
    eng = _engine(ring=4)
    seen = []
    n = eng.run(frames=6, on_frame=lambda i, r: seen.append(i),
                print_stats_on_sigint=False, prefetch=True)
    assert n == 6 and seen == list(range(6))
    eng.close()
    # producer thread exits with the loop
    assert not any(t.name == "rtdm-ingest" and t.is_alive()
                   for t in threading.enumerate())


def test_prefetch_matches_serial_loop_outputs():
    outs = {}
    for prefetch in (False, True):
        eng = _engine(ring=3)
        got = []
        eng.run(frames=3, on_frame=lambda i, r: got.append(r.disparity),
                print_stats_on_sigint=False, prefetch=prefetch)
        outs[prefetch] = got
        eng.close()
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_producer_failure_propagates():
    eng = _engine()

    def boom():
        raise RuntimeError("camera unplugged")

    eng.source.grab = boom
    with pytest.raises(RuntimeError, match="camera unplugged"):
        eng.run(frames=4, print_stats_on_sigint=False, prefetch=True)
    eng.close()
