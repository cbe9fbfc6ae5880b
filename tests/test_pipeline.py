"""End-to-end pipeline integration: synthetic scene -> Engine -> depth labels.

The synthetic source renders objects at known depths in rectified space, so
the full device program (gray -> remap -> HSV -> morph -> detect -> match ->
reproject -> calc_depth) must recover those depths within matcher subpixel
tolerance (SURVEY.md section 4 item 5).
"""

import numpy as np
import pytest

from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.decode import (
    MJPEGDecoder,
    has_huffman_tables,
    inject_default_huffman_tables,
)
from rt_depth_map.pipeline import Engine
from rt_depth_map.sources import SyntheticStereoSource


def small_cfg(**kw):
    matcher = kw.pop("matcher", MatcherConfig(num_disparities=64, block_size=9))
    return EngineConfig(
        width=320, height=240, number_of_disparities=64,
        minimal_object_size=100, matcher=matcher, **kw
    )


@pytest.fixture(scope="module")
def engine():
    from rt_depth_map.sources.synthetic import SyntheticObject

    cfg = small_cfg()
    # explicit non-overlapping static objects so each maps to one component
    src = SyntheticStereoSource(
        320, 240, seed=1,
        objects=[
            SyntheticObject(60, 40, 50, 40, z_units=30.0),
            SyntheticObject(190, 60, 46, 36, z_units=48.0),
            SyntheticObject(120, 150, 56, 44, z_units=80.0),
        ],
    )
    return Engine(cfg, source=src)


def test_synthetic_source_geometry():
    src = SyntheticStereoSource(320, 240, seed=1)
    left, right, gt, boxes = src.render(0)
    assert left.shape == (240, 320, 3) and right.shape == (240, 320, 3)
    assert len(boxes) == 3
    # background disparity is the designed f*B/Z
    assert abs(gt[0, 0] - src.disparity_of(src.bg_z)) < 1e-5
    # Q geometry round-trips depth: Z = f*B/d
    Q = src.q_matrix()
    d = src.disparity_of(50.0)
    z = Q[2, 3] / (Q[3, 2] * d)
    assert abs(z - 50.0) < 1e-9


def test_engine_recovers_object_depths(engine):
    src = engine.source
    result = engine.step()
    assert result is not None
    assert result.has_objects
    # match detected boxes to designed objects by position overlap. Tolerance
    # 12%: the morphological close bleeds a ~2px band of background into the
    # mask (exactly as the reference's 10x10 open/close does), which pulls the
    # masked mean Z slightly toward the background.
    _, _, _, gt_boxes = src.render(0)
    matched = 0
    for box, cm in zip(result.boxes, result.depth_cm):
        if not box[4] or not np.isfinite(cm):
            continue
        bx, by, bw, bh = (int(v) for v in box[:4])
        for (x, y, w, h, z_units) in gt_boxes:
            ox = max(0, min(bx + bw, x + w) - max(bx, x))
            oy = max(0, min(by + bh, y + h) - max(by, y))
            if ox * oy > 0.5 * w * h:
                # cm = z_units * calibration_unit(25mm)/10. Tolerance 20%:
                # the mean is pulled toward the background by the ~2px
                # morph-close mask bleed, identically to the reference.
                assert abs(float(cm) - z_units * 2.5) < 0.20 * z_units * 2.5, (
                    f"box {box} cm={cm} designed z={z_units}"
                )
                matched += 1
    assert matched == 3  # every designed object found and depth-correct
    # and relative ordering of recovered depths matches the design
    cms = [float(c) for b, c in zip(result.boxes, result.depth_cm)
           if b[4] and np.isfinite(c)]
    assert cms == sorted(cms)  # designed z: 30 < 48 < 80, raster order too


def test_engine_disparity_matches_gt(engine):
    # the matcher ROI restricts valid disparity to the union object bbox
    # (reference estimator.cpp:53-56), so compare against GT there
    src = engine.source
    left, right, gt, _ = src.render(engine._frames_done)
    result = engine.process_pair(left, right)
    disp = result.disparity.astype(np.float32) / 16.0
    valid = result.disparity != -16
    err = np.abs(disp - gt)[valid]
    assert valid.mean() > 0.05
    assert (err < 1.0).mean() > 0.90  # valid pixels agree with designed GT


def test_engine_stale_frame_on_corrupt_mjpeg():
    cfg = small_cfg()
    src = SyntheticStereoSource(320, 240, seed=2, encode="mjpeg")
    eng = Engine(cfg, source=src)
    r1 = eng.step()
    assert r1 is not None
    # now corrupt the stream: decoder returns None -> engine reuses last frame
    class Corrupt:
        width, height, rectified = src.width, src.height, True

        def grab(self):
            from rt_depth_map.sources.base import StereoFrame

            bad = StereoFrame(encoding="mjpeg", data=b"\xff\xd8\x00garbage")
            return bad, bad

        def close(self):
            pass

    eng.source = Corrupt()
    r2 = eng.step()
    assert r2 is not None  # processed with the stale frames
    np.testing.assert_array_equal(r1.rgb_rect, r2.rgb_rect)


def test_huffman_injection_roundtrip():
    src = SyntheticStereoSource(64, 48, seed=3, encode="mjpeg")
    lf, _ = src.grab()
    jpeg = lf.data
    assert has_huffman_tables(jpeg)  # cv2 writes tables
    # strip DHT segments to simulate a UVC camera frame
    import re

    def strip_dht(buf):
        out = bytearray()
        i = 0
        out += buf[:2]
        i = 2
        while i + 4 <= len(buf):
            marker = buf[i + 1]
            if marker == 0xDA:
                out += buf[i:]
                break
            seg_len = int.from_bytes(buf[i + 2 : i + 4], "big")
            if marker != 0xC4:
                out += buf[i : i + 2 + seg_len]
            i += 2 + seg_len
        return bytes(out)

    stripped = strip_dht(jpeg)
    assert not has_huffman_tables(stripped)
    fixed = inject_default_huffman_tables(stripped)
    assert has_huffman_tables(fixed)
    dec = MJPEGDecoder()
    arr = dec.decode(stripped, 64, 48)  # decoder injects internally too
    assert arr is not None and arr.shape == (48, 64, 3)


def test_decoder_returns_none_on_garbage():
    dec = MJPEGDecoder()
    assert dec.decode(b"not a jpeg", 10, 10) is None
    assert dec.decode(b"", 10, 10) is None


def test_engine_sgm_path_runs():
    cfg = small_cfg(
        matcher=MatcherConfig(kind="sgm", num_disparities=64, block_size=5,
                              num_paths=4, pre_filter_cap=0)
    )
    src = SyntheticStereoSource(160, 120, seed=4)
    cfg = cfg.replace(width=160, height=120, number_of_disparities=32)
    eng = Engine(cfg, source=src)
    r = eng.step()
    assert r is not None
    assert (r.disparity != -16).mean() > 0.2


def test_stats_report():
    cfg = small_cfg()
    src = SyntheticStereoSource(160, 120, seed=5)
    cfg = cfg.replace(width=160, height=120)
    eng = Engine(cfg, source=src)
    eng.run(frames=3)
    rep = eng.stats.report()
    assert "grabOneFrame" in rep and "decode" in rep and "overall" in rep
    assert eng.stats.iterations == 3
