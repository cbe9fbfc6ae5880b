"""Full-chain depth-LABEL oracle.

Composes the cv2 reference pipeline END TO END on a real `backup/`
calibration -- remap with CV_16SC2 fixed-point maps -> HSV threshold ->
10x10-ellipse open/close -> findContours boxes -> StereoBM with the
per-frame union-box ROI -> /16 -> reprojectImageTo3D(handleMissingValues)
-> masked mean Z per box (estimator.cpp:75-77, 206-263) -- and compares
the final CENTIMETER LABELS and boxes against the engine's FrameResult
on the same frames.

Tolerance justification (docstring requirement): every per-stage parity
is already bit-level or +/-1-LSB (remap +/-1 LSB, tests/test_ops_image);
a 1-LSB flip at an HSV threshold boundary can move a mask edge by one
pixel, shifting a box edge and the set of ~10^2-10^3 pixels averaged, so
labels can differ by a few mm. Boxes are asserted within +/-2 px and
labels within max(0.5 cm, 1%) -- an order of magnitude tighter than the
25 mm calibration unit the labels quantize against in the reference UI.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rt_depth_map.calib import compute_rectification  # noqa: E402
from rt_depth_map.config import EngineConfig, MatcherConfig  # noqa: E402
from rt_depth_map.pipeline import Engine  # noqa: E402
from rt_depth_map.sources import SyntheticStereoSource  # noqa: E402

CAL = "/root/reference/backup/320x240"
FLT_EPS = np.float32(1.1920929e-07)


def _fs_read(path, keys):
    # the repo's FileStorage reader (validated against all backup/ sets in
    # tests/test_calib.py); cv2 5.0's own FileStorage rejects the legacy
    # %YAML:1.0 files. cv2 remains the computational oracle below.
    from rt_depth_map.calib.fs_yaml import read_filestorage

    data = read_filestorage(path)
    return {k: np.asarray(data[k]) for k in keys}


def cv2_full_chain(left_rgb, right_rgb, eng, W, H):
    """The reference pipeline, straight cv2/numpy (main.cpp:53-98 +
    estimator.cpp:18-82, 206-263)."""
    intr = _fs_read(f"{CAL}/intrinsics.yml", ["M1", "D1", "M2", "D2"])
    extr = _fs_read(f"{CAL}/extrinsics.yml", ["R", "T", "ROI1", "ROI2"])
    roi1 = extr["ROI1"].ravel().astype(int)
    roi2 = extr["ROI2"].ravel().astype(int)
    # main.cpp:80-85: intersect origins, min of sizes
    rx, ry = max(roi1[0], roi2[0]), max(roi1[1], roi2[1])
    rw, rh = min(roi1[2], roi2[2]), min(roi1[3], roi2[3])
    R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(
        intr["M1"], intr["D1"], intr["M2"], intr["D2"], (W, H),
        extr["R"], extr["T"], flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1)
    m1l, m2l = cv2.initUndistortRectifyMap(
        intr["M1"], intr["D1"], R1, P1, (W, H), cv2.CV_16SC2)
    m1r, m2r = cv2.initUndistortRectifyMap(
        intr["M2"], intr["D2"], R2, P2, (W, H), cv2.CV_16SC2)

    def crop(a):
        return a[ry : ry + rh, rx : rx + rw]

    lg = cv2.cvtColor(left_rgb, cv2.COLOR_RGB2GRAY)
    rg = cv2.cvtColor(right_rgb, cv2.COLOR_RGB2GRAY)
    lrect = crop(cv2.remap(lg, m1l, m2l, cv2.INTER_LINEAR))
    rrect = crop(cv2.remap(rg, m1r, m2r, cv2.INTER_LINEAR))
    rgb_rect = crop(cv2.remap(left_rgb, m1l, m2l, cv2.INTER_LINEAR))

    hsv = cv2.cvtColor(rgb_rect, cv2.COLOR_RGB2HSV)
    mask = cv2.inRange(hsv, eng.hsv_low, eng.hsv_high)
    k = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (10, 10))
    filt = cv2.erode(cv2.dilate(cv2.dilate(cv2.erode(mask, k), k), k), k)

    contours, _ = cv2.findContours(filt, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    boxes = [cv2.boundingRect(c) for c in contours]
    boxes = [b for b in boxes if b[2] * b[3] >= eng.min_object_size]
    boxes.sort(key=lambda b: (b[1], b[0]))  # raster order of top-left

    D = eng.num_disparities
    bm = cv2.StereoBM_create(D, 13)
    bm.setPreFilterCap(31)
    bm.setTextureThreshold(10)
    bm.setUniquenessRatio(10)
    bm.setSpeckleWindowSize(100)
    bm.setSpeckleRange(32)
    bm.setDisp12MaxDiff(1)
    if boxes:
        ux = min(b[0] for b in boxes)
        uy = min(b[1] for b in boxes)
        ux2 = max(b[0] + b[2] for b in boxes)
        uy2 = max(b[1] + b[3] for b in boxes)
        bm.setROI1((ux, uy, ux2 - ux, uy2 - uy))  # ROI2 left unset (FIXME
        # parity, estimator.cpp:55)
    disp = bm.compute(lrect, rrect)
    dint = np.round(disp.astype(np.float64) / 16.0).astype(np.int16)
    xyz = cv2.reprojectImageTo3D(dint.astype(np.float32), Q,
                                 handleMissingValues=True)

    unit = eng.cfg.calibration_unit_mm
    labels = []
    for (bx, by, bw, bh) in boxes:
        Z = xyz[by : by + bh, bx : bx + bw, 2]
        m = filt[by : by + bh, bx : bx + bw] != 0
        ok = m & (np.abs(Z - 10000.0) >= FLT_EPS) & (np.abs(Z) <= 1.0e4)
        cnt = int(ok.sum())
        mean = float(Z[ok].mean()) if cnt else float("nan")
        labels.append(mean * unit / 10.0)
    return boxes, labels


def _to_raw(rendered, grid):
    """Inverse-warp a rendered RECTIFIED view into raw camera space so
    that remapping with the real calibration recovers it: the synthetic
    scene is rendered on the rectified grid (purely horizontal
    disparity), and feeding it to the maps directly would destroy the
    epipolar alignment. Scatter rendered[v, u] to the map's source pixel
    (nearest); unscattered pixels keep the rendered value (close enough:
    the maps are near-identity at this RMS, and BOTH chains consume the
    identical raw image, so parity is unaffected by fill quality)."""
    H, W = rendered.shape[:2]
    raw = rendered.copy()
    mx = np.clip(np.round(grid[..., 0]).astype(int), 0, W - 1)
    my = np.clip(np.round(grid[..., 1]).astype(int), 0, H - 1)
    raw[my.ravel(), mx.ravel()] = rendered.reshape(-1, 3)
    return raw


def test_depth_labels_match_cv2_full_chain():
    W, H = 320, 240
    mcfg = MatcherConfig(kind="bm", block_size=13, backend="xla")
    cfg = EngineConfig(width=W, height=H, number_of_disparities=64,
                       matcher=mcfg)
    rect = compute_rectification(f"{CAL}/intrinsics.yml",
                                 f"{CAL}/extrinsics.yml", (W, H))
    src = SyntheticStereoSource(W, H, seed=11)
    src.rectified = False  # engine must apply the real calibration maps
    eng = Engine(cfg, rectification=rect, source=src)

    checked_boxes = 0
    for i in range(3):
        rl_, rr_ = src.render(i)[:2]
        left = _to_raw(rl_, eng.map_left)
        right = _to_raw(rr_, eng.map_right)
        res = eng.process_pair(left, right)
        ref_boxes, ref_labels = cv2_full_chain(left, right, eng, W, H)

        got = res.boxes[res.boxes[:, 4] > 0]
        assert len(got) == len(ref_boxes), (
            f"frame {i}: {len(got)} boxes vs cv2 {len(ref_boxes)}")
        for b, (rb, rl) in zip(got, zip(ref_boxes, ref_labels)):
            np.testing.assert_allclose(b[:4], rb, atol=2,
                                       err_msg=f"frame {i} box {rb}")
        valid = ~np.isnan(res.depth_cm[: len(ref_boxes)])
        for j, rl in enumerate(ref_labels):
            if np.isnan(rl):
                continue
            assert valid[j], f"frame {i} box {j}: engine label NaN, cv2 {rl}"
            dl = float(res.depth_cm[j])
            assert abs(dl - rl) <= max(0.5, 0.01 * abs(rl)), (
                f"frame {i} box {j}: {dl:.2f} cm vs cv2 {rl:.2f} cm")
            checked_boxes += 1
    assert checked_boxes >= 3, "oracle exercised too few labeled boxes"
