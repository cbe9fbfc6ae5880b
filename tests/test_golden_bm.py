"""Golden StereoBM vs cv2.StereoBM: exact (bit-for-bit) parity.

This pins the matcher semantics of SURVEY.md section 2.9a. The JAX/Pallas
matchers are separately tested for equality with the golden.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rt_depth_map.golden import (
    golden_filter_speckles,
    golden_stereo_bm,
    golden_validate_disparity,
)


def stereo_pair(seed, H, W, shift, smooth=True):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8)
    if smooth:
        base = cv2.GaussianBlur(base, (5, 5), 0)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


def cv_bm(left, right, ndisp, bs, **kw):
    bm = cv2.StereoBM_create(ndisp, bs)
    bm.setPreFilterCap(kw.get("cap", 31))
    bm.setMinDisparity(kw.get("mindisp", 0))
    bm.setTextureThreshold(kw.get("tex", 0))
    bm.setUniquenessRatio(kw.get("uniq", 0))
    bm.setSpeckleWindowSize(kw.get("spk", 0))
    bm.setSpeckleRange(kw.get("spkr", 0))
    bm.setDisp12MaxDiff(kw.get("d12", -1))
    if "roi1" in kw:
        bm.setROI1(kw["roi1"])
    if "roi2" in kw:
        bm.setROI2(kw["roi2"])
    return bm.compute(left, right)


def my_bm(left, right, ndisp, bs, **kw):
    return golden_stereo_bm(
        left, right, ndisp, bs,
        min_disparity=kw.get("mindisp", 0),
        pre_filter_cap=kw.get("cap", 31),
        texture_threshold=kw.get("tex", 0),
        uniqueness_ratio=kw.get("uniq", 0),
        speckle_window_size=kw.get("spk", 0),
        speckle_range=kw.get("spkr", 0),
        disp12_max_diff=kw.get("d12", -1),
        roi1=kw.get("roi1"),
        roi2=kw.get("roi2"),
    )


REFERENCE_PARAMS = dict(tex=10, uniq=10, spk=100, spkr=32, d12=1)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(tex=10),
        dict(uniq=10),
        dict(d12=1),
        dict(spk=100, spkr=32),
        REFERENCE_PARAMS,  # the bm-sw.cpp configuration (scaled down)
        dict(mindisp=5, **REFERENCE_PARAMS),
        dict(cap=63, **REFERENCE_PARAMS),
    ],
)
def test_bm_exact_parity(kw):
    left, right = stereo_pair(0, 64, 160, 8)
    a = cv_bm(left, right, 32, 9, **kw)
    b = my_bm(left, right, 32, 9, **kw)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,shift,bs,nd", [(1, 3, 5, 16), (2, 20, 13, 48)])
def test_bm_exact_parity_shapes(seed, shift, bs, nd):
    left, right = stereo_pair(seed, 72, 192, shift, smooth=seed % 2 == 0)
    a = cv_bm(left, right, nd, bs, **REFERENCE_PARAMS)
    b = my_bm(left, right, nd, bs, **REFERENCE_PARAMS)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "rois",
    [
        dict(roi1=(50, 10, 80, 40)),  # reference's ROI1-only case
        dict(roi1=(50, 10, 80, 40), roi2=(45, 12, 80, 36)),
        dict(roi2=(45, 10, 80, 40)),
    ],
)
def test_bm_roi_parity(rois):
    left, right = stereo_pair(5, 64, 160, 8)
    a = cv_bm(left, right, 32, 9, **REFERENCE_PARAMS, **rois)
    b = my_bm(left, right, 32, 9, **REFERENCE_PARAMS, **rois)
    np.testing.assert_array_equal(a, b)


def test_filter_speckles_oracle():
    left, right = stereo_pair(7, 64, 160, 8)
    d = cv_bm(left, right, 32, 9, tex=10, uniq=10)
    ref = d.copy()
    cv2.filterSpeckles(ref, -16, 100, 32 * 16)
    mine = golden_filter_speckles(d, -16, 100, 32 * 16)
    np.testing.assert_array_equal(ref, mine)


def test_validate_disparity_oracle():
    # validateDisparity is exercised through full-matcher parity above; this
    # checks the standalone golden keeps already-invalid pixels invalid and
    # only ever invalidates (never revalidates).
    left, right = stereo_pair(8, 48, 128, 8)
    from rt_depth_map.golden.bm import golden_stereo_bm as g

    d_no, dbg = g(left, right, 32, 9, disp12_max_diff=-1,
                  texture_threshold=0, uniqueness_ratio=0,
                  speckle_window_size=0, return_debug=True)
    d_yes = golden_validate_disparity(d_no, dbg.best_cost.astype(np.int32), 0, 32, 1)
    changed = d_no != d_yes
    assert (d_yes[changed] == -16).all()


def test_known_shift_recovered():
    """Ground-truth check independent of cv2: a pure horizontal shift is
    recovered at every valid pixel."""
    left, right = stereo_pair(3, 64, 160, 12)
    d = my_bm(left, right, 32, 9)
    valid = d != -16
    dv = d[valid] / 16.0
    assert valid.mean() > 0.4
    assert np.abs(dv - 12.0).max() <= 1.0
    assert np.abs(dv - 12.0).mean() < 0.1
