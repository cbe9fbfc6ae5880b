"""Golden SGBM vs cv2.StereoSGBM parity.

Unlike StereoBM (bit-exact, see test_golden_bm.py), the installed OpenCV 5.0
rewrote SGBM internals; our golden implements the documented OpenCV-4 SGM
semantics (SURVEY.md section 2.9b). Residual differences are +/-1..3
sixteenths-of-a-pixel of subpixel rounding on ~2% of pixels. Parity is
therefore asserted with the judged metric: bad-pixel fraction
(|d - d_ref| > 1 px among both-valid pixels) plus validity agreement,
with bounds 10x tighter than the 1% budget (BASELINE.md).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from rt_depth_map.golden.sgbm import golden_stereo_sgbm

INVALID = -16


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 0)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


def bad_pixel_stats(a, b):
    va = a != INVALID
    vb = b != INVALID
    both = va & vb
    bad = (np.abs(a.astype(int) - b.astype(int)) > 16) & both
    return bad.sum() / max(both.sum(), 1), (va != vb).mean()


def cv_sgbm(left, right, ndisp, bs, mode, **kw):
    m = cv2.StereoSGBM_create(0, ndisp, bs)
    m.setP1(kw.get("p1", 8 * 3 * 5 * 5))
    m.setP2(kw.get("p2", 32 * 3 * 5 * 5))
    m.setUniquenessRatio(kw.get("uniq", 0))
    m.setSpeckleWindowSize(kw.get("spk", 0))
    m.setSpeckleRange(kw.get("spkr", 0))
    m.setDisp12MaxDiff(kw.get("d12", -1))
    m.setPreFilterCap(0)
    m.setMode(
        cv2.STEREO_SGBM_MODE_HH if mode == "hh" else cv2.STEREO_SGBM_MODE_SGBM
    )
    return m.compute(left, right)


@pytest.mark.parametrize("mode", ["sgbm", "hh"])
@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(uniq=10),
        # the sgbm-sw.cpp:12-25 configuration
        dict(uniq=10, spk=100, spkr=32, d12=1),
    ],
)
def test_sgbm_parity_within_budget(mode, kw):
    left, right = stereo_pair(0, 48, 128, 8)
    ref = cv_sgbm(left, right, 32, 5, mode, **kw)
    mine = golden_stereo_sgbm(
        left, right, 32, 5,
        uniqueness_ratio=kw.get("uniq", 0),
        speckle_window_size=kw.get("spk", 0),
        speckle_range=kw.get("spkr", 0),
        disp12_max_diff=kw.get("d12", -1),
        mode=mode,
    )
    bad_frac, validity_diff = bad_pixel_stats(ref, mine)
    # 2-4x inside the <=1% budget (hh accumulates 8 paths of subpixel noise)
    assert bad_frac < (0.005 if mode == "hh" else 0.001), bad_frac
    assert validity_diff < 0.02, validity_diff
    # and the distribution of value differences stays in subpixel noise
    both = (ref != INVALID) & (mine != INVALID)
    close = np.abs(ref.astype(int) - mine.astype(int))[both] <= 3
    assert close.mean() > 0.99


def test_sgbm_known_shift_recovered():
    left, right = stereo_pair(3, 48, 160, 12)
    mine = golden_stereo_sgbm(left, right, 32, 5, uniqueness_ratio=10,
                              disp12_max_diff=1, speckle_window_size=0)
    valid = mine != INVALID
    dv = mine[valid] / 16.0
    assert valid.mean() > 0.5
    assert np.abs(dv - 12.0).mean() < 0.2


def test_sgbm_p1_p2_smoothing():
    """Higher P2 produces a smoother disparity field (fewer jumps)."""
    left, right = stereo_pair(4, 48, 128, 8)

    def roughness(p1, p2):
        d = golden_stereo_sgbm(left, right, 32, 5, p1=p1, p2=p2,
                               speckle_window_size=0, disp12_max_diff=-1)
        v = (d != INVALID)[:, 1:] & (d != INVALID)[:, :-1]
        return np.abs(np.diff(d.astype(int), axis=1))[v].mean()

    assert roughness(600, 2400) <= roughness(8, 16)
