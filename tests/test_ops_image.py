"""Image-op parity tests vs cv2: color, remap, morphology."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp

from rt_depth_map.ops import (
    dilate,
    ellipse_kernel,
    erode,
    in_range,
    morph_open_close,
    remap_bilinear,
    rgb_to_gray,
    rgb_to_hsv,
)


@pytest.fixture
def rgb(rng):
    return rng.integers(0, 256, size=(64, 80, 3), dtype=np.uint8)


def test_rgb_to_gray_exact(rgb):
    mine = np.asarray(rgb_to_gray(jnp.asarray(rgb)))
    ref = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
    # we implement OpenCV's documented fixed-point formula; cv2's IPP/SIMD
    # dispatch rounds differently on ~0.2% of pixels by +/-1 LSB
    diff = np.abs(mine.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


def test_rgb_to_hsv_exact(rgb):
    mine = np.asarray(rgb_to_hsv(jnp.asarray(rgb)))
    # reference does RGB->BGR then BGR->HSV (estimator.cpp:40-42)
    bgr = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
    ref = cv2.cvtColor(bgr, cv2.COLOR_BGR2HSV)
    np.testing.assert_array_equal(mine, ref)


def test_in_range_exact(rgb):
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    low, high = (0, 150, 0), (9, 255, 255)  # "red" (main.cpp:46)
    mine = np.asarray(in_range(jnp.asarray(hsv), low, high))
    ref = cv2.inRange(hsv, low, high)
    np.testing.assert_array_equal(mine, ref)


def test_ellipse_kernel_matches_cv2():
    for w, h in [(10, 10), (5, 5), (7, 3), (3, 7), (1, 1), (4, 6)]:
        mine = ellipse_kernel(w, h)
        ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (w, h))
        np.testing.assert_array_equal(mine, ref, err_msg=f"({w},{h})")


@pytest.mark.parametrize("ksize", [(10, 10), (5, 3)])
def test_erode_dilate_match_cv2(rng, ksize):
    # binary mask like the pipeline's threshold output
    mask = (rng.random((48, 56)) > 0.6).astype(np.uint8) * 255
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, ksize)
    np.testing.assert_array_equal(
        np.asarray(erode(jnp.asarray(mask), se)), cv2.erode(mask, se)
    )
    np.testing.assert_array_equal(
        np.asarray(dilate(jnp.asarray(mask), se)), cv2.dilate(mask, se)
    )


def test_erode_grayscale_matches_cv2(rng):
    img = rng.integers(0, 256, size=(32, 40), dtype=np.uint8)
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (7, 5))
    np.testing.assert_array_equal(
        np.asarray(erode(jnp.asarray(img), se)), cv2.erode(img, se)
    )
    np.testing.assert_array_equal(
        np.asarray(dilate(jnp.asarray(img), se)), cv2.dilate(img, se)
    )


def test_morph_open_close_matches_reference_sequence(rng):
    """The mf-sw.cpp sequence: erode, dilate, dilate, erode with 10x10."""
    mask = (rng.random((60, 72)) > 0.55).astype(np.uint8) * 255
    se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (10, 10))
    ref = cv2.erode(cv2.dilate(cv2.dilate(cv2.erode(mask, se), se), se), se)
    mine = np.asarray(morph_open_close(jnp.asarray(mask), se))
    np.testing.assert_array_equal(mine, ref)


def test_remap_matches_cv2_fixed_point(rng):
    """Bit-exact vs cv2's CV_16SC2 fixed-point remap -- the reference's
    configuration (main.cpp:95-96 produces CV_16SC2 maps)."""
    img = rng.integers(0, 256, size=(40, 52), dtype=np.uint8)
    H, W = img.shape
    # random map, includes out-of-range coords to hit the border
    mx = rng.uniform(-3, W + 2, size=(H, W)).astype(np.float32)
    my = rng.uniform(-3, H + 2, size=(H, W)).astype(np.float32)
    m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    ref = cv2.remap(img, m1, m2, cv2.INTER_LINEAR)
    grid = jnp.asarray(np.stack([mx, my], axis=-1))
    mine = np.asarray(remap_bilinear(jnp.asarray(img), grid))
    np.testing.assert_array_equal(mine, ref)


def test_remap_rgb_and_float(rng):
    img = rng.integers(0, 256, size=(24, 30, 3), dtype=np.uint8)
    H, W = img.shape[:2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    mx = (u * 0.97 + 0.4).astype(np.float32)
    my = (v * 0.98 + 0.1).astype(np.float32)
    grid = jnp.asarray(np.stack([mx, my], axis=-1))
    mine = np.asarray(remap_bilinear(jnp.asarray(img), grid))
    m1, m2 = cv2.convertMaps(mx, my, cv2.CV_16SC2)
    ref = cv2.remap(img, m1, m2, cv2.INTER_LINEAR)
    np.testing.assert_array_equal(mine, ref)
    # float path: plain (unquantized-weight) bilinear within 1/32-px slop
    imf = img[..., 0].astype(np.float32)
    minef = np.asarray(remap_bilinear(jnp.asarray(imf), grid))
    reff = cv2.remap(imf, mx, my, cv2.INTER_LINEAR)
    assert np.abs(minef - reff).max() < 8.5  # <= max|grad| * 1/32
