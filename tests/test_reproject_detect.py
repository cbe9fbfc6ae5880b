"""Reprojection + depth stats + object detection vs cv2 / reference semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from rt_depth_map.ops.detect import detect_objects, matching_region
from rt_depth_map.ops.reproject import (
    calc_depth,
    disparity_fixed_to_float,
    reproject_to_3d,
)


def make_q(f=500.0, cx=160.0, cy=120.0, tx=-0.06):
    # Bouguet Q layout (CALIB_ZERO_DISPARITY): [[1,0,0,-cx],[0,1,0,-cy],
    # [0,0,0,f],[0,0,-1/Tx,0]]
    Q = np.zeros((4, 4))
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3] = -cx
    Q[1, 3] = -cy
    Q[2, 3] = f
    Q[3, 2] = -1.0 / tx
    return Q


def test_reproject_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    disp16 = (rng.integers(0, 64 * 16, size=(40, 64))).astype(np.int16)
    disp16[5:10, 5:10] = -16  # invalid marker
    Q = make_q()

    d = np.asarray(disparity_fixed_to_float(jnp.asarray(disp16)))
    ref_in = (disp16.astype(np.float64) / 16.0)
    ref_in = np.round(ref_in).astype(np.int16)  # cv2 /=16. rounds
    np.testing.assert_array_equal(d, ref_in)

    xyz_ref = cv2.reprojectImageTo3D(ref_in, Q, handleMissingValues=True)
    xyz = np.asarray(reproject_to_3d(jnp.asarray(d), Q, 0, True))
    finite = np.isfinite(xyz_ref).all(axis=-1)
    np.testing.assert_allclose(xyz[finite], xyz_ref[finite], rtol=1e-4, atol=1e-3)


def test_calc_depth_masked_mean():
    H, W = 60, 80
    Z = np.full((H, W), 50.0, np.float32)
    Z[10:20, 10:30] = 20.0
    xyz = np.zeros((H, W, 3), np.float32)
    xyz[..., 2] = Z
    mask = np.zeros((H, W), np.uint8)
    mask[12:18, 12:25] = 255
    boxes = jnp.asarray([[10, 10, 20, 10, 1], [40, 40, 10, 10, 1], [0, 0, 0, 0, 0]],
                        dtype=jnp.int32)
    depth_cm, mean_z, cnt = calc_depth(jnp.asarray(xyz), jnp.asarray(mask),
                                       boxes, calibration_unit=25.0)
    depth_cm, mean_z, cnt = map(np.asarray, (depth_cm, mean_z, cnt))
    assert cnt[0] == 6 * 13
    np.testing.assert_allclose(mean_z[0], 20.0)
    np.testing.assert_allclose(depth_cm[0], 20.0 * 2.5)
    assert cnt[1] == 0 and np.isnan(depth_cm[1])  # box with no mask pixels
    assert cnt[2] == 0 and np.isnan(depth_cm[2])  # invalid box


def test_calc_depth_rejects_missing_z():
    H, W = 20, 20
    xyz = np.zeros((H, W, 3), np.float32)
    xyz[..., 2] = 10000.0  # all "missing"
    xyz[5, 5, 2] = 30.0
    mask = np.full((H, W), 255, np.uint8)
    boxes = jnp.asarray([[0, 0, 20, 20, 1]], dtype=jnp.int32)
    _, mean_z, cnt = calc_depth(jnp.asarray(xyz), jnp.asarray(mask), boxes, 25.0)
    assert int(cnt[0]) == 1
    np.testing.assert_allclose(float(mean_z[0]), 30.0)


def blobs_mask(H, W):
    m = np.zeros((H, W), np.uint8)
    m[5:15, 5:20] = 255      # blob A, bbox 15x10=150
    m[30:33, 40:43] = 255    # blob B, bbox 3x3=9 (below minSize 20)
    m[20:28, 60:75] = 255    # blob C, bbox 15x8=120
    # 8-connected diagonal extension of A
    m[15, 20] = 255
    return m


def test_detect_objects_matches_cv2_boxes():
    cv2 = pytest.importorskip("cv2")
    m = blobs_mask(48, 96)
    contours, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    ref = [cv2.boundingRect(c) for c in contours]
    ref = [r for r in ref if r[2] * r[3] >= 20]
    ref_sorted = sorted(ref, key=lambda r: (r[1], r[0]))

    boxes = np.asarray(detect_objects(jnp.asarray(m), 20, 8))
    mine = [tuple(b[:4]) for b in boxes if b[4]]
    assert sorted(mine, key=lambda r: (r[1], r[0])) == ref_sorted


def test_detect_objects_raster_order_and_overflow():
    m = np.zeros((32, 32), np.uint8)
    for i, (y, x) in enumerate([(2, 2), (2, 20), (12, 5), (25, 25)]):
        m[y : y + 4, x : x + 4] = 255
    boxes = np.asarray(detect_objects(jnp.asarray(m), 1, 3))
    assert boxes[:, 4].sum() == 3  # overflow: only first 3 kept
    # raster order of top-left pixels
    tops = boxes[boxes[:, 4] > 0][:, :2]
    assert tops.tolist() == [[2, 2], [20, 2], [5, 12]]


def test_matching_region_union():
    boxes = jnp.asarray(
        [[10, 5, 20, 10, 1], [40, 30, 5, 5, 1], [0, 0, 99, 99, 0]],
        dtype=jnp.int32,
    )
    x, y, w, h = map(int, matching_region(boxes))
    assert (x, y, w, h) == (10, 5, 35, 30)


def test_detect_empty_mask():
    m = np.zeros((16, 16), np.uint8)
    boxes = np.asarray(detect_objects(jnp.asarray(m), 1, 4))
    assert boxes[:, 4].sum() == 0


def test_detect_two_stage_topk_matches_global():
    """The chunked two-stage top-k path (H*W % 2048 == 0) must return the
    exact same boxes as the global top_k: many small components spread
    across chunk boundaries, more components than max_objects."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from rt_depth_map.ops.detect import detect_objects

    H, W = 64, 128  # 8192 = 4 chunks of 2048
    rng = np.random.default_rng(11)
    mask = np.zeros((H, W), np.uint8)
    for _ in range(40):  # > max_objects, scattered over all chunks
        y, x = rng.integers(1, H - 4), rng.integers(1, W - 4)
        mask[y:y + 3, x:x + 3] = 255
    boxes = np.asarray(detect_objects(jnp.asarray(mask), 4, 16))

    # oracle: cv2 components, raster order of topmost-leftmost pixel
    # (== min linear index order)
    import cv2

    n, lab, stats, _ = cv2.connectedComponentsWithStats(mask, connectivity=8)
    roots = []
    for i in range(1, n):
        ys, xs = np.nonzero(lab == i)
        if stats[i][2] * stats[i][3] >= 4:
            roots.append((int((ys * W + xs).min()), i))
    roots.sort()
    want = []
    for _, i in roots[:16]:
        x, y, w, h = (int(v) for v in stats[i][:4])
        want.append([x, y, w, h, 1])
    want += [[0, 0, 0, 0, 0]] * (16 - len(want))
    np.testing.assert_array_equal(boxes, np.asarray(want, np.int32))
