"""The XLA formulations that every platform runs, against numpy references.

BM at assorted operating points and off-grid shapes against the golden
StereoBM (golden/bm.py, itself bit-exact vs cv2); connected components
against pointer-jumping / flood-fill references; the fixed-point bilinear
remap against a numpy transcription of the same arithmetic; the SGBM cost
volume against golden/sgbm.py. All comparisons are bit-exact.
"""

import collections

import numpy as np
import pytest

import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.golden import golden_stereo_bm
from rt_depth_map.ops.bm import stereo_bm


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


def _bm_vs_golden(left, right, **kw):
    got = np.asarray(stereo_bm(jnp.asarray(left), jnp.asarray(right),
                               MatcherConfig(kind="bm", **kw)))
    ref = golden_stereo_bm(
        left, right, kw["num_disparities"], kw["block_size"],
        pre_filter_cap=kw["pre_filter_cap"],
        texture_threshold=kw["texture_threshold"],
        uniqueness_ratio=kw["uniqueness_ratio"],
        speckle_window_size=kw["speckle_window_size"],
        speckle_range=kw["speckle_range"],
        disp12_max_diff=kw["disp12_max_diff"],
    )
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("full_checks", [False, True])
def test_bm_matches_golden(full_checks):
    left, right = stereo_pair(11, 16, 256, 7)
    _bm_vs_golden(
        left, right, num_disparities=16, block_size=9, pre_filter_cap=31,
        texture_threshold=10 if full_checks else 0,
        uniqueness_ratio=10 if full_checks else 0,
        speckle_window_size=50 if full_checks else 0,
        speckle_range=32,
        disp12_max_diff=1 if full_checks else -1,
    )


@pytest.mark.parametrize(
    "seed,D,bs,cap,tex,uniq,sws,d12",
    [
        (21, 8, 5, 15, 0, 0, 0, -1),
        (22, 24, 7, 63, 5, 15, 30, 0),
        (23, 32, 11, 31, 20, 5, 80, 2),
        (24, 48, 15, 40, 10, 10, 100, 1),
        (25, 16, 21, 25, 0, 25, 60, 1),
    ],
)
def test_bm_cross_config_parity(seed, D, bs, cap, tex, uniq, sws, d12):
    """Randomized operating points across the BM config space."""
    left, right = stereo_pair(seed, 24, 256, seed % 11)
    _bm_vs_golden(
        left, right, num_disparities=D, block_size=bs, pre_filter_cap=cap,
        texture_threshold=tex, uniqueness_ratio=uniq,
        speckle_window_size=sws, speckle_range=16, disp12_max_diff=d12,
    )


def test_bm_off_grid_shape_strict():
    """Shapes with H % 8 != 0 and W % 128 != 0 (the calibration-ROI
    class) run unpadded and stay bit-exact."""
    left, right = stereo_pair(31, 44, 200, 6)
    _bm_vs_golden(
        left, right, num_disparities=32, block_size=9, pre_filter_cap=31,
        texture_threshold=10, uniqueness_ratio=10, speckle_window_size=50,
        speckle_range=32, disp12_max_diff=1,
    )


def test_sgbm_cost_volume_matches_golden():
    from rt_depth_map.golden.sgbm import sgbm_cost_volume as golden_cv
    from rt_depth_map.ops.sgbm import sgbm_cost_volume

    rng = np.random.default_rng(7)
    l = rng.integers(0, 256, (64, 576), dtype=np.uint8)
    r = rng.integers(0, 256, (64, 576), dtype=np.uint8)
    got, minX1, W1 = sgbm_cost_volume(jnp.asarray(l), jnp.asarray(r), 64, 5)
    ref, minX1r, W1r = golden_cv(l, r, 64, 5, 0, 0)
    assert (minX1, W1) == (minX1r, W1r)
    np.testing.assert_array_equal(np.asarray(got), ref)


# -- connected components -------------------------------------------------

def _bfs_components(active, connectivity):
    """(H, W) min-linear-index label per component (flood fill)."""
    H, W = active.shape
    lab = np.arange(H * W).reshape(H, W)
    seen = np.zeros_like(active)
    if connectivity == 8:
        nbrs = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1) if a or b]
    else:
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    for y in range(H):
        for x in range(W):
            if not active[y, x] or seen[y, x]:
                continue
            comp, q = [], collections.deque([(y, x)])
            seen[y, x] = True
            while q:
                cy, cx = q.popleft()
                comp.append((cy, cx))
                for dy, dx in nbrs:
                    ny, nx = cy + dy, cx + dx
                    if (0 <= ny < H and 0 <= nx < W and active[ny, nx]
                            and not seen[ny, nx]):
                        seen[ny, nx] = True
                        q.append((ny, nx))
            root = min(p[0] * W + p[1] for p in comp)
            for p in comp:
                lab[p] = root
    return lab


def test_cc_scan_matches_pointer_jumping():
    # segmented-sweep CC must reach the hook+pointer-jump fixed point: min
    # linear index per 4-connected component of similar values
    from rt_depth_map.ops.cc import connected_components_scan
    from rt_depth_map.ops.speckle import connected_components

    rng = np.random.default_rng(7)
    H, W = 32, 128
    v = jnp.asarray((rng.integers(0, 4, (H, W)) * 32).astype(np.int32))
    act = jnp.asarray(rng.random((H, W)) > 0.25)
    ref = connected_components(v, act, jnp.int32(16))
    got = connected_components_scan(v, act, jnp.int32(16), 4)
    a = np.asarray(act)
    np.testing.assert_array_equal(np.asarray(got)[a], np.asarray(ref)[a])


def test_cc_bbox_8conn_matches_flood_fill():
    from rt_depth_map.ops.cc import connected_components_bbox

    rng = np.random.default_rng(3)
    H, W = 24, 128
    act = rng.random((H, W)) > 0.55  # sparse: many diagonal-only links
    labels, maxidx, minx, maxx = (
        np.asarray(a) for a in connected_components_bbox(jnp.asarray(act), 8))
    ref = _bfs_components(act, 8)
    np.testing.assert_array_equal(labels[act], ref[act])
    xs = np.broadcast_to(np.arange(W), (H, W))
    lin = np.arange(H * W).reshape(H, W)
    for root in np.unique(ref[act]):
        sel = act & (ref == root)
        assert (minx[sel] == xs[sel].min()).all()
        assert (maxx[sel] == xs[sel].max()).all()
        assert (maxidx[sel] == lin[sel].max()).all()


def test_cc_spiral_converges():
    # worst-case component: a spiral corridor needs many direction turns --
    # exercises the while_loop round bound rather than typical 2-3 rounds
    from rt_depth_map.ops.cc import connected_components_scan

    H, W = 16, 128
    act = np.zeros((H, W), bool)
    act[0, :] = True
    act[:, -1] = True
    act[-1, :] = True
    act[2:, 0] = True
    act[2, :64] = True  # inward turn
    got = np.asarray(connected_components_scan(
        jnp.zeros((H, W), jnp.int32), jnp.asarray(act), 0, 4))
    assert (got[act] == got[act].min()).all()  # single component, one label


@pytest.mark.parametrize("active_frac", [0.85, 0.4])
def test_component_sizes_match_scatter(active_frac):
    # per-label totals (scatter-add) read back at every pixel must equal
    # numpy's count per label
    from rt_depth_map.ops.cc import component_sizes

    rng = np.random.default_rng(21)
    H, W = 48, 256
    lab = np.sort(rng.integers(0, H * W, H * W).astype(np.int32)).reshape(
        H, W)
    act = rng.random((H, W)) < active_frac
    ref = np.zeros(H * W, np.int64)
    np.add.at(ref, lab.reshape(-1)[act.reshape(-1)], 1)
    got = np.asarray(component_sizes(jnp.asarray(lab), jnp.asarray(act)))
    np.testing.assert_array_equal(got[act], ref[lab[act]])
    assert (got[~act] == 0).all()


# -- remap ----------------------------------------------------------------

def remap_ref(img, grid):
    """numpy transcription of remap_bilinear's uint8 arithmetic: 1/32-px
    quantized coordinates, 10-bit integer weights, zero border."""
    H, W = img.shape[:2]
    mx = grid[..., 0].astype(np.float32)
    my = grid[..., 1].astype(np.float32)
    ix = np.floor(mx).astype(np.int64)
    iy = np.floor(my).astype(np.int64)
    fx = np.round((mx - ix.astype(np.float32)) * np.float32(32)).astype(
        np.int64)
    fy = np.round((my - iy.astype(np.float32)) * np.float32(32)).astype(
        np.int64)
    ix, iy = ix + (fx >> 5), iy + (fy >> 5)
    fx, fy = fx & 31, fy & 31
    img = img.astype(np.int64)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(ok[..., None], v, 0)

    acc = (tap(iy, ix) * ((32 - fx) * (32 - fy))[..., None]
           + tap(iy, ix + 1) * (fx * (32 - fy))[..., None]
           + tap(iy + 1, ix) * ((32 - fx) * fy)[..., None]
           + tap(iy + 1, ix + 1) * (fx * fy)[..., None])
    return ((acc + 512) >> 10).astype(np.uint8)


@pytest.mark.parametrize("case", ["warp", "xshift", "identity"])
def test_remap_matches_numpy_reference(case):
    from rt_depth_map.ops.remap import remap_bilinear

    rng = np.random.default_rng(0)
    H, W = 64, 256
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float64)
    if case == "warp":
        mx = gx + 6 * np.sin(gy / 11.0) + 2 * np.cos(gx / 29.0) - 3
        my = gy + 2.5 * np.sin(gx / 23.0) + 3 * np.cos(gy / 7.0) - 2
    elif case == "xshift":
        mx, my = gx + 1.5, gy + 0.0
    else:
        mx, my = gx, gy
    grid = np.stack([mx, my], -1).astype(np.float32)
    got = np.asarray(remap_bilinear(jnp.asarray(img), jnp.asarray(grid)))
    np.testing.assert_array_equal(got, remap_ref(img, grid))

