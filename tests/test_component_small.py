"""The speckle size decision (ops/cc.py component_small / component_sizes)
vs brute-force flood-fill sizes.

Checks the decision (size <= max_size) and the exact per-root counts on
masks engineered to be hard for propagation: snakes taller or wider than
the image's typical component, components of size exactly max_size /
max_size + 1, odd heights and multi-128-column widths.
"""

import collections

import numpy as np
import jax.numpy as jnp
import pytest

from rt_depth_map.golden import golden_filter_speckles
from rt_depth_map.ops.cc import (
    component_sizes,
    component_small,
    connected_components_scan,
)
from rt_depth_map.ops.speckle import filter_speckles


def brute_sizes(active, values, max_diff, connectivity=4):
    """root linear index -> component size (flood fill)."""
    H, W = active.shape
    seen = np.zeros_like(active, bool)
    out = {}
    if connectivity == 8:
        nbrs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
                (1, -1), (1, 0), (1, 1)]
    else:
        nbrs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    for y in range(H):
        for x in range(W):
            if active[y, x] and not seen[y, x]:
                comp = []
                q = collections.deque([(y, x)])
                seen[y, x] = True
                while q:
                    cy, cx = q.popleft()
                    comp.append((cy, cx))
                    for dy, dx in nbrs:
                        ny, nx = cy + dy, cx + dx
                        if (0 <= ny < H and 0 <= nx < W and active[ny, nx]
                                and not seen[ny, nx]
                                and abs(int(values[ny, nx])
                                        - int(values[cy, cx])) <= max_diff):
                            seen[ny, nx] = True
                            q.append((ny, nx))
                root = min(p[0] * W + p[1] for p in comp)
                out[root] = len(comp)
    return out


def _mask_with_snakes(H, W, seed):
    """Random blobs + a vertical snake taller than typical windows."""
    rng = np.random.default_rng(seed)
    m = (rng.random((H, W)) < 0.25)
    # vertical snake: 1px wide, spans most of the image height
    x = 5
    for y in range(2, H - 2):
        m[y, x] = True
        if y % 7 == 0 and x + 1 < W - 1:
            m[y, x + 1] = True
            x += 1
    return m


def _check_decision(m, max_size):
    """Exact root counts and the per-member decision vs flood fill."""
    H, W = m.shape
    vals = np.zeros((H, W), np.int32)
    sizes = brute_sizes(m, vals, 0, 4)
    labels = connected_components_scan(
        jnp.asarray(vals), jnp.asarray(m), 0, 4)
    A = np.asarray(component_sizes(labels, jnp.asarray(m)))
    small = np.asarray(component_small(labels, jnp.asarray(m),
                                       jnp.asarray(vals), 0, max_size))
    lab = np.asarray(labels)
    for root, size in sizes.items():
        assert A[root // W, root % W] == size, (root, size)
    for y in range(H):
        for x in range(W):
            if m[y, x]:
                assert small[y, x] == (sizes[lab[y, x]] <= max_size), (y, x)
            else:
                assert not small[y, x]


@pytest.mark.parametrize("seed,max_size", [(0, 6), (1, 10), (2, 25)])
def test_component_small_decision(seed, max_size):
    _check_decision(_mask_with_snakes(48, 128, seed), max_size)


@pytest.mark.parametrize("H", [41, 47, 52])
def test_component_small_odd_heights(H):
    _check_decision(_mask_with_snakes(H, 128, seed=4), 10)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_component_small_matches_brute(connectivity):
    H, W = 40, 128
    rng = np.random.default_rng(7)
    vals = rng.integers(0, 4, (H, W)).astype(np.int32)
    m = rng.random((H, W)) < 0.55
    max_diff, max_size = 1, 8
    sizes = brute_sizes(m, vals, max_diff, connectivity)

    labels = connected_components_scan(
        jnp.asarray(vals), jnp.asarray(m), max_diff, connectivity)
    small = np.asarray(component_small(
        labels, jnp.asarray(m), jnp.asarray(vals), max_diff, max_size,
        connectivity))

    # expand brute decision to members
    lab = np.asarray(labels)
    for y in range(H):
        for x in range(W):
            if m[y, x]:
                want = sizes[lab[y, x]] <= max_size
                assert small[y, x] == want, (y, x)
            else:
                assert not small[y, x]


def test_filter_speckles_matches_golden():
    """filter_speckles (label propagation + size decision) equals the
    flood-fill cv::filterSpeckles golden."""
    H, W = 48, 128
    rng = np.random.default_rng(3)
    disp = rng.integers(-16, 400, (H, W)).astype(np.int16)
    disp[rng.random((H, W)) < 0.3] = -16
    got = np.asarray(filter_speckles(jnp.asarray(disp), -16, 12, 32))
    ref = golden_filter_speckles(disp.copy(), -16, 12, 32)
    np.testing.assert_array_equal(got, ref)


def _mask_with_horizontal_snakes(H, W, seed):
    """Wide 1-px-tall snakes crossing 128-lane tile borders (exercises the
    COLUMN window of the 2D-banded kernel) plus random blobs."""
    rng = np.random.default_rng(seed)
    m = rng.random((H, W)) < 0.15
    y = 3
    for x in range(2, W - 2):
        m[y, x] = True
        if x % 9 == 0 and y + 1 < H - 1:
            m[y + 1, x] = True
            y += 1
    return m


@pytest.mark.parametrize("seed,max_size", [(3, 8), (5, 20), (6, 100)])
def test_component_small_wide_snakes(seed, max_size):
    """W = 384: components wider than 128 columns, and components whose
    root sits far from most of their members."""
    _check_decision(_mask_with_horizontal_snakes(40, 384, seed), max_size)


def test_component_small_matches_sizes_threshold():
    """component_small is exactly component_sizes <= max_size on active
    pixels (both read the same per-label totals)."""
    H, W, max_size = 32, 256, 12
    m = _mask_with_horizontal_snakes(H, W, seed=9)
    vals = np.zeros((H, W), np.int32)
    labels = connected_components_scan(
        jnp.asarray(vals), jnp.asarray(m), 0, 4)
    sizes = np.asarray(component_sizes(labels, jnp.asarray(m),
                                       values=jnp.asarray(vals), max_diff=0))
    small = np.asarray(component_small(labels, jnp.asarray(m),
                                       jnp.asarray(vals), 0, max_size))
    np.testing.assert_array_equal(small, m & (sizes <= max_size))
