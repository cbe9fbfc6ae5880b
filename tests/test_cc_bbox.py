"""Scatter-free component bbox propagation vs brute force."""

import numpy as np
import jax.numpy as jnp

from rt_depth_map.ops.cc import connected_components_bbox, component_sizes
from rt_depth_map.ops.cc import connected_components_scan


def brute_bboxes(active, connectivity=8):
    import collections

    H, W = active.shape
    seen = np.zeros_like(active, bool)
    out = {}
    if connectivity == 8:
        nbrs = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
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
                        if 0 <= ny < H and 0 <= nx < W and active[ny, nx] and not seen[ny, nx]:
                            seen[ny, nx] = True
                            q.append((ny, nx))
                ys = [p[0] for p in comp]
                xs = [p[1] for p in comp]
                root = min(p[0] * W + p[1] for p in comp)
                out[root] = (min(xs), min(ys), max(xs), max(ys), len(comp))
    return out


def test_bbox_propagation_matches_bruteforce():
    rng = np.random.default_rng(5)
    for trial in range(4):
        active = rng.random((40, 56)) < 0.35
        labels, maxidx, minx, maxx = map(
            np.asarray, connected_components_bbox(jnp.asarray(active), 8)
        )
        ref = brute_bboxes(active, 8)
        W = active.shape[1]
        for root, (bx0, by0, bx1, by1, size) in ref.items():
            ry, rx = divmod(root, W)
            assert labels[ry, rx] == root
            assert minx[ry, rx] == bx0
            assert maxx[ry, rx] == bx1
            assert labels[ry, rx] // W == by0
            assert maxidx[ry, rx] // W == by1


def test_component_sizes_propagated_readback():
    rng = np.random.default_rng(6)
    v = (rng.integers(0, 4, (32, 48)) * 16).astype(np.int32)
    active = rng.random((32, 48)) < 0.6
    labels = connected_components_scan(jnp.asarray(v), jnp.asarray(active), 16, 4)
    plain = np.asarray(component_sizes(labels, jnp.asarray(active)))
    prop = np.asarray(
        component_sizes(labels, jnp.asarray(active), values=jnp.asarray(v),
                        max_diff=16, connectivity=4)
    )
    np.testing.assert_array_equal(plain, prop)


def test_component_sizes_readback_connectivity8():
    # a diagonal-only-connected component: without the diagonal hop in the
    # read-back, the off-diagonal pixels keep the _BIG sentinel
    v = np.zeros((8, 8), np.int32)
    active = np.zeros((8, 8), bool)
    for i in range(5):
        active[i, i] = True
    active[6, 0] = True  # separate singleton
    labels = connected_components_scan(jnp.asarray(v), jnp.asarray(active), 0, 8)
    plain = np.asarray(component_sizes(labels, jnp.asarray(active)))
    prop = np.asarray(
        component_sizes(labels, jnp.asarray(active), values=jnp.asarray(v),
                        max_diff=0, connectivity=8)
    )
    np.testing.assert_array_equal(plain, prop)
    assert prop[2, 2] == 5 and prop[6, 0] == 1

    rng = np.random.default_rng(7)
    vr = (rng.integers(0, 3, (32, 48)) * 16).astype(np.int32)
    ar = rng.random((32, 48)) < 0.4
    labels = connected_components_scan(jnp.asarray(vr), jnp.asarray(ar), 16, 8)
    plain = np.asarray(component_sizes(labels, jnp.asarray(ar)))
    prop = np.asarray(
        component_sizes(labels, jnp.asarray(ar), values=jnp.asarray(vr),
                        max_diff=16, connectivity=8)
    )
    np.testing.assert_array_equal(plain, prop)
