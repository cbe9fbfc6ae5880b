"""Object detection on the thresholded mask: connected components ->
bounding boxes -> matcher ROI.

Re-creates the reference's findContours(RETR_EXTERNAL) ->
fill_bounding_rects_of_contours -> find_relevant_matching_region chain
(estimator.cpp:47-56, 164-204) as static-shape JAX:

  * cv::findContours traces 8-connected blobs; the bounding rect of an outer
    contour is the bounding box of its connected component, so components are
    labeled directly (8-connected label propagation + pointer jumping, same
    scheme as ops/speckle.py).
  * Boxes whose bbox AREA (w*h, cv::Rect::area -- not pixel count) is below
    minSize are dropped (estimator.cpp:169-171).
  * The reference emits boxes in contour discovery order = raster order of
    each blob's topmost-leftmost pixel; labels are min linear indices, so
    sorting ascending reproduces that order.
  * Output is a fixed (max_objects, 5) int32 [x, y, w, h, valid] array
    (dynamic object count under static shapes, SURVEY.md section 7 hard
    part 7); overflow components beyond max_objects are dropped.
  * The matcher ROI is the union bbox of all valid boxes
    (find_relevant_matching_region, estimator.cpp:176-204).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_BIG = 2**30  # python int, not jnp scalar: module-scope device constants get lifted
# as executable parameters and the jit fast path drops them on re-dispatch


def connected_components8(active: jnp.ndarray) -> jnp.ndarray:
    """int32 labels (min linear index per component) of 8-connected blobs;
    inactive pixels keep a unique self-label. Gather-free segmented-scan
    implementation (ops/cc.py)."""
    from rt_depth_map.ops.cc import connected_components_scan

    zeros = jnp.zeros(active.shape, jnp.int32)
    return connected_components_scan(zeros, active, 0, connectivity=8)


def detect_objects(
    mask: jnp.ndarray,
    min_size: jnp.ndarray | int,
    max_objects: int,
) -> jnp.ndarray:
    """(max_objects, 5) int32 [x, y, w, h, valid] boxes in raster order.

    mask: (H, W) uint8/bool filtered object mask. min_size: minimum bbox
    area (cv::Rect::area semantics), python int or traced scalar.
    """
    from rt_depth_map.ops.cc import cc_round_cap, connected_components_bbox

    H, W = mask.shape
    active = mask != 0
    # scatter-free: bbox extremes are idempotent min/max aggregates and ride
    # the label propagation (ops/cc.py); miny/maxy fall out of the min/max
    # linear indices (no 4-scatter formulation).
    # cc_round_cap bounds the adversarial worst case: morphological
    # open/close masks are blob-like and converge in 2-3 sweeps; under the
    # cap a pathological mask's components may SPLIT (extra boxes whose
    # union-ROI is a subset of the true union -- degraded, not unsafe).
    labels, maxidx, minx2, maxx2 = connected_components_bbox(
        active, 8, max_rounds=cc_round_cap())

    flat_labels = labels.reshape(-1)
    act = active.reshape(-1)
    n = H * W
    idx1 = jnp.arange(n, dtype=jnp.int32)
    is_root = act & (flat_labels == idx1)

    miny = (labels // W).reshape(-1)
    maxy = (maxidx // W).reshape(-1)
    minx = minx2.reshape(-1)
    bw = (maxx2.reshape(-1) - minx) + 1
    bh = (maxy - miny) + 1
    keep = is_root & (bw * bh >= jnp.asarray(min_size, jnp.int32))

    # first max_objects roots in raster (== label) order: top_k of -index.
    # Two-stage EXACT top-k: a global lax.top_k over H*W elements lowers
    # to a full sort; per-chunk top-k over a (G, chunk) reshape followed
    # by top-k of the G*max_objects
    # candidates returns the identical set (any global top element is a
    # top element of its chunk).
    score = jnp.where(keep, -idx1, -jnp.int32(2**30))
    chunk = 2048
    if n % chunk == 0 and n // chunk >= 2:
        G = n // chunk
        s2 = score.reshape(G, chunk)
        cand_s, cand_i = jax.lax.top_k(s2, max_objects)  # (G, K) batched
        base = (jnp.arange(G, dtype=jnp.int32) * chunk)[:, None]
        cand_i = cand_i.astype(jnp.int32) + base
        neg, pos = jax.lax.top_k(cand_s.reshape(-1), max_objects)
        root_idx = cand_i.reshape(-1)[pos]
    else:
        neg, root_idx = jax.lax.top_k(score, max_objects)
    valid = neg != -jnp.int32(2**30)
    r = jnp.where(valid, root_idx, 0)
    # top_k returns descending score == ascending index: raster order already
    boxes = jnp.stack(
        [minx[r], miny[r], bw[r], bh[r], valid.astype(jnp.int32)], axis=1
    )
    return jnp.where(valid[:, None], boxes, 0)


def matching_region(boxes: jnp.ndarray) -> Tuple[jnp.ndarray, ...]:
    """Union bbox (x, y, w, h) of valid boxes (find_relevant_matching_region,
    estimator.cpp:176-204). With no valid boxes returns (0, 0, 0, 0): the
    reference skips matching entirely in that case (estimator.cpp:48 guards on
    contours.size()), and an empty ROI is the matcher's own no-restriction
    marker, so the engine can gate on boxes[:, 4] without overflow-prone
    sentinel coordinates."""
    v = boxes[:, 4] > 0
    any_v = jnp.any(v)
    LO, HI = jnp.int32(-(10**6)), jnp.int32(10**6)
    minx = jnp.min(jnp.where(v, boxes[:, 0], HI))
    miny = jnp.min(jnp.where(v, boxes[:, 1], HI))
    maxx = jnp.max(jnp.where(v, boxes[:, 0] + boxes[:, 2], LO))
    maxy = jnp.max(jnp.where(v, boxes[:, 1] + boxes[:, 3], LO))
    z = jnp.int32(0)
    return (
        jnp.where(any_v, minx, z),
        jnp.where(any_v, miny, z),
        jnp.where(any_v, maxx - minx, z),
        jnp.where(any_v, maxy - miny, z),
    )
