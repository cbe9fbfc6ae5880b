"""Connected components by segmented-scan label propagation (gather-free).

The classic hook+pointer-jumping CC gathers flat[flat] every round. This
formulation never gathers: per round,

  1. neighbor hop: min over the 4- or 8-neighborhood along allowed edges
     (pure shifts + selects);
  2. row sweep: segmented min-scan along x (forward + backward), segments
     delimited by missing horizontal edges -- one `associative_scan`
     (log2 W steps of elementwise ops);
  3. column sweep: same along y.

Each round propagates labels across an entire row/column run at once, so
convergence takes O(boundary turns) rounds (2-3 for blob-like components, a
`while_loop` guarantees the fixed point in general) instead of O(diameter)
hops. Labels converge to the component's minimum linear index -- the same
labeling contract as hook-and-jump, so sizes/bboxes downstream are unchanged.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_BIG = 2**30  # python int, not jnp scalar: module-scope device constants get lifted
# as executable parameters and the jit fast path drops them on re-dispatch


def cc_round_cap() -> int | None:
    """Production propagation-round cap (RTDM_CC_MAX_ROUNDS; 0 disables).

    Real-scene masks/disparities converge in 2-4 sweeps; the cap only
    binds on adversarial inputs (dense random noise from a degraded
    sensor), whose unbounded convergence needs O(H + W) sweeps. The
    default 16 is ~4x the worst converged round count observed on real
    scenes, and bounds the speckle/CC stages' worst case at a small
    multiple of their nominal time."""
    try:
        v = int(os.environ.get("RTDM_CC_MAX_ROUNDS", "16"))
    except ValueError:
        v = 16
    return None if v <= 0 else v


def _shift_along(a: jnp.ndarray, n: int, axis: int, fill) -> jnp.ndarray:
    """Shift forward by n along axis (positive n moves content toward higher
    indices), filling with `fill`."""
    pad = [(0, 0), (0, 0)]
    if n > 0:
        pad[axis] = (n, 0)
        sl = [slice(None), slice(None)]
        sl[axis] = slice(0, a.shape[axis])
        return jnp.pad(a, pad, constant_values=fill)[tuple(sl)]
    pad[axis] = (0, -n)
    sl = [slice(None), slice(None)]
    sl[axis] = slice(-n, a.shape[axis] - n)
    return jnp.pad(a, pad, constant_values=fill)[tuple(sl)]


def _seg_min_dir(labels, start, axis: int, reverse: bool) -> jnp.ndarray:
    """Segmented prefix-min via Hillis-Steele doubling (log2 N rounds of
    shifts -- no associative_scan, whose compiled executables currently trip
    a buffer-count cache bug on the CPU backend)."""
    N = labels.shape[axis]
    m, s = labels, start
    d = 1
    sgn = -1 if reverse else 1
    while d < N:
        mm = _shift_along(m, sgn * d, axis, _BIG)
        ss = _shift_along(s, sgn * d, axis, True)
        m = jnp.where(s, m, jnp.minimum(m, mm))
        s = s | ss
        d *= 2
    return m


def _seg_min_scan(labels: jnp.ndarray, allowed: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Min label within each allowed-edge run along `axis` (both directions).

    labels: (H, W) int32. allowed: edge mask along `axis` with one fewer
    element on that axis (True = neighbors connected).
    """
    pad = [(0, 0), (0, 0)]
    pad[axis] = (1, 0)
    start_f = jnp.pad(~allowed, pad, constant_values=True)
    fwd = _seg_min_dir(labels, start_f, axis, reverse=False)

    pad[axis] = (0, 1)
    start_b = jnp.pad(~allowed, pad, constant_values=True)
    bwd = _seg_min_dir(labels, start_b, axis, reverse=True)
    return jnp.minimum(fwd, bwd)


def _shift2(a: jnp.ndarray, dy: int, dx: int, fill) -> jnp.ndarray:
    H, W = a.shape
    out = a
    if dy > 0:
        out = jnp.concatenate([jnp.full((dy, W), fill, a.dtype), out[:-dy]], 0)
    elif dy < 0:
        out = jnp.concatenate([out[-dy:], jnp.full((-dy, W), fill, a.dtype)], 0)
    if dx > 0:
        out = jnp.concatenate([jnp.full((H, dx), fill, a.dtype), out[:, :-dx]], 1)
    elif dx < 0:
        out = jnp.concatenate([out[:, -dx:], jnp.full((H, -dx), fill, a.dtype)], 1)
    return out


def connected_components_scan(
    values: jnp.ndarray,
    active: jnp.ndarray,
    max_diff,
    connectivity: int = 4,
    max_rounds: int | None = None,
) -> jnp.ndarray:
    """Labels (min linear index per component) of `active` pixels whose
    edge-adjacent values differ by <= max_diff; inactive pixels keep a unique
    self-label. connectivity: 4 (speckle/cv2.filterSpeckles) or 8
    (cv2.findContours blobs).

    max_rounds: optional cap on propagation sweeps (worst-case runtime
    bound; convergence needs one sweep per direction turn of the longest
    component "snake", so real scenes converge in 2-4 while adversarial
    noise can need O(H+W)).
    Under the cap, labels may stop short of the fixed point: every label
    group is then a connected SUBSET of its true component (propagation
    never crosses component edges), which downstream consumers must treat
    conservatively (see filter_speckles' decision argument)."""
    H, W = values.shape
    v = values.astype(jnp.int32)
    md = jnp.asarray(max_diff, jnp.int32)
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )

    allowed_h = active[:, :-1] & active[:, 1:] & (jnp.abs(v[:, :-1] - v[:, 1:]) <= md)
    allowed_v = active[:-1, :] & active[1:, :] & (jnp.abs(v[:-1, :] - v[1:, :]) <= md)
    diag = []
    if connectivity == 8:
        # edge (y, x) ~ (y+1, x+1) and (y, x+1) ~ (y+1, x)
        a_se = (
            active[:-1, :-1] & active[1:, 1:]
            & (jnp.abs(v[:-1, :-1] - v[1:, 1:]) <= md)
        )
        a_sw = (
            active[:-1, 1:] & active[1:, :-1]
            & (jnp.abs(v[:-1, 1:] - v[1:, :-1]) <= md)
        )
        diag = [a_se, a_sw]

    def hop(labels):
        """One shift-based neighborhood min (handles diagonal links)."""
        lab = jnp.where(active, labels, _BIG)
        out = lab
        l = jnp.where(allowed_h, lab[:, :-1], _BIG)
        out = jnp.concatenate([out[:, :1], jnp.minimum(out[:, 1:], l)], axis=1)
        r = jnp.where(allowed_h, lab[:, 1:], _BIG)
        out = jnp.concatenate([jnp.minimum(out[:, :-1], r), out[:, -1:]], axis=1)
        u = jnp.where(allowed_v, lab[:-1], _BIG)
        out = jnp.concatenate([out[:1], jnp.minimum(out[1:], u)], axis=0)
        d = jnp.where(allowed_v, lab[1:], _BIG)
        out = jnp.concatenate([jnp.minimum(out[:-1], d), out[-1:]], axis=0)
        if connectivity == 8:
            a_se, a_sw = diag
            se = jnp.where(a_se, lab[:-1, :-1], _BIG)  # -> (y+1, x+1)
            out = out.at[1:, 1:].min(se)
            nw = jnp.where(a_se, lab[1:, 1:], _BIG)  # -> (y, x)
            out = out.at[:-1, :-1].min(nw)
            sw = jnp.where(a_sw, lab[:-1, 1:], _BIG)  # -> (y+1, x)
            out = out.at[1:, :-1].min(sw)
            ne = jnp.where(a_sw, lab[1:, :-1], _BIG)  # -> (y, x+1)
            out = out.at[:-1, 1:].min(ne)
        return jnp.where(active, out, labels)

    def sweep(labels):
        new = labels
        if connectivity == 8:
            # the row/col scans only follow axis-aligned edges; one shift
            # hop per sweep carries labels across diagonal links
            new = hop(new)
        new = jnp.where(active, _seg_min_scan(new, allowed_h, axis=1), new)
        new = jnp.where(active, _seg_min_scan(new, allowed_v, axis=0), new)
        return new

    def body(state):
        labels, _, r = state
        # two sweeps per trip halve the while-loop round count
        new = sweep(sweep(labels))
        return new, jnp.any(new != labels), r + 2

    cap = jnp.int32(max_rounds if max_rounds is not None else 2**30)
    labels, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < cap), body, (idx, jnp.bool_(True),
                                              jnp.int32(0)))
    return labels


def connected_components_bbox(
    active: jnp.ndarray, connectivity: int = 8,
    max_rounds: int | None = None,
):
    """(labels, minx, maxx) per pixel for components of `active`.

    Bounding-box extremes are idempotent min/max aggregates, so they ride
    the same segmented-scan propagation as the labels -- no scatter; they
    converge with the labels in the same ~3 sweeps. miny/maxy come free from the label
    structure: labels are min linear indices so labels//W == miny, and the
    co-propagated max linear index //W == maxy (returned as maxidx).

    Returns (labels, maxidx, minx, maxx), each (H, W) int32; inactive pixels
    hold their self values.
    """
    H, W = active.shape
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)

    allowed_h = active[:, :-1] & active[:, 1:]
    allowed_v = active[:-1, :] & active[1:, :]
    diag = []
    if connectivity == 8:
        diag = [active[:-1, :-1] & active[1:, 1:],
                active[:-1, 1:] & active[1:, :-1]]

    def hop_many(fields):
        """Shift-based neighbor-min over all fields at once (diagonal links
        for 8-connectivity; the row/col scans cover the axis edges)."""
        outs = []
        for f in fields:
            lab = jnp.where(active, f, _BIG)
            out = lab
            l = jnp.where(allowed_h, lab[:, :-1], _BIG)
            out = jnp.concatenate([out[:, :1], jnp.minimum(out[:, 1:], l)], 1)
            r = jnp.where(allowed_h, lab[:, 1:], _BIG)
            out = jnp.concatenate([jnp.minimum(out[:, :-1], r), out[:, -1:]], 1)
            u = jnp.where(allowed_v, lab[:-1], _BIG)
            out = jnp.concatenate([out[:1], jnp.minimum(out[1:], u)], 0)
            d = jnp.where(allowed_v, lab[1:], _BIG)
            out = jnp.concatenate([jnp.minimum(out[:-1], d), out[-1:]], 0)
            if connectivity == 8:
                a_se, a_sw = diag
                se = jnp.where(a_se, lab[:-1, :-1], _BIG)
                out = out.at[1:, 1:].min(se)
                nw = jnp.where(a_se, lab[1:, 1:], _BIG)
                out = out.at[:-1, :-1].min(nw)
                sw = jnp.where(a_sw, lab[:-1, 1:], _BIG)
                out = out.at[1:, :-1].min(sw)
                ne = jnp.where(a_sw, lab[1:, :-1], _BIG)
                out = out.at[:-1, 1:].min(ne)
            outs.append(jnp.where(active, out, f))
        return outs

    def sweep(fields):
        if connectivity == 8:
            fields = hop_many(fields)
        fields = [
            jnp.where(active, _seg_min_scan(f, allowed_h, axis=1), f)
            for f in fields
        ]
        return [
            jnp.where(active, _seg_min_scan(f, allowed_v, axis=0), f)
            for f in fields
        ]

    init = (idx, -idx, xs, -xs)  # label, -maxidx, minx, -maxx

    def body(state):
        fields, _, r = state
        new = sweep(sweep(list(fields)))
        changed = False
        for a, b in zip(fields, new):
            changed = jnp.any(a != b) | changed
        return tuple(new), changed, r + 2

    cap = jnp.int32(max_rounds if max_rounds is not None else 2**30)
    (labels, neg_maxidx, minx, neg_maxx), _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < cap), body, (init, jnp.bool_(True),
                                              jnp.int32(0))
    )
    return labels, -neg_maxidx, minx, -neg_maxx


def component_small(
    labels: jnp.ndarray,
    active: jnp.ndarray,
    values: jnp.ndarray,
    max_diff,
    max_size: int,
    connectivity: int = 4,
    max_rounds: int | None = None,
) -> jnp.ndarray:
    """(H, W) bool: active pixel's component has <= max_size pixels.

    Reference behavior: cv::filterSpeckles' size test (SURVEY.md
    section 2.9a item 4). Sizes are per-label counts (component_sizes);
    max_rounds caps the propagation that hands each root's count to its
    members (cc_round_cap)."""
    sizes = component_sizes(labels, active, values=values, max_diff=max_diff,
                            connectivity=connectivity, max_rounds=max_rounds)
    return active & (sizes <= max_size)


def component_sizes(
    labels: jnp.ndarray,
    active: jnp.ndarray,
    values: jnp.ndarray = None,
    max_diff=None,
    connectivity: int = 4,
    max_rounds: int | None = None,
) -> jnp.ndarray:
    """(H, W) size of each pixel's component (0 for inactive pixels).

    Per-label totals come from one scatter-add; the per-pixel read-back is
    a gather, or, when `values`/`max_diff` describing the component edges
    are provided, a 2-3 sweep min-propagation of the root values over those
    edges (capped at max_rounds sweeps)."""
    H, W = labels.shape
    ones = active.astype(jnp.int32).reshape(-1)
    sizes = jnp.zeros(H * W, jnp.int32).at[labels.reshape(-1)].add(ones)
    sizes2d = sizes.reshape(H, W)
    if values is None:
        return jnp.where(active, sizes[labels.reshape(-1)].reshape(H, W), 0)

    # roots read their own bin elementwise (label == own linear index there)
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )
    is_root = active & (labels == idx)
    field = jnp.where(is_root, sizes2d, _BIG)

    v = values.astype(jnp.int32)
    md = jnp.asarray(max_diff, jnp.int32)
    allowed_h = active[:, :-1] & active[:, 1:] & (jnp.abs(v[:, :-1] - v[:, 1:]) <= md)
    allowed_v = active[:-1, :] & active[1:, :] & (jnp.abs(v[:-1, :] - v[1:, :]) <= md)
    if connectivity == 8:
        a_se = (active[:-1, :-1] & active[1:, 1:]
                & (jnp.abs(v[:-1, :-1] - v[1:, 1:]) <= md))
        a_sw = (active[:-1, 1:] & active[1:, :-1]
                & (jnp.abs(v[:-1, 1:] - v[1:, :-1]) <= md))

    def _diag_hop(f):
        """Min-propagate across the diagonal edges (the row/col scans only
        follow axis-aligned edges; without this a diagonal-only-connected
        pixel would keep the _BIG sentinel)."""
        lab = jnp.where(active, f, _BIG)
        out = lab
        se = jnp.where(a_se, lab[:-1, :-1], _BIG)
        out = out.at[1:, 1:].min(se)
        nw = jnp.where(a_se, lab[1:, 1:], _BIG)
        out = out.at[:-1, :-1].min(nw)
        sw = jnp.where(a_sw, lab[:-1, 1:], _BIG)
        out = out.at[1:, :-1].min(sw)
        ne = jnp.where(a_sw, lab[1:, :-1], _BIG)
        out = out.at[:-1, 1:].min(ne)
        return jnp.where(active, out, f)

    def body(state):
        f, _, r = state
        new = f if connectivity == 4 else _diag_hop(f)
        new = jnp.where(active, _seg_min_scan(new, allowed_h, axis=1), new)
        new = jnp.where(active, _seg_min_scan(new, allowed_v, axis=0), new)
        return new, jnp.any(new != f), r + 1

    cap = jnp.int32(max_rounds if max_rounds is not None else 2**30)
    field, _, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < cap), body,
        (field, jnp.bool_(True), jnp.int32(0)))
    return jnp.where(active, field, 0)
