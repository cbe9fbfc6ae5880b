"""Speckle filter: invalidate small connected components of similar disparity.

cv::filterSpeckles parity (the final validity pass of StereoBM/StereoSGBM,
SURVEY.md section 2.9a item 4): 4-connected components where neighboring
pixels differ by <= max_diff; components of <= max_size pixels are set to
new_val.

Formulation: flood fill is inherently sequential, so connected components
are computed with the classic parallel label-propagation + pointer-jumping
scheme -- per round, every pixel takes the min label over its allowed
neighbors (hook) and then compresses paths via label = label[label] (jump).
This converges in O(log(diameter)) rounds inside a `lax.while_loop`, keeping
the whole pass on-device with static shapes. Component sizes come from a
segment-sum over final labels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = 2**30  # python int, not jnp scalar: module-scope device constants get lifted
# as executable parameters and the jit fast path drops them on re-dispatch


def _neighbor_min(labels: jnp.ndarray, allowed_h: jnp.ndarray, allowed_v: jnp.ndarray) -> jnp.ndarray:
    """Min label over 4-neighbors along allowed edges.

    allowed_h: (H, W-1) edge mask between (y,x) and (y,x+1)
    allowed_v: (H-1, W) edge mask between (y,x) and (y+1,x)
    """
    out = labels
    # left neighbor -> right
    l = jnp.where(allowed_h, labels[:, :-1], _BIG)
    out = jnp.concatenate([out[:, :1], jnp.minimum(out[:, 1:], l)], axis=1)
    # right neighbor -> left
    r = jnp.where(allowed_h, labels[:, 1:], _BIG)
    out = jnp.concatenate([jnp.minimum(out[:, :-1], r), out[:, -1:]], axis=1)
    # up neighbor -> down
    u = jnp.where(allowed_v, labels[:-1, :], _BIG)
    out = jnp.concatenate([out[:1, :], jnp.minimum(out[1:, :], u)], axis=0)
    # down neighbor -> up
    d = jnp.where(allowed_v, labels[1:, :], _BIG)
    out = jnp.concatenate([jnp.minimum(out[:-1, :], d), out[-1:, :]], axis=0)
    return out


def connected_components(
    values: jnp.ndarray, active: jnp.ndarray, max_diff: jnp.ndarray
) -> jnp.ndarray:
    """Label 4-connected components of `active` pixels whose neighboring
    values differ by <= max_diff. Returns int32 labels (min linear index of
    the component); inactive pixels get a unique self-label."""
    H, W = values.shape
    v = values.astype(jnp.int32)
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )
    allowed_h = (
        active[:, :-1]
        & active[:, 1:]
        & (jnp.abs(v[:, :-1] - v[:, 1:]) <= max_diff)
    )
    allowed_v = (
        active[:-1, :]
        & active[1:, :]
        & (jnp.abs(v[:-1, :] - v[1:, :]) <= max_diff)
    )

    def body(state):
        labels, _ = state
        new = _neighbor_min(labels, allowed_h, allowed_v)
        # pointer jumping: compress label chains
        flat = new.reshape(-1)
        for _ in range(2):
            flat = jnp.minimum(flat, flat[flat])
        new = flat.reshape(H, W)
        return new, jnp.any(new != labels)

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(cond, body, (idx, jnp.bool_(True)))
    return labels


def filter_speckles(
    disp: jnp.ndarray,
    new_val: int,
    max_size: int,
    max_diff: int,
) -> jnp.ndarray:
    """cv::filterSpeckles parity on an int disparity map (x16 units).

    Uses the gather-free segmented-scan CC (ops/cc.py); the hook+pointer-
    jump labeling (connected_components above) is kept for reference and
    tests. Only the size DECISION is needed (ops/cc.py component_small).

    Worst-case bound (cc_round_cap): both propagation passes (labels,
    then the root-size broadcast) are capped at RTDM_CC_MAX_ROUNDS
    sweeps. Decision semantics under the cap: a capped label field
    sub-partitions every true component (propagation never crosses
    component edges), so per-label pixel counts are <= the true
    component size and the size test `count <= max_size` flips only
    toward MORE invalidation wherever the decision broadcast reaches
    (tests/test_speckle_cap.py asserts this on a snake); pixels beyond
    the broadcast's capped reach keep their value. Real scenes converge
    inside the default cap (bit-exact -- the accuracy suite runs with it
    active); only adversarial noise frames degrade, bounded, instead of
    stalling the pipeline for hundreds of frame periods."""
    from rt_depth_map.ops.cc import (
        cc_round_cap,
        component_small,
        connected_components_scan,
    )

    cap = cc_round_cap()
    active = disp != new_val
    labels = connected_components_scan(disp, active, jnp.int32(max_diff), 4,
                                       max_rounds=cap)
    small = component_small(
        labels, active, values=disp, max_diff=max_diff, max_size=max_size,
        connectivity=4, max_rounds=cap,
    )
    return jnp.where(small, jnp.asarray(new_val, disp.dtype), disp)
