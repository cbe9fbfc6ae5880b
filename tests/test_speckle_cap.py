"""Worst-case bound for the CC propagation (RTDM_CC_MAX_ROUNDS).

The speckle filter's label propagation converges in O(direction turns)
sweeps -- unbounded on adversarial input (dense random noise).
Production caps the sweeps; these tests pin the DECISION
semantics under the cap:

  1. a capped label field sub-partitions the true components (no label
     group ever spans two true components);
  2. the speckle decision under the cap only moves toward MORE
     invalidation (each fragment's size <= its true component's size);
  3. the default cap is invisible on converging input (bit-exact).
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from rt_depth_map.ops.cc import connected_components_scan  # noqa: E402
from rt_depth_map.ops.speckle import filter_speckles  # noqa: E402


def _snake(H=64, W=96, arms=8):
    """Serpentine one-component path: needs ~one sweep per turn, so a
    tiny round cap is guaranteed to stop short of the fixed point."""
    disp = np.full((H, W), -16, np.int16)  # background = invalid
    step = H // arms
    for a in range(arms):
        y = a * step
        disp[y, :] = 32
        if a + 1 < arms:
            col = W - 1 if a % 2 == 0 else 0
            disp[y : y + step + 1, col] = 32
    return jnp.asarray(disp)


def test_capped_labels_subpartition_components():
    disp = _snake()
    active = disp != -16
    full = np.asarray(connected_components_scan(disp, active, 0, 4))
    capped = np.asarray(
        connected_components_scan(disp, active, 0, 4, max_rounds=2))
    act = np.asarray(active)
    assert not np.array_equal(full[act], capped[act]), (
        "cap did not bind; tighten the snake")
    # every capped label group must lie inside ONE true component
    for lab in np.unique(capped[act]):
        sel = act & (capped == lab)
        assert len(np.unique(full[sel])) == 1


def test_capped_decision_only_adds_invalidation(monkeypatch):
    disp = _snake()
    INVALID = -16
    ref = np.asarray(filter_speckles(disp, INVALID, 100, 32 * 16))
    monkeypatch.setenv("RTDM_CC_MAX_ROUNDS", "2")
    capped = np.asarray(filter_speckles(disp, INVALID, 100, 32 * 16))
    ref_inv = ref == INVALID
    cap_inv = capped == INVALID
    # capped invalidation is a superset; surviving pixels keep their value
    assert np.all(ref_inv <= cap_inv)
    keep = ~cap_inv
    np.testing.assert_array_equal(capped[keep], np.asarray(disp)[keep])


def test_default_cap_invisible_on_converging_input(monkeypatch):
    rng = np.random.default_rng(7)
    # blobby disparity: a few rectangles over invalid background
    disp = np.full((64, 96), -16, np.int16)
    for _ in range(6):
        y, x = rng.integers(0, 48), rng.integers(0, 72)
        h, w = rng.integers(3, 16, 2)
        disp[y : y + h, x : x + w] = rng.integers(0, 64) * 16
    disp = jnp.asarray(disp)
    monkeypatch.setenv("RTDM_CC_MAX_ROUNDS", "0")  # unbounded
    ref = np.asarray(filter_speckles(disp, -16, 100, 32 * 16))
    monkeypatch.delenv("RTDM_CC_MAX_ROUNDS")
    out = np.asarray(filter_speckles(disp, -16, 100, 32 * 16))
    np.testing.assert_array_equal(ref, out)
