"""The GPU SGM aggregation kernel (ops/sgm_kernel.py) against the XLA scans.

The kernel runs here in Pallas interpret mode; its compiled form is checked
on the card by chip_smoke.py. Every case must be bit-exact with
`ops.sgbm._aggregate_dir` / `aggregate_cost`, including ragged disparity
counts (D padded to the next power of two with masks), both volume dtypes,
every path count and min_disparity != 0. Shapes stay small (H <= 24,
W1 <= 64): interpret mode runs every block in turn.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import (
    _aggregate_dir,
    aggregate_cost,
    sgbm_cost_volume,
    sgm_directions,
    stereo_sgbm,
)
from rt_depth_map.ops.sgm_kernel import (
    aggregate_cost_pallas,
    aggregate_dir_pallas,
    sgm_kernel_selected,
)

P1, P2 = 200, 801
DIRECTIONS = sgm_directions(8)


def _volume(seed, H, W1, D, dtype):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(0, 2300, (H, W1, D)), dtype)


@pytest.mark.parametrize("D", [48, 80])
@pytest.mark.parametrize("dtype", [jnp.int16, jnp.int32])
@pytest.mark.parametrize("dy,dx", DIRECTIONS)
def test_kernel_direction_matches_xla(dy, dx, dtype, D):
    H, W1 = 12, 40
    C = _volume(D + dy * 3 + dx, H, W1, D, dtype)
    ref = _aggregate_dir(C.astype(jnp.int32), P1, P2, dy, dx)
    got = aggregate_dir_pallas(C, None, P1, P2, dy, dx, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("num_paths", [4, 5, 8])
@pytest.mark.parametrize("min_disp", [0, -3, 4])
def test_kernel_paths_and_min_disparity(num_paths, min_disp):
    """Real BT cost volumes at min_disparity != 0 (the aggregation does not
    depend on minD, the volume it reads does)."""
    rng = np.random.default_rng(num_paths * 7 + min_disp)
    base = rng.integers(0, 256, (16, 96), dtype=np.uint8)
    left = jnp.asarray(base[:, :80])
    right = jnp.asarray(base[:, 5:85])
    C, _, _ = sgbm_cost_volume(left, right, 24, 5, min_disp, 15)
    ref = aggregate_cost(C, 600, 2400, num_paths)
    got = aggregate_cost_pallas(C.astype(jnp.int16), 600, 2400, num_paths,
                                interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.parametrize("H,W1", [(9, 21), (1, 17), (20, 3)])
def test_kernel_odd_shapes(H, W1):
    """Odd sizes, a single row and a volume taller than wide: diagonal
    chains that enter and leave the image at every step."""
    C = _volume(H * W1, H, W1, 16, jnp.int16)
    ref = aggregate_cost(C.astype(jnp.int32), P1, P2, 8)
    got = aggregate_cost_pallas(C, P1, P2, 8, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_kernel_accumulates_into_partial_sum():
    C = _volume(3, 8, 24, 16, jnp.int16)
    S0 = _volume(4, 8, 24, 16, jnp.int32)
    ref = S0 + _aggregate_dir(C.astype(jnp.int32), P1, P2, 1, -1)
    got = aggregate_dir_pallas(C, S0, P1, P2, 1, -1, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


# -- the route: one function decides kernel vs XLA -------------------------

@pytest.mark.parametrize("platform,backend,want", [
    ("cpu", "auto", False),
    ("cpu", "xla", False),
    ("gpu", "auto", True),
    ("gpu", "xla", False),
    ("gpu", "pallas", True),
])
def test_route_table(platform, backend, want):
    assert sgm_kernel_selected(backend, platform) is want


def test_route_pallas_off_gpu_raises():
    with pytest.raises(ValueError, match="needs a GPU"):
        sgm_kernel_selected("pallas", "cpu")


def test_route_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown matcher backend"):
        sgm_kernel_selected("mosaic", "gpu")


def test_stereo_sgbm_pallas_backend_raises_on_cpu():
    z = jnp.zeros((16, 64), jnp.uint8)
    cfg = MatcherConfig(kind="sgm", num_disparities=16, block_size=5,
                        backend="pallas")
    with pytest.raises(ValueError, match="needs a GPU"):
        stereo_sgbm(z, z, cfg)
