"""The XLA SGBM cost volume vs the golden numpy cost volume (bit-exact).

Heights on and off multiples of 8, and the volume in both dtypes the
matcher streams to the aggregation kernel (int16 where it provably fits,
int32 otherwise): the cast must be lossless at these operating points."""

import numpy as np
import jax.numpy as jnp
import pytest

from rt_depth_map.golden.sgbm import sgbm_cost_volume as golden_cv
from rt_depth_map.ops.sgbm import sgbm_cost_volume


def pair(seed, H, W):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 16), dtype=np.uint8)
    return base[:, :W], base[:, 7 : 7 + W]


@pytest.mark.parametrize("H,dtype", [
    (40, jnp.int16),
    (16, jnp.int16),
    (24, jnp.int32),
    (21, jnp.int32),
])
def test_cost_volume_matches_golden(H, dtype):
    W, D, bs = 192, 64, 5
    left, right = pair(3, H, W)
    got, minX1, W1 = sgbm_cost_volume(
        jnp.asarray(left), jnp.asarray(right), D, bs, 0, 63
    )
    ref, minX1r, W1r = golden_cv(left, right, D, bs, 0, 63)
    assert (minX1, W1) == (minX1r, W1r)
    np.testing.assert_array_equal(np.asarray(got.astype(dtype)), ref)
