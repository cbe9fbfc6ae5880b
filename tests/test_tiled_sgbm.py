"""Width-tiled SGM on the virtual device mesh: overlap approximation stays
far inside the <=1% bad-pixel budget vs the single-device matcher."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import stereo_sgbm
from rt_depth_map.parallel import make_mesh
from rt_depth_map.parallel.tiled_sgbm import tiled_stereo_sgbm

INVALID = -16


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8).astype(np.float32)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


@pytest.mark.parametrize(
    "n_space",
    [2, pytest.param(4, marks=pytest.mark.slow)],  # the 4-tile shard_map
    # compile alone is ~2min on the CPU mesh; 2 tiles covers the halo logic
)
def test_tiled_sgbm_within_budget(n_space):
    left, right = stereo_pair(0, 64, 512, 9)
    cfg = MatcherConfig(kind="sgm", num_disparities=32, block_size=5,
                        num_paths=8, pre_filter_cap=0, backend="xla")
    ref = np.asarray(stereo_sgbm(jnp.asarray(left), jnp.asarray(right), cfg))
    mesh = make_mesh((1, n_space), devices=jax.devices()[:n_space])
    out = np.asarray(
        tiled_stereo_sgbm(jnp.asarray(left), jnp.asarray(right), cfg, mesh,
                          margin=48)
    )
    both = (ref != INVALID) & (out != INVALID)
    bad = (np.abs(ref.astype(int) - out.astype(int)) > 16) & both
    bad_frac = bad.sum() / max(both.sum(), 1)
    validity_diff = ((ref != INVALID) != (out != INVALID)).mean()
    assert bad_frac < 0.002, bad_frac  # 5x inside the 1% budget
    assert validity_diff < 0.01, validity_diff


def test_tiled_sgbm_halo_guard():
    left, right = stereo_pair(1, 32, 256, 5)
    cfg = MatcherConfig(kind="sgm", num_disparities=64, block_size=5,
                        num_paths=4, pre_filter_cap=0, backend="xla")
    mesh = make_mesh((1, 8))
    with pytest.raises(ValueError, match="halo"):
        tiled_stereo_sgbm(jnp.asarray(left), jnp.asarray(right), cfg, mesh)
