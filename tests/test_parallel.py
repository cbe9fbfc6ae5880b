"""Multi-device sharding tests on the virtual 8-CPU-device mesh.

Numerics invariant (SURVEY.md section 4 item 4): the N-way tiled matcher must
be bit-identical to the single-device path (integer cost arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.bm import stereo_bm
from rt_depth_map.parallel import make_mesh, tiled_stereo_bm


def stereo_pair(seed, H, W, shift):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H, W + 64), dtype=np.uint8).astype(np.float32)
    k = np.ones(5) / 5.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = base.astype(np.uint8)
    return base[:, :W].copy(), base[:, shift : shift + W].copy()


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize(
    "n_space", [2, pytest.param(4, marks=pytest.mark.slow)]
)
def test_tiled_bm_bit_exact(n_space):
    left, right, = stereo_pair(0, 64, 256, 7)
    cfg = MatcherConfig(num_disparities=32, block_size=9)
    ref = np.asarray(stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg))
    mesh = make_mesh((1, n_space), devices=jax.devices()[: n_space])
    out = np.asarray(
        tiled_stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg, mesh)
    )
    np.testing.assert_array_equal(out, ref)


def test_tiled_bm_pallas_lr_in_shard_map():
    """The BM LR check (n_w=D+1, Dpow=8192 keys) and speckle filter run
    INSIDE the shard_map tile program and must keep the tile-vs-single
    bit parity."""
    left, right = stereo_pair(3, 16, 256, 7)
    cfg = MatcherConfig(
        num_disparities=16, block_size=9,
        disp12_max_diff=1, speckle_window_size=50, speckle_range=32,
    )
    ref = np.asarray(stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg))
    mesh = make_mesh((1, 2), devices=jax.devices()[:2])
    out = np.asarray(
        tiled_stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg, mesh)
    )
    np.testing.assert_array_equal(out, ref)


def test_tiled_bm_halo_guard():
    left, right = stereo_pair(1, 32, 128, 5)
    cfg = MatcherConfig(num_disparities=64, block_size=9)
    mesh = make_mesh((1, 8))
    with pytest.raises(ValueError, match="halo"):
        tiled_stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg, mesh)


def test_data_parallel_batch_sharding():
    """DP: a batch of frames sharded over the data axis, vmapped matcher."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = MatcherConfig(num_disparities=16, block_size=5, speckle_window_size=0)
    lefts, rights = [], []
    for s in range(4):
        l, r = stereo_pair(s, 32, 96, 4)
        lefts.append(l)
        rights.append(r)
    L = jnp.asarray(np.stack(lefts))
    R = jnp.asarray(np.stack(rights))
    mesh = make_mesh((4, 2))
    shard = NamedSharding(mesh, P("data", None, None))
    Ls = jax.device_put(L, shard)
    Rs = jax.device_put(R, shard)

    fn = jax.jit(jax.vmap(lambda a, b: stereo_bm(a, b, cfg)))
    out = fn(Ls, Rs)
    ref = fn(L, R)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_sharded_pipeline_sgm_matches_engine():
    """The full sharded pipeline with the SGM matcher in the tile slot
    (the matcher slot must be swappable like the reference's
    BlockMatcher wiring, stereo-matcher.h:13-19) vs the single-device
    Engine program, within the overlap-tiling budget."""
    from rt_depth_map.config import EngineConfig
    from rt_depth_map.parallel.pipeline_sharded import make_sharded_step
    from rt_depth_map.pipeline import Engine
    from rt_depth_map.sources import SyntheticStereoSource

    W, H, D = 640, 48, 32
    cfg = EngineConfig(
        width=W, height=H, number_of_disparities=D, minimal_object_size=10,
        matcher=MatcherConfig(
            kind="sgm", num_disparities=D, block_size=5, num_paths=8,
            pre_filter_cap=0, speckle_window_size=25, speckle_range=32,
            disp12_max_diff=1,
        ),
    )
    src = SyntheticStereoSource(W, H, seed=3, num_objects=1)
    mesh = make_mesh((2, 4))
    step, sharding = make_sharded_step(mesh, cfg, (W, H), Q=src.q_matrix())

    B = 2
    frames = [src.render(i)[:2] for i in range(B)]
    L = jax.device_put(np.stack([f[0] for f in frames]), sharding)
    R = jax.device_put(np.stack([f[1] for f in frames]), sharding)
    out = step(L, R)

    engine = Engine(cfg, source=src)
    for i in range(B):
        ref = engine.process_pair(*frames[i])
        got = np.asarray(out["disparity"][i])
        # overlap-tiled SGM is near-exact: both-valid disagreement stays
        # well inside the judged <=1% bad-pixel budget
        diff = got.astype(np.int32) - ref.disparity.astype(np.int32)
        frac = (np.abs(diff) > 16).mean()
        assert frac < 0.01, frac
        np.testing.assert_array_equal(
            np.asarray(out["boxes"][i]), ref.boxes
        )


def test_sharded_pipeline_sgm_exact_mode_bit_exact():
    """tile_mode="exact" routes the sharded matcher slot through
    parallel/exact_sgbm.py: the full sharded pipeline's disparity must be
    BIT-identical to the single-device Engine."""
    from rt_depth_map.config import EngineConfig
    from rt_depth_map.parallel.pipeline_sharded import make_sharded_step
    from rt_depth_map.pipeline import Engine
    from rt_depth_map.sources import SyntheticStereoSource

    W, H, D = 320, 32, 32
    cfg = EngineConfig(
        width=W, height=H, number_of_disparities=D, minimal_object_size=10,
        matcher=MatcherConfig(
            kind="sgm", num_disparities=D, block_size=5, num_paths=8,
            pre_filter_cap=0, speckle_window_size=25, speckle_range=32,
            disp12_max_diff=1, tile_mode="exact",
        ),
    )
    src = SyntheticStereoSource(W, H, seed=5, num_objects=1)
    mesh = make_mesh((2, 4))
    step, sharding = make_sharded_step(mesh, cfg, (W, H), Q=src.q_matrix())

    frames = [src.render(i)[:2] for i in range(2)]
    L = jax.device_put(np.stack([f[0] for f in frames]), sharding)
    R = jax.device_put(np.stack([f[1] for f in frames]), sharding)
    out = step(L, R)

    engine = Engine(cfg, source=src)
    for i in range(2):
        ref = engine.process_pair(*frames[i])
        np.testing.assert_array_equal(
            np.asarray(out["disparity"][i]), ref.disparity
        )
        np.testing.assert_array_equal(
            np.asarray(out["boxes"][i]), ref.boxes
        )


@pytest.mark.slow
def test_dryrun_stretch_executes():
    """BASELINE.md stretch row (8-camera rig, 1080p-width, 256 disparities)
    must keep compiling and running on the virtual mesh; the driver only
    exercises dryrun_multichip, so pin the stretch config here."""
    import __graft_entry__ as g

    g.dryrun_stretch(8)
