"""Recorded-sequence source round-trip and committed-golden regression.

SURVEY.md section 4: the reference ships no recorded data, so sequences are
synthesized by seed; the files source must reproduce the synthetic frames it
recorded, and the full matcher output at a pinned seed acts as a regression
golden (deterministic: integer arithmetic, backend-bit-exact paths)."""

import os

import numpy as np
import pytest

from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.pipeline import Engine
from rt_depth_map.sources import FileSequenceSource, SyntheticStereoSource


def test_file_sequence_roundtrip(tmp_path):
    cv2 = pytest.importorskip("cv2")
    src = SyntheticStereoSource(160, 120, seed=11)
    for i in range(3):
        left, right, _, _ = src.render(i)
        cv2.imwrite(str(tmp_path / f"left_{i:03d}.png"), left[..., ::-1])
        cv2.imwrite(str(tmp_path / f"right_{i:03d}.png"), right[..., ::-1])

    fsrc = FileSequenceSource(str(tmp_path))
    assert (fsrc.width, fsrc.height) == (160, 120)
    assert len(fsrc) == 3
    lf, rf = fsrc.grab()
    l0, r0, _, _ = src.render(0)
    np.testing.assert_array_equal(lf.array, l0)  # png is lossless
    np.testing.assert_array_equal(rf.array, r0)
    # loops at the end
    fsrc.grab()
    fsrc.grab()
    lf2, _ = fsrc.grab()
    np.testing.assert_array_equal(lf2.array, l0)


def test_file_sequence_drives_engine(tmp_path):
    cv2 = pytest.importorskip("cv2")
    src = SyntheticStereoSource(160, 120, seed=11)
    for i in range(2):
        left, right, _, _ = src.render(i)
        cv2.imwrite(str(tmp_path / f"left_{i:03d}.png"), left[..., ::-1])
        cv2.imwrite(str(tmp_path / f"right_{i:03d}.png"), right[..., ::-1])
    cfg = EngineConfig(
        width=160, height=120, number_of_disparities=32,
        source="files", source_path=str(tmp_path),
        matcher=MatcherConfig(num_disparities=32, block_size=9),
    )
    eng = Engine(cfg)
    r = eng.step()
    assert r is not None and r.disparity.shape == (120, 160)


GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "bm_qvga_seed7.npz")


def test_matcher_regression_golden():
    """Disparity at a pinned config/seed must not drift (integer matcher ==
    deterministic). Regenerate goldens only for intentional semantic changes:
    python tests/test_sources_roundtrip.py --regen"""
    import jax.numpy as jnp

    from rt_depth_map.ops.bm import stereo_bm

    src = SyntheticStereoSource(320, 240, seed=7)
    left, right, _, _ = src.render(0)
    import cv2

    lg = cv2.cvtColor(left, cv2.COLOR_RGB2GRAY)
    rg = cv2.cvtColor(right, cv2.COLOR_RGB2GRAY)
    disp = np.asarray(
        stereo_bm(jnp.asarray(lg), jnp.asarray(rg),
                  MatcherConfig(num_disparities=64, block_size=13,
                                backend="xla"))
    )
    if not os.path.exists(GOLDEN):
        pytest.skip("golden not committed yet")
    ref = np.load(GOLDEN)["disparity"]
    np.testing.assert_array_equal(disp, ref)


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        import cv2
        import jax.numpy as jnp

        from rt_depth_map.ops.bm import stereo_bm

        src = SyntheticStereoSource(320, 240, seed=7)
        left, right, _, _ = src.render(0)
        lg = cv2.cvtColor(left, cv2.COLOR_RGB2GRAY)
        rg = cv2.cvtColor(right, cv2.COLOR_RGB2GRAY)
        disp = np.asarray(
            stereo_bm(jnp.asarray(lg), jnp.asarray(rg),
                      MatcherConfig(num_disparities=64, block_size=13,
                                    backend="xla"))
        )
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez_compressed(GOLDEN, disparity=disp)
        print("golden written:", GOLDEN)
