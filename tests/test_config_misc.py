"""Config persistence, metrics module, logging, engine health checks."""

import numpy as np
import pytest

from rt_depth_map.config import EngineConfig, MatcherConfig
from rt_depth_map.metrics import (
    bad_pixel_fraction,
    disparity_report,
    validity_difference,
)


def test_config_yaml_roundtrip(tmp_path):
    cfg = EngineConfig(
        width=640, height=480, number_of_disparities=96, object_color="blue",
        matcher=MatcherConfig(kind="sgm", num_paths=4, p2=999),
    )
    path = str(tmp_path / "engine.yml")
    cfg.save(path)
    back = EngineConfig.load(path)
    assert back == cfg
    assert back.matcher.p2 == 999


def test_metrics_bad_pixel():
    ref = np.full((10, 10), 160, np.int16)
    d = ref.copy()
    d[0, :5] = 160 + 32  # 2 px off -> bad
    d[1, :2] = -16  # invalid
    frac = bad_pixel_fraction(d, ref)
    assert abs(frac - 5 / 98) < 1e-9
    assert abs(validity_difference(d, ref) - 2 / 100) < 1e-9
    rep = disparity_report(d, ref)
    assert rep["valid_fraction"] == 0.98


def test_engine_stream_health_fault():
    from rt_depth_map.pipeline import Engine
    from rt_depth_map.sources.base import StereoFrame

    class DeadSource:
        width, height, rectified = 64, 48, True

        def grab(self):
            bad = StereoFrame(encoding="mjpeg", data=b"\xff\xd8junk")
            return bad, bad

        def close(self):
            pass

    cfg = EngineConfig(width=64, height=48, number_of_disparities=16,
                       matcher=MatcherConfig(num_disparities=16, block_size=5))
    eng = Engine(cfg, source=DeadSource())
    eng.max_consecutive_decode_failures = 5
    with pytest.raises(RuntimeError, match="unhealthy"):
        for _ in range(10):
            eng.step()


def test_distributed_init_noop_without_env(monkeypatch):
    from rt_depth_map.parallel.launch import distributed_init

    monkeypatch.delenv("RTDM_COORDINATOR", raising=False)
    assert distributed_init() is False


def test_intrinsics_resolution_override_semantics():
    """The intrinsics-file resolution overrides capture/pipeline size while
    the CLI-configured size stays the scaling denominator
    (main.cpp:87-90,116 + cmdline-parser.h:80-89): a 320x240 calibration
    under the default 1280-wide config must yield D=192*320/1280=48."""
    from rt_depth_map.calib import compute_rectification
    from rt_depth_map.sources import make_source

    rect = compute_rectification(
        "/root/reference/backup/320x240/intrinsics.yml",
        "/root/reference/backup/320x240/extrinsics.yml",
        (1280, 720),
    )
    assert rect.image_size == (320, 240)
    cfg = EngineConfig(capture_width=320, capture_height=240)
    src = make_source(cfg)
    assert (src.width, src.height) == (320, 240)
    # derived values scale from the configured size to the actual one
    assert cfg.scaled_num_disparities(src.width) == 48
    assert cfg.scaled_min_object_size(src.width, src.height) == 8


def test_cli_applies_intrinsics_override(monkeypatch):
    """config_from_args + the CLI override path set capture_* (not width),
    so Engine sees the calibrated size and scaling stays reference-exact."""
    from rt_depth_map import cli

    args = cli.build_parser().parse_args(
        ["-i", "/root/reference/backup/320x240/intrinsics.yml",
         "-e", "/root/reference/backup/320x240/extrinsics.yml"]
    )
    cfg = cli.config_from_args(args)
    assert (cfg.width, cfg.height) == (1280, 720)
    from rt_depth_map.calib import compute_rectification

    rect = compute_rectification(
        args.intrinsics_file_name, args.extrinsics_file_name,
        (cfg.width, cfg.height),
    )
    cfg = cfg.replace(capture_width=rect.image_size[0],
                      capture_height=rect.image_size[1])
    roundtrip = EngineConfig.from_dict(cfg.to_dict())
    assert roundtrip.capture_width == 320 and roundtrip.capture_height == 240
import os
def test_compile_cache_dir_env_wins(monkeypatch):
    from rt_depth_map.utils.compile_cache import compile_cache_dir

    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x"}) is None


def test_compile_cache_dir_defaults_to_checkout():
    from rt_depth_map.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.compile_cache_dir({}) == os.path.join(
        repo, ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_enable_compile_cache(monkeypatch, tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, nothing is configured in code;
    without it, the checkout directory is."""
    import jax

    from rt_depth_map.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.enable_compile_cache()
            assert got == compile_cache.CHECKOUT_CACHE_DIR
            assert jax.config.jax_compilation_cache_dir == got
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            assert compile_cache.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir is None
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_golden_sgbm_rejects_unknown_mode():
    import numpy as np

    from rt_depth_map.golden.sgbm import golden_stereo_sgbm

    z = np.zeros((8, 40), np.uint8)
    with pytest.raises(ValueError, match="unknown SGBM mode"):
        golden_stereo_sgbm(z, z, 16, mode="hh8")


def test_filestorage_without_yaml_raises_import_error(monkeypatch, tmp_path):
    import sys

    from rt_depth_map.calib import fs_yaml

    f = tmp_path / "x.yml"
    f.write_text("%YAML:1.0\na: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        fs_yaml.read_filestorage(str(f))
