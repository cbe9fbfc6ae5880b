"""chip_smoke.py's comparison helpers and phases at tiny sizes on the CPU.

The script itself refuses to run without an accelerator; its phase
functions are platform-agnostic and are exercised here on small frames
(the XLA path), so a broken comparison fails here before it costs a run
on the card."""

import subprocess
import sys
import os

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compare_exact():
    cs.compare_exact("a", np.arange(6), np.arange(6))
    with pytest.raises(AssertionError, match="1 of 6 elements differ"):
        cs.compare_exact("a", np.arange(6), np.r_[np.arange(5), 9])
    with pytest.raises(AssertionError, match="shape"):
        cs.compare_exact("a", np.zeros(3), np.zeros(4))


def test_compare_close_nan_pattern_and_rtol():
    a = np.array([1.0, np.nan, 3.0], np.float32)
    cs.compare_close("x", a, a * (1 + 5e-6), 1e-5)
    with pytest.raises(AssertionError, match="relative error"):
        cs.compare_close("x", a, a * (1 + 1e-3), 1e-5)
    with pytest.raises(AssertionError, match="NaN positions"):
        cs.compare_close("x", a, np.array([1.0, 2.0, 3.0]), 1e-5)


def test_compare_frames_names_the_field():
    f = dict(disparity=np.zeros((2, 2), np.int16), mask=np.ones((2, 2)),
             boxes=np.zeros((1, 5)), count=np.array([3]),
             depth_cm=np.array([np.nan]), mean_z=np.array([1.5]))
    cs.compare_frames("f", f, dict(f))
    g = dict(f, count=np.array([4]))
    with pytest.raises(AssertionError, match="f.count"):
        cs.compare_frames("f", f, g)


def test_result_line():
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = cs.result_line([Dev()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')


def test_require_accelerator_refuses_cpu():
    import jax

    with pytest.raises(SystemExit) as e:
        cs.require_accelerator(jax)
    assert e.value.code != 0


def test_script_without_accelerator_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_sgm_phase_tiny():
    engine, src, results = cs.run_engine(cs.sgm_config(96, 32, 16), frames=2)
    cs.check_sgm_vs_golden(engine, src, results, golden_frames=(0, 1))


def test_bm_phase_tiny():
    engine, src, results = cs.run_engine(cs.bm_config(128, 40, 32),
                                         frames=2)
    cs.check_bm_vs_golden(engine, src, results, golden_frames=(1,))


def test_frame_vs_cpu_phase_tiny():
    engine, src, _ = cs.run_engine(cs.sgm_config(96, 32, 16), frames=1)
    cs.check_frame_vs_cpu(engine, src)


def test_four_cards_phase_tiny():
    """The --four-cards phase on 4 of the virtual CPU devices: sharded SGM
    (exact tiling) and BM against the single-device matcher."""
    devs = cs.four_cards(W=128, H=32, D=16)
    assert len(devs) == 4
