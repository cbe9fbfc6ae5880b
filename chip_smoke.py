"""Smoke test of the stereo depth pipeline on one NVIDIA GPU.

Drives the main path the way the CLI and bench.py do (EngineConfig +
SyntheticStereoSource raw frames -> Engine's jitted frame program) at full
width, and checks what comes out against the repository's references:

  1. card and environment: the nvidia-smi name/power-limit line, the JAX
     devices and version, which optional host modules import;
  2. SGM flagship (1280x720, D=128, 8 paths): 5 frames through Engine; the
     compiled SGM aggregation kernel against the XLA scans (S bit-exact),
     and the card's disparity against golden_stereo_sgbm on the rectified
     planes the card produced (bit-exact);
  3. BM reference default (1280x720, StereoBM 13x13, D=192): 5 frames
     through Engine; the card's disparity against golden_stereo_bm (with
     its LR check and speckle filter) on the card's rectified planes and
     the detection ROI the card computed (bit-exact);
  4. the whole SGM frame program on the card against the same program on
     the host CPU: disparity, mask, boxes and count equal; depth_cm and
     mean_z within rtol 1e-5 (float32 reductions: summation order and FMA
     contraction may move the last bits).

`--four-cards` runs only the sharded step on four GPUs instead: a
(data=2, space=2) mesh, 4 streams at 1280x720, SGM-128 8-path with the
exact wavefront tiling and BM-128, every frame bit-exact against the
single-device matcher.

Any mismatch or error exits non-zero. The last stdout line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}. With no
accelerator the script exits non-zero before printing any result.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

EXACT_KEYS = ("disparity", "mask", "boxes", "count")
CLOSE_KEYS = ("depth_cm", "mean_z")
FRAMES = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def require_accelerator(jax) -> None:
    """Exit non-zero (no result printed) when JAX runs on the CPU."""
    if jax.default_backend() == "cpu":
        print("chip_smoke: JAX found no accelerator", file=sys.stderr)
        raise SystemExit(2)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def compare_exact(name: str, got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    bad = int(np.count_nonzero(got != want))
    if bad:
        raise AssertionError(f"{name}: {bad} of {got.size} elements differ")


def compare_close(name: str, got, want, rtol: float) -> None:
    """Equal NaN pattern, finite values within rtol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f"{name}: NaN positions differ")
    fin = ~np.isnan(want)
    if not np.allclose(got[fin], want[fin], rtol=rtol, atol=0.0):
        worst = np.max(np.abs(got[fin] - want[fin])
                       / np.maximum(np.abs(want[fin]), 1e-30))
        raise AssertionError(f"{name}: relative error {worst:.3g} > {rtol}")


def compare_frames(name: str, got: dict, want: dict,
                   rtol: float = 1e-5) -> None:
    for k in EXACT_KEYS:
        compare_exact(f"{name}.{k}", got[k], want[k])
    for k in CLOSE_KEYS:
        compare_close(f"{name}.{k}", got[k], want[k], rtol)


def result_line(devices) -> str:
    d0 = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(devices)}})


def sgm_config(W: int = 1280, H: int = 720, D: int = 128):
    from rt_depth_map.config import EngineConfig, MatcherConfig

    return EngineConfig(
        width=W, height=H, number_of_disparities=D,
        matcher=MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                              num_paths=8, pre_filter_cap=0))


def bm_config(W: int = 1280, H: int = 720, D: int = 192):
    """The reference default: StereoBM 13x13, D=192 width-scaled."""
    from rt_depth_map.config import EngineConfig

    return EngineConfig(width=W, height=H, number_of_disparities=D)


def run_engine(cfg, frames: int = FRAMES):
    """(engine, source, [FrameResult]) after `frames` frames of Engine.run
    on raw synthetic frames (seed 0)."""
    from rt_depth_map.pipeline import Engine
    from rt_depth_map.sources import SyntheticStereoSource

    src = SyntheticStereoSource(cfg.width, cfg.height, seed=0)
    engine = Engine(cfg, source=src)
    t_compile = engine.warmup()
    results = []
    t0 = time.perf_counter()
    engine.run(frames=frames, on_frame=lambda i, r: results.append(r),
               print_stats_on_sigint=False)
    dt = time.perf_counter() - t0
    log(f"  engine: compile {t_compile:.1f}s, {frames} frames in {dt:.3f}s")
    if len(results) != frames:
        raise AssertionError(f"engine returned {len(results)} of {frames}")
    return engine, src, results


def rectified_planes(engine, left_rgb, right_rgb):
    """(left gray, right gray, matcher ROI) as the card's pre stage made
    them for one frame."""
    import jax
    import jax.numpy as jnp

    lrect, rrect, _, _, _, mroi = jax.jit(engine._frame_fn.pre_fn)(
        jnp.asarray(left_rgb), jnp.asarray(right_rgb),
        jnp.asarray(engine.hsv_low), jnp.asarray(engine.hsv_high),
        jnp.int32(engine.min_object_size))
    return (np.asarray(lrect), np.asarray(rrect),
            tuple(int(v) for v in mroi))


def check_sgm_vs_golden(engine, src, results, golden_frames=(0,)) -> None:
    """Engine disparity == stereo_sgbm on the card's rectified planes ==
    golden_stereo_sgbm on the same planes."""
    import jax

    from rt_depth_map.golden.sgbm import golden_stereo_sgbm
    from rt_depth_map.ops.sgbm import stereo_sgbm

    m = engine.matcher_config
    match = jax.jit(lambda l, r: stereo_sgbm(l, r, m))
    mode = {8: "hh", 5: "sgbm", 4: "sgbm4"}[m.num_paths]
    for i in golden_frames:
        left, right = src.render(i)[:2]
        lrect, rrect, _ = rectified_planes(engine, left, right)
        disp = np.asarray(match(lrect, rrect))
        compare_exact(f"sgm frame {i} engine vs stereo_sgbm",
                      results[i].disparity, disp)
        t0 = time.perf_counter()
        ref = golden_stereo_sgbm(
            lrect, rrect, m.num_disparities, m.block_size,
            min_disparity=m.min_disparity, p1=m.p1, p2=m.p2,
            uniqueness_ratio=m.uniqueness_ratio,
            speckle_window_size=m.speckle_window_size,
            speckle_range=m.speckle_range,
            disp12_max_diff=m.disp12_max_diff,
            pre_filter_cap=m.pre_filter_cap, mode=mode)
        compare_exact(f"sgm frame {i} card vs golden", disp, ref)
        log(f"  sgm frame {i}: bit-exact vs golden_stereo_sgbm "
            f"({(ref != (m.min_disparity - 1) * 16).mean():.3f} valid, "
            f"golden {time.perf_counter() - t0:.1f}s)")


def check_bm_vs_golden(engine, src, results, golden_frames=(0,)) -> None:
    """Engine disparity == golden_stereo_bm (LR check + speckle included)
    on the card's rectified planes with the ROI the card detected."""
    from rt_depth_map.golden import golden_stereo_bm

    m = engine.matcher_config
    for i in golden_frames:
        left, right = src.render(i)[:2]
        lrect, rrect, mroi = rectified_planes(engine, left, right)
        t0 = time.perf_counter()
        ref = golden_stereo_bm(
            lrect, rrect, m.num_disparities, m.block_size,
            min_disparity=m.min_disparity, pre_filter_cap=m.pre_filter_cap,
            texture_threshold=m.texture_threshold,
            uniqueness_ratio=m.uniqueness_ratio,
            speckle_window_size=m.speckle_window_size,
            speckle_range=m.speckle_range,
            disp12_max_diff=m.disp12_max_diff, roi1=mroi)
        compare_exact(f"bm frame {i} card vs golden", results[i].disparity,
                      ref)
        log(f"  bm frame {i}: bit-exact vs golden_stereo_bm, roi={mroi} "
            f"({(ref != (m.min_disparity - 1) * 16).mean():.3f} valid, "
            f"golden {time.perf_counter() - t0:.1f}s)")


def check_kernel_vs_xla(W: int = 1280, H: int = 720, D: int = 128,
                        seed: int = 0) -> None:
    """The compiled SGM aggregation kernel against the XLA scans on a real
    BT cost volume, S bit-exact."""
    import jax
    import jax.numpy as jnp

    from rt_depth_map.ops.sgbm import aggregate_cost, sgbm_cost_volume
    from rt_depth_map.ops.sgm_kernel import aggregate_cost_pallas

    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (H, W), dtype=np.uint8)
    right = np.roll(left, -9, axis=1)
    C, _, _ = jax.jit(lambda a, b: sgbm_cost_volume(a, b, D, 5, 0, 0))(
        jnp.asarray(left), jnp.asarray(right))
    ref = jax.jit(lambda c: aggregate_cost(c, 600, 2400, 8))(C)
    kern = jax.jit(lambda c: aggregate_cost_pallas(c, 600, 2400, 8))
    got = kern(C.astype(jnp.int16))
    compare_exact(f"kernel S {W}x{H} D={D}", got, ref)
    log(f"  kernel: S bit-exact vs XLA aggregate_cost at {W}x{H} D={D}; "
        f"{kern.lower(C.astype(jnp.int16)).compile().memory_analysis()}")


def check_frame_vs_cpu(engine, src, frame: int = 0) -> None:
    """The engine's frame program on the card vs the same configuration's
    frame program built and run on the host CPU (whose SGM aggregation is
    the XLA scan the kernel is bit-exact with)."""
    import jax

    from rt_depth_map.pipeline import Engine

    left, right = src.render(frame)[:2]
    args = (left, right, engine.hsv_low, engine.hsv_high,
            np.int32(engine.min_object_size))
    card = jax.tree_util.tree_map(
        np.asarray, jax.jit(engine._frame_fn)(*args))
    cpu_dev = jax.devices("cpu")[0]
    cfg = engine.cfg.replace(
        matcher=engine.cfg.matcher.replace(backend="xla"))
    t0 = time.perf_counter()
    with jax.default_device(cpu_dev):
        host_engine = Engine(cfg, source=src)
        host = jax.tree_util.tree_map(np.asarray, jax.jit(
            host_engine._frame_fn)(*jax.device_put(args, cpu_dev)))
    compare_frames(f"frame {frame} card vs cpu", card, host)
    log(f"  frame {frame}: card == cpu on {EXACT_KEYS}, {CLOSE_KEYS} within "
        f"rtol 1e-5 (cpu run {time.perf_counter() - t0:.1f}s)")


def four_cards(W: int = 1280, H: int = 720, D: int = 128) -> list:
    """The sharded step on a (data=2, space=2) mesh of 4 devices, every
    frame bit-exact against the single-device matcher; returns the devices."""
    import jax

    from rt_depth_map.config import EngineConfig, MatcherConfig
    from rt_depth_map.ops.bm import stereo_bm
    from rt_depth_map.ops.color import rgb_to_gray
    from rt_depth_map.ops.sgbm import stereo_sgbm
    from rt_depth_map.parallel import make_mesh
    from rt_depth_map.parallel.pipeline_sharded import make_sharded_step
    from rt_depth_map.sources import SyntheticStereoSource

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:4]
    mesh = make_mesh((2, 2), devices=devs)
    src = SyntheticStereoSource(W, H, seed=0)
    frames = [src.render(i)[:2] for i in range(4)]
    lefts = np.stack([f[0] for f in frames])
    rights = np.stack([f[1] for f in frames])
    matchers = [
        ("sgm exact", MatcherConfig(kind="sgm", num_disparities=D,
                                    block_size=5, num_paths=8,
                                    pre_filter_cap=0, tile_mode="exact")),
        ("bm", MatcherConfig(kind="bm", num_disparities=D, block_size=13)),
    ]
    for name, m in matchers:
        cfg = EngineConfig(width=W, height=H, number_of_disparities=D,
                           matcher=m)
        step, sharding = make_sharded_step(mesh, cfg, (W, H),
                                           Q=src.q_matrix())
        L = jax.device_put(lefts, sharding)
        R = jax.device_put(rights, sharding)
        t0 = time.perf_counter()
        disp = np.asarray(step(L, R)["disparity"])
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(step(L, R))
        t_step = time.perf_counter() - t0
        matcher = stereo_sgbm if m.kind == "sgm" else stereo_bm
        single = jax.jit(lambda l, r: matcher(
            rgb_to_gray(l), rgb_to_gray(r), m))
        for i in range(4):
            compare_exact(f"4-card {name} frame {i}", disp[i], single(
                jax.device_put(lefts[i], devs[0]),
                jax.device_put(rights[i], devs[0])))
        log(f"  4-card {name}: 4 frames bit-exact vs single-device matcher "
            f"(first step {t_first:.1f}s incl. compile, step {t_step:.3f}s)")
    return devs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded step on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    require_accelerator(jax)
    from rt_depth_map.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()

    if args.four_cards:
        devices = four_cards()
    else:
        devices = jax.devices()[:1]
        log("phase 1: card and environment")
        log(f"  {card}")
        log(f"  jax {jax.__version__}, devices {jax.devices()}")
        for mod in ("cv2", "yaml", "PIL"):
            try:
                __import__(mod)
                ok = "imports"
            except ImportError:
                ok = "absent"
            log(f"  {mod}: {ok} (not on the device path)")

        log("phase 2: SGM flagship 1280x720 D=128 8-path")
        from rt_depth_map.ops.sgm_kernel import sgm_kernel_selected

        if not sgm_kernel_selected("auto"):
            raise AssertionError("the GPU SGM kernel is not selected")
        check_kernel_vs_xla()
        sgm_engine, sgm_src, sgm_results = run_engine(sgm_config())
        check_sgm_vs_golden(sgm_engine, sgm_src, sgm_results)

        log("phase 3: BM reference default 1280x720 13x13 D=192")
        bm_engine, bm_src, bm_results = run_engine(bm_config())
        if bm_engine.num_disparities != 192:
            raise AssertionError(bm_engine.num_disparities)
        check_bm_vs_golden(bm_engine, bm_src, bm_results)

        log("phase 4: SGM frame program, card vs host CPU")
        check_frame_vs_cpu(sgm_engine, sgm_src)

    log(card)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
