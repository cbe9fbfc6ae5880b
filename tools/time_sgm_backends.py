"""Frames/s of the full Engine step with the SGM aggregation on the GPU
kernel (backend="auto") vs the XLA scans (backend="xla").

For each operating point, both engines are compiled and warmed up, then
timed in alternating runs (each run: N frames dispatched one after another,
every frame waited for with block_until_ready). Prints the card line and one
JSON line per (operating point, backend) with every run's frames/s and the
median.

Usage: python tools/time_sgm_backends.py [--frames N] [--runs R]
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POINTS = [(1280, 720, 128), (320, 240, 64)]


def make_engine(W, H, D, backend):
    from rt_depth_map.config import EngineConfig, MatcherConfig
    from rt_depth_map.pipeline import Engine
    from rt_depth_map.sources import SyntheticStereoSource

    cfg = EngineConfig(
        width=W, height=H, number_of_disparities=D,
        matcher=MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                              num_paths=8, pre_filter_cap=0,
                              backend=backend))
    src = SyntheticStereoSource(W, H, seed=0)
    return Engine(cfg, source=src), src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from rt_depth_map.utils.compile_cache import enable_compile_cache

    if jax.default_backend() == "cpu":
        raise SystemExit("needs an accelerator")
    enable_compile_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for W, H, D in POINTS:
        steps = {}
        for backend in ("auto", "xla"):
            engine, src = make_engine(W, H, D, backend)
            frames = [tuple(jnp.asarray(a) for a in src.render(i)[:2])
                      for i in range(6)]
            consts = (jnp.asarray(engine.hsv_low),
                      jnp.asarray(engine.hsv_high),
                      jnp.int32(engine.min_object_size))
            t0 = time.perf_counter()
            for f in frames:
                jax.block_until_ready(engine._step(*f, *consts))
            steps[backend] = (engine._step, frames, consts,
                              time.perf_counter() - t0)
        fps = {b: [] for b in steps}
        for r in range(args.runs):
            order = ("auto", "xla") if r % 2 == 0 else ("xla", "auto")
            for b in order:
                step, frames, consts, _ = steps[b]
                t0 = time.perf_counter()
                for i in range(args.frames):
                    jax.block_until_ready(step(*frames[i % 6], *consts))
                fps[b].append(args.frames / (time.perf_counter() - t0))
        for b in ("auto", "xla"):
            print(json.dumps({
                "point": f"{W}x{H} D={D} 8-path", "backend": b,
                "device_kind": jax.devices()[0].device_kind,
                "frames_per_run": args.frames,
                "fps_runs": fps[b], "fps_median": float(np.median(fps[b])),
                "warmup_s": steps[b][3]}), flush=True)


if __name__ == "__main__":
    main()
