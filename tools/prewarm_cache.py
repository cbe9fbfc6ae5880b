"""Pre-warm the persistent compilation cache for the standard operating
points (deployment cold-start recipe).

Compiles the engine's frame program for each requested cell ONCE into the
persistent cache (JAX_COMPILATION_CACHE_DIR where set, else
<checkout>/.jax_cache -- rt_depth_map/utils/compile_cache.py), so later
engine/CLI/bench starts load it instead of compiling.

Usage: python tools/prewarm_cache.py [cells...]
  cells: WxHxD[:bm|:sgm] (default: the BENCH_MATRIX set)
"""

import sys
import time

import numpy as np


def main():
    import jax

    from rt_depth_map.config import EngineConfig, MatcherConfig
    from rt_depth_map.pipeline import Engine
    from rt_depth_map.sources import SyntheticStereoSource
    from rt_depth_map.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)

    cells = sys.argv[1:] or [
        "320x240x64:bm", "320x240x64:sgm",
        "1280x720x128:bm", "1280x720x128:sgm",
        "1920x1080x256:sgm",
    ]
    for cell in cells:
        spec = cell.split(":")
        W, H, D = (int(v) for v in spec[0].split("x"))
        kind = spec[1] if len(spec) > 1 else "sgm"
        if kind == "sgm":
            mcfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                                 num_paths=8, pre_filter_cap=0)
        else:
            mcfg = MatcherConfig(kind="bm", num_disparities=D, block_size=13)
        cfg = EngineConfig(width=W, height=H, number_of_disparities=D,
                           matcher=mcfg)
        eng = Engine(cfg, source=SyntheticStereoSource(W, H, seed=0))
        rng = np.random.default_rng(0)
        rgb = np.asarray(rng.integers(0, 256, (H, W, 3), np.uint8))
        t0 = time.perf_counter()
        out = eng._step(rgb, rgb, np.asarray(eng.hsv_low),
                        np.asarray(eng.hsv_high),
                        np.int32(eng.min_object_size))
        jax.block_until_ready(out)
        print(f"prewarmed {cell}: {time.perf_counter() - t0:.1f}s",
              flush=True)


if __name__ == "__main__":
    main()
