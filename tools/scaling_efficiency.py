"""Width-tiling scaling-efficiency proxy on the virtual CPU mesh.

A host-only proxy for multi-device scaling: the ratio of
single-device frame time to 8-tile sharded frame time on an 8-virtual-CPU
mesh, plus the static per-tile compute inflation of the overlap-margin SGM
tiling (the exact upper bound on multi-chip efficiency loss that is
independent of the host).

Caveats (printed with the result): the N virtual devices share this host's
physical cores, so concurrent tile execution is partially serialized and
the measured wall-clock ratio UNDERSTATES real-chip efficiency; the static
inflation bound plus the measured collective fraction is the honest
ceiling estimate. On real devices the halo ppermute crosses the
interconnect and the tiles genuinely overlap.

Usage: python tools/scaling_efficiency.py [WxH] [D] [iters]
"""

import os
import sys

# this proxy is CPU-mesh-only by design: re-exec with the platform pinned
# (JAX_PLATFORMS must be set before JAX starts)
if os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.execv(sys.executable, [sys.executable] + sys.argv)
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import time

import numpy as np
import jax
import jax.numpy as jnp

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.sgbm import stereo_sgbm
from rt_depth_map.parallel import make_mesh
from rt_depth_map.parallel.tiled_sgbm import tiled_stereo_sgbm


def chain_time(name, fn, x0, iters):
    f = jax.jit(fn)
    t0 = time.perf_counter()
    x = f(x0)
    jax.block_until_ready(x)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        x = f(x)
    jax.block_until_ready(x)
    dt = (time.perf_counter() - t0) / iters
    print(f"{name:<28} compile={compile_s:6.1f}s  run={dt * 1e3:9.2f}ms",
          flush=True)
    return dt


def main():
    size = sys.argv[1] if len(sys.argv) > 1 else "1280x720"
    W, H = (int(v) for v in size.split("x"))
    D = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    iters = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    margin = 64
    # widest valid width tiling: tile must cover the halo (margin + D + 1)
    n = 8
    while W // n < margin + D + 1:
        n //= 2

    from rt_depth_map.sources import SyntheticStereoSource

    src = SyntheticStereoSource(W, H, seed=0)
    fl, fr = src.grab()
    L = jnp.asarray(fl.array[..., 0])
    R = jnp.asarray(fr.array[..., 0])

    cfg = MatcherConfig(kind="sgm", num_disparities=D, block_size=5,
                        num_paths=8, pre_filter_cap=0, backend="xla",
                        speckle_window_size=0, disp12_max_diff=-1)

    def p16(x, out):
        return x ^ (jnp.sum(out.astype(jnp.int32)) & 1).astype(x.dtype)

    def single(l):
        return p16(l, stereo_sgbm(l, R, cfg))

    mesh = make_mesh((1, n), devices=jax.devices()[:n])

    def sharded(l):
        return p16(l, tiled_stereo_sgbm(l, R, cfg, mesh, margin=margin))

    t1 = chain_time("single-device SGM", single, L, iters)
    t8 = chain_time(f"{n}-tile sharded SGM", sharded, L, iters)

    # exact mode: wavefront boundary-state exchange, zero compute
    # inflation; its ceiling is the pipeline-fill idle fraction instead
    from rt_depth_map.parallel.exact_sgbm import (
        _default_row_block,
        exact_tiled_stereo_sgbm,
    )

    ne = 8
    while W % ne or (W - D) % ne:
        ne //= 2
    emesh = make_mesh((1, ne), devices=jax.devices()[:ne])

    def sharded_exact(l):
        return p16(l, exact_tiled_stereo_sgbm(l, R, cfg, emesh))

    te = chain_time(f"{ne}-tile EXACT sharded SGM", sharded_exact, L, iters)
    Rb = _default_row_block(H, ne)
    K = H // Rb
    fill = (ne - 1) / (K + ne - 1)

    # data-parallel scaling: B frames sharded over the data axis vs the
    # same B frames lax.map'd on one device -- no cross-chip dependency,
    # this is the BASELINE.md >=80% multi-chip throughput mode
    nd = 8
    dmesh = make_mesh((nd, 1), devices=jax.devices()[:nd])
    sh = jax.sharding.NamedSharding(
        dmesh, jax.sharding.PartitionSpec("data"))
    LB = jax.device_put(jnp.broadcast_to(L, (nd,) + L.shape), sh)
    RB = jax.device_put(jnp.broadcast_to(R, (nd,) + R.shape), sh)

    def dp(lb):
        out = jax.shard_map(
            lambda l, r: stereo_sgbm(l[0], r[0], cfg)[None],
            mesh=dmesh,
            in_specs=jax.sharding.PartitionSpec("data"),
            out_specs=jax.sharding.PartitionSpec("data"),
            check_vma=False,
        )(lb, RB)
        return lb ^ (jnp.sum(out.astype(jnp.int32)) & 1).astype(lb.dtype)

    def serial(lb):
        out = jax.lax.map(lambda l: stereo_sgbm(l, R, cfg), lb)
        return lb ^ (jnp.sum(out.astype(jnp.int32)) & 1).astype(lb.dtype)

    tdp = chain_time(f"{nd}-frame DP sharded", dp, LB, iters)
    tser = chain_time(f"{nd}-frame serial map", serial, jnp.asarray(LB),
                      iters)

    # static per-tile compute inflation of the overlap tiling: each tile
    # matches (W/n + margin + D) columns to emit W/n
    tile_w = W // n
    inflation = (tile_w + margin + D) / tile_w
    print(f"\n[width-tiling, latency mode] wall ratio t1/t{n}: "
          f"{t1 / t8:.2f}x on {os.cpu_count()} host cores")
    print(f"  static per-tile compute inflation {inflation:.2f}x -> "
          f"ideal-chip ceiling {100 / inflation:.0f}% at n={n}")
    print(f"[width-tiling, EXACT mode] wall ratio t1/t{ne}: "
          f"{t1 / te:.2f}x; zero compute inflation, pipeline-fill idle "
          f"{100 * fill:.0f}% -> ideal-chip ceiling {100 * (1 - fill):.0f}% "
          f"at n={ne} (row_block={Rb})")
    print(f"[data-parallel, throughput mode] {nd}-frame sharded vs serial: "
          f"{tser / tdp:.2f}x of ideal {min(nd, os.cpu_count())}x "
          f"core-limited -> per-chip efficiency proxy "
          f"{100 * tser / tdp / min(nd, os.cpu_count()):.0f}% "
          f"(no cross-chip dependency; real chips pay only dispatch)")


if __name__ == "__main__":
    main()
