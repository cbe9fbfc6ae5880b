"""SGM directional aggregation as a Pallas kernel for NVIDIA GPUs (Triton).

The XLA formulation (`ops.sgbm.aggregate_cost`) runs each direction as a
`lax.scan` whose every step is one tiny (H, D) or (W1, D) slab: thousands
of sequential device steps per frame, bound by per-iteration launches
rather than by bytes or arithmetic. This kernel follows the GPU SGM design
of Hernandez-Juarez et al. (arXiv 1610.04121): every direction is a set of
independent scan lines ("chains"), a block owns one chain and loops over
the scan axis itself, and the disparities lie across the block's threads
with the recurrence carry held in registers.

Chains per direction (dy, dx), with C laid out (H, W1, D):
  * horizontal (dy == 0): one chain per row, stepping over x;
  * vertical (dx == 0): one chain per column, stepping over y;
  * diagonal: one chain per skewed line x = j + dx * t, stepping over y.
    Under OpenCV's zero border a diagonal starts from a zero carry at the
    image edge, so it is as independent as a row or a column.

Nothing carries between blocks. The d +- 1 neighbours of the carry come
from the row the block stored on the previous step (Triton cannot shift a
register tensor); a double-buffered per-block scratch row and one barrier
per step keep that exchange race-free. D is padded to the next power of two
with masks, so any D works (D = 192 runs as 256 lanes). Each direction
adds its L_r into one int32 S: no per-direction volume is materialized.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rt_depth_map.ops.sgbm import MAX_COST, sgm_directions

_BIG = 2**30
# scan lines per block: 2 and 4 measured slower than 1 at 720p and QVGA
# (more, smaller blocks hide the per-step latency better)
_CHAINS = 1


def sgm_kernel_selected(backend: str, platform: str | None = None) -> bool:
    """The one routing decision of the matcher: whether SGM aggregation runs
    as this kernel (True) or as the XLA scans (False).

    backend: MatcherConfig.backend -- "auto" picks the kernel on a GPU and
    XLA elsewhere, "xla" always XLA, "pallas" forces the kernel and raises
    where it cannot compile. platform defaults to jax.default_backend()."""
    platform = platform or jax.default_backend()
    if backend == "xla":
        return False
    if backend == "auto":
        return platform == "gpu"
    if backend == "pallas":
        if platform != "gpu":
            raise ValueError(
                f"backend='pallas' needs a GPU; the platform is {platform!r} "
                "(the kernel's CPU tests call aggregate_cost_pallas with "
                "interpret=True)"
            )
        return True
    raise ValueError(f"unknown matcher backend {backend!r}")


def _chain_range(H: int, W1: int, dy: int, dx: int):
    """(first chain id, number of chains) of one direction."""
    if dy == 0:
        return 0, H
    if dx == 0:
        return 0, W1
    # x = j + dx * t over t in [0, H): dx = +1 needs j down to -(H - 1)
    return (-(H - 1) if dx > 0 else 0), W1 + H - 1


def _agg_dir_kernel(c_ref, *refs, H, W1, D, Dp, R, dy, dx, p1, p2,
                    accumulate, interpret):
    if accumulate:
        _, s_ref, buf_ref = refs  # S input aliases the S output
    else:
        s_ref, buf_ref = refs
    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    pid = pl.program_id(0)
    j_lo, _ = _chain_range(H, W1, dy, dx)
    j0 = j_lo + pid * R
    j = j0 + jax.lax.broadcasted_iota(jnp.int32, (R,), 0)
    d = jax.lax.broadcasted_iota(jnp.int32, (1, Dp), 1)
    dmask = d < D

    # scan steps this block's chains are inside the image for
    if dy == 0:
        t0, t1 = 0, W1
    elif dx == 0:
        t0, t1 = 0, H
    elif dx > 0:
        t0 = jnp.maximum(0, -(j0 + R - 1))
        t1 = jnp.minimum(H, W1 - j0)
    else:
        t0 = jnp.maximum(0, j0 - (W1 - 1))
        t1 = jnp.minimum(H, j0 + R)

    def place(t):
        """(element offsets, load/store mask, chain active) at step t."""
        if dy == 0:
            x = t if dx > 0 else W1 - 1 - t
            y = j
            act = j < H
        else:
            y = t if dy > 0 else H - 1 - t
            x = j + dx * t
            act = (x >= 0) & (x < W1)
        m = act[:, None] & dmask
        # masked lanes point one past the end: never touched on the GPU,
        # and dropped (not aliased onto a live element) by interpret mode
        offs = jnp.where(m, ((y * W1 + x) * D)[:, None] + d, H * W1 * D)
        return offs, m, act

    def fetch(t):
        offs, m, act = place(t)
        c = plgpu.load(c_ref.at[offs], mask=m, other=0).astype(jnp.int32)
        s = (plgpu.load(s_ref.at[offs], mask=m, other=0) if accumulate
             else None)
        return offs, m, act, c, s

    # double-buffered neighbour exchange row: step t reads parity t & 1,
    # which step t - 1 wrote
    row = (pid * 2 * R * Dp
           + jax.lax.broadcasted_iota(jnp.int32, (R, Dp), 0) * Dp + d)
    has_lo = jnp.broadcast_to(d >= 1, (R, Dp))
    has_hi = jnp.broadcast_to(d + 1 < D, (R, Dp))
    zero = jnp.zeros((R, Dp), jnp.int32)
    plgpu.store(buf_ref.at[row + (t0 & 1) * (R * Dp)], zero)
    barrier()

    def body(t, carry):
        Lp, cur = carry
        offs, m, act, c, s = cur
        # prefetch the next step's volume rows behind this step's chain
        nxt = fetch(jnp.minimum(t + 1, t1 - 1))
        rd = row + (t & 1) * (R * Dp)
        lm = plgpu.load(buf_ref.at[jnp.where(has_lo, rd - 1, rd)],
                        mask=has_lo, other=MAX_COST)
        lp = plgpu.load(buf_ref.at[jnp.where(has_hi, rd + 1, rd)],
                        mask=has_hi, other=MAX_COST)
        minLp = jnp.min(jnp.where(dmask, Lp, _BIG), axis=1, keepdims=True)
        delta = minLp + p2
        mm = jnp.minimum(jnp.minimum(Lp, lm + p1), jnp.minimum(lp + p1, delta))
        L = jnp.where(act[:, None], c + mm - delta, 0)
        plgpu.store(s_ref.at[offs], (s + L) if accumulate else L, mask=m)
        plgpu.store(buf_ref.at[row + ((t + 1) & 1) * (R * Dp)], L)
        barrier()
        return L, nxt

    jax.lax.fori_loop(t0, t1, body, (zero, fetch(t0)))


def aggregate_dir_pallas(C: jnp.ndarray, S: jnp.ndarray | None, p1: int,
                         p2: int, dy: int, dx: int, *,
                         interpret: bool = False) -> jnp.ndarray:
    """S + L_r of one direction (S=None: just L_r), all (H, W1, D) int32.

    C: (H, W1, D) int16 or int32 cost volume. Bit-exact vs
    ops.sgbm._aggregate_dir.
    """
    H, W1, D = C.shape
    Dp = pl.next_power_of_2(D)
    _, n = _chain_range(H, W1, dy, dx)
    grid = pl.cdiv(n, _CHAINS)
    kernel = functools.partial(
        _agg_dir_kernel, H=H, W1=W1, D=D, Dp=Dp, R=_CHAINS, dy=dy, dx=dx,
        p1=p1, p2=p2, accumulate=S is not None, interpret=interpret)
    out_shape = (
        jax.ShapeDtypeStruct((H * W1 * D,), jnp.int32),
        jax.ShapeDtypeStruct((grid * 2 * _CHAINS * Dp,), jnp.int32),
    )
    args = (C.reshape(-1),) + (() if S is None else (S.reshape(-1),))
    out, _ = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(grid,),
        input_output_aliases={} if S is None else {1: 0},
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(8, _CHAINS * Dp // 128)), num_stages=1),
        backend="triton",
        interpret=interpret,
        name=f"sgm_aggregate_dy{dy}_dx{dx}".replace("-", "m"),
    )(*args)
    return out.reshape(H, W1, D)


def aggregate_cost_pallas(C: jnp.ndarray, p1: int, p2: int, num_paths: int,
                          *, interpret: bool = False) -> jnp.ndarray:
    """Kernel counterpart of ops.sgbm.aggregate_cost (bit-exact): the int32
    sum over the `num_paths` directions, one launch per direction."""
    S = None
    for dy, dx in sgm_directions(num_paths):
        S = aggregate_dir_pallas(C, S, p1, p2, dy, dx, interpret=interpret)
    return S
