"""Real multi-process jax.distributed run (SURVEY.md §4 item 4).

Two local CPU processes bootstrap through parallel/launch.distributed_init
(the reference's deploy analog -- SURVEY.md §2.10 multi-node bootstrap row),
form one global 2-device mesh, and run the width-tiled matcher with its
ppermute halo exchange crossing the process boundary. Each process checks
the gathered result bit-exactly against the local single-device matcher
(integer costs make this exact).
"""

import os
import socket
import subprocess
import sys

import pytest

_DRIVER = r"""
import os, sys

rank = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.pop("XLA_FLAGS", None)  # exactly one CPU device per process

import jax

from rt_depth_map.parallel.launch import distributed_init

assert distributed_init(f"127.0.0.1:{port}", nproc, rank)

import jax.numpy as jnp
import numpy as np

assert len(jax.devices()) == nproc, jax.devices()
assert len(jax.local_devices()) == 1

from rt_depth_map.config import MatcherConfig
from rt_depth_map.ops.bm import stereo_bm
from rt_depth_map.parallel import make_mesh, tiled_stereo_bm

H, W = 48, 256
rng = np.random.default_rng(7)
base = rng.integers(0, 256, size=(H, W + 16), dtype=np.uint8)
left, right = base[:, :W].copy(), base[:, 5 : 5 + W].copy()
cfg = MatcherConfig(num_disparities=32, block_size=9)

mesh = make_mesh((1, nproc))
out = tiled_stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg, mesh)
local = np.asarray(out.addressable_data(0))  # replicated over space

ref = np.asarray(stereo_bm(jnp.asarray(left), jnp.asarray(right), cfg))
np.testing.assert_array_equal(local, ref)
print(f"rank {rank}: distributed tiled BM bit-exact", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_tiled_bm():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _DRIVER, str(rank), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert "distributed tiled BM bit-exact" in out
