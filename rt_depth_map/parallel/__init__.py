"""Multi-chip execution: device meshes, tile sharding, halo exchange.

The reference has no parallelism of any kind (SURVEY.md section 2.10: one
thread, one process); this subsystem is the multi-device scaling design it
lacks: frame/stream data-parallelism over a `jax.sharding.Mesh` axis and
image-tile spatial parallelism with `shard_map` + `ppermute` halo exchange,
XLA collectives between the devices (SURVEY.md sections 5.7-5.8).
"""

from rt_depth_map.parallel.mesh import make_mesh  # noqa: F401
from rt_depth_map.parallel.tiled_bm import tiled_stereo_bm  # noqa: F401
