"""Device mesh construction.

Axes: "data" shards independent camera streams / frame batches (DP);
"space" shards image width tiles (the TP analog, SURVEY.md section 2.10)
whose matcher halos move between neighbor tiles via ppermute. On GPUs
joined all to all (NVLink) every card reaches every other at the same rate,
so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Sequence[str] = ("data", "space"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Mesh over (data, space). Default: all devices on the space axis
    (maximum tile parallelism for single-stream operation)."""
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if shape is None:
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devs).reshape(shape), axis_names)
