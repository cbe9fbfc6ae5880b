"""Multi-host bootstrap (the deploy analog of the reference's
`copy_to_target`, Makefile:21-27 -- SURVEY.md section 2.10 "Multi-node
bootstrap" row).

One process per host, each ingesting its own camera/stream shard;
`jax.distributed.initialize` wires the processes into a single JAX runtime
whose devices form the global mesh. Usage per host:

    from rt_depth_map.parallel.launch import distributed_init
    distributed_init("10.0.0.1:8476", num_processes=4, process_id=RANK)
    mesh = make_mesh((n_hosts, devices_per_host))

or via environment (RTDM_COORDINATOR, RTDM_NUM_PROCESSES, RTDM_PROCESS_ID).
"""

from __future__ import annotations

import os
from typing import Optional

from rt_depth_map.utils.log import get_logger

log = get_logger("rt_depth_map.launch")


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or RTDM_* env vars; returns True
    when multi-process mode is active, False for single-process runs."""
    coordinator_address = coordinator_address or os.environ.get("RTDM_COORDINATOR")
    if not coordinator_address:
        return False
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("RTDM_NUM_PROCESSES", "1")
    )
    process_id = int(
        process_id
        if process_id is not None
        else os.environ.get("RTDM_PROCESS_ID", "0")
    )
    if num_processes <= 1:
        return False
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "distributed runtime up: process %d/%d, %d global devices",
        process_id, num_processes, len(jax.devices()),
    )
    return True
