"""Multi-host (multi-process) initialization.

The reference has no distributed backend — multi-node runs are manual file
sharding (SURVEY.md §2.5/P3).  kpop-tpu runs as one SPMD job:
``initialize()`` wires up ``jax.distributed`` from explicit coordinates
or ``JAX_COORDINATOR_ADDRESS``, after which the same mesh/sharding code
paths work unchanged from one device to many hosts; host-sharded input
(parallel/input.py) and sharded checkpoints (parallel/checkpoint.py) work
per process.
"""

from __future__ import annotations

import os

from ..config import jax_setup


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed if running multi-process.

    No-ops when single-process (the common case) unless explicit
    coordinates or ``JAX_COORDINATOR_ADDRESS`` are given.
    """
    jax = jax_setup()
    if (
        coordinator_address is None
        and num_processes is None
        and not os.environ.get("JAX_COORDINATOR_ADDRESS")
    ):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_primary() -> bool:
    jax = jax_setup()
    return jax.process_index() == 0
