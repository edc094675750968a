"""Multi-process runtime initialisation.

Counterpart of ``networks_fenicsx_tpu/parallel/multihost.py`` (``:38-92``):
one process per device (or per group of shards), joined into one
``torch.distributed`` process group — the role ``jax.distributed`` plays
for the JAX package (and ``mpiexec`` + ``MPI_Init`` for the FEniCSx code it
ports).  A single process needs nothing: its mesh owns every shard.

Call :func:`ensure_distributed` once at program start.  It is a no-op
unless multi-process execution is configured (explicit arguments,
``NXFX_COORDINATOR`` set, or a recognised cluster environment such as
SLURM or Open MPI), so library code and single-process scripts can call it
unconditionally.  The backend is gloo when CUDA is absent (CPU shards; its
collectives take CPU tensors) and NCCL when it is present (CUDA shards).

Launch recipe (two processes on one machine)::

    NXFX_COORDINATOR=localhost:29500 NXFX_NUM_PROCESSES=2 NXFX_PROCESS_ID=$i \\
        python my_script.py
"""

from __future__ import annotations

import os

__all__ = ["ensure_distributed", "is_initialized", "backend"]

_initialized = False


def is_initialized() -> bool:
    """Whether this process has joined a multi-process runtime."""
    return _initialized


def backend() -> str:
    """The collective backend this process uses: NCCL with CUDA, else gloo."""
    import torch

    return "nccl" if torch.cuda.is_available() else "gloo"


def ensure_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the ``torch.distributed`` process group if one is configured.

    Resolution order for each parameter: explicit argument, then the
    ``NXFX_COORDINATOR`` / ``NXFX_NUM_PROCESSES`` / ``NXFX_PROCESS_ID``
    environment variables, then the cluster's own variables (SLURM's
    ``SLURM_NTASKS``/``SLURM_PROCID``, Open MPI's
    ``OMPI_COMM_WORLD_SIZE``/``OMPI_COMM_WORLD_RANK``), which
    ``init_process_group`` then reads through its ``env://`` rendezvous.

    Returns:
        True if the process group is active after the call (joined now or
        already initialised); False when running single-process (the call
        is then a no-op).
    """
    global _initialized
    if _initialized:
        return True

    coordinator_address = coordinator_address or os.environ.get("NXFX_COORDINATOR")
    if num_processes is None and os.environ.get("NXFX_NUM_PROCESSES"):
        num_processes = int(os.environ["NXFX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("NXFX_PROCESS_ID"):
        process_id = int(os.environ["NXFX_PROCESS_ID"])

    # Without an explicit coordinator, only proceed when a cluster
    # environment is present; otherwise stay single-process.
    auto_cluster = any(
        os.environ.get(var)
        for var in (
            "TPU_WORKER_HOSTNAMES",
            "MEGASCALE_COORDINATOR_ADDRESS",
            "SLURM_JOB_ID",
            "OMPI_MCA_orte_hnp_uri",
        )
    )
    if coordinator_address is None and not auto_cluster:
        return False

    import torch.distributed as dist

    if num_processes is None:
        num_processes = int(os.environ.get("SLURM_NTASKS")
                            or os.environ.get("OMPI_COMM_WORLD_SIZE") or 0) or None
    if process_id is None:
        rank = os.environ.get("SLURM_PROCID") or os.environ.get("OMPI_COMM_WORLD_RANK")
        process_id = int(rank) if rank is not None else None
    dist.init_process_group(
        backend=backend(),
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1,
    )
    _initialized = True
    return True
