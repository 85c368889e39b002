"""Multi-process start-up (port of `bemstokes_tpu/parallel/multihost.py`).

The reference's only transport is MPI (`include/bem_stokes.h:74`,
`source/bem_stokes.cc:1599-1647` row maps).  The port runs one process per
device, launched by `torchrun`, which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT (the JAX package reads its JAX_* variables
instead, and runs one process per host).

Entry points:
- `initialize_multihost()`: call once per process before any collective;
  a no-op for a single process.  It binds the rank to cuda:LOCAL_RANK
  (NCCL), or to the CPU (gloo) when the caller asks for it;
- `global_row_mesh()`: the row partition over every rank;
- `is_coordinator()`: the rank that writes files (the reference's
  `this_mpi_process == 0` guards);
- `replicate_to_global(x)`: one copy, equal on every rank.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .sharded import RowMesh, row_mesh

def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_rank: int | None = None,
    device=None,
) -> bool:
    """Initialize `torch.distributed` for a multi-process run.

    Returns True if a process group of more than one rank was initialized,
    False for the single-process no-op.  Arguments default to torchrun's
    environment: `coordinator_address` "host:port" to MASTER_ADDR and
    MASTER_PORT, `num_processes` to WORLD_SIZE, `process_id` to RANK,
    `local_rank` to LOCAL_RANK.  `device="cpu"` runs the group on the CPU
    (gloo); otherwise each rank takes the card cuda:LOCAL_RANK (NCCL)."""
    env = os.environ
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if num_processes in (None, 1):
        return False  # single process
    if process_id is None:
        process_id = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", process_id))
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if device is not None and torch.device(device).type == "cpu":
        backend = "gloo"
    else:
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator_address}",
        rank=process_id,
        world_size=num_processes,
    )
    return True


def global_row_mesh(device=None) -> RowMesh:
    """The row partition spanning every rank of the default group."""
    return row_mesh(None, device)


def is_coordinator() -> bool:
    """True on the process that does file output (reference
    `this_mpi_process == 0`)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def replicate_to_global(x, mesh: RowMesh | None = None) -> torch.Tensor:
    """A host array or tensor -> a tensor on the mesh's device, equal on
    every rank: rank 0's copy, broadcast when the group has more than one
    rank (the analog of the reference's replicated geometry vectors)."""
    mesh = mesh or global_row_mesh()
    return mesh.agree(torch.as_tensor(x, device=mesh.device).clone())
