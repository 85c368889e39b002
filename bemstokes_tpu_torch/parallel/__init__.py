"""The distributed frame step on `torch.distributed` (port of
`bemstokes_tpu/parallel/`): row slabs (`sharded`), the slab LU (`lu`), the
sharded frame steps (`solve`) and the process start-up (`multihost`)."""

from .sharded import (
    row_mesh,
    padded_rows,
    sharded_assemble,
    sharded_matvec,
    slab_to_flat,
    flat_to_slab,
)
from .multihost import (
    initialize_multihost,
    global_row_mesh,
    is_coordinator,
    replicate_to_global,
)

__all__ = [
    "row_mesh",
    "padded_rows",
    "sharded_assemble",
    "sharded_matvec",
    "slab_to_flat",
    "flat_to_slab",
    "initialize_multihost",
    "global_row_mesh",
    "is_coordinator",
    "replicate_to_global",
]
