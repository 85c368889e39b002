from .assemble import (
    AssemblyConfig,
    AssemblyTables,
    build_assembly_tables,
    assemble_V_K,
    assemble_rows,
    node_column_samples,
)
from .node_kernel import node_sweep, node_sweep_reference
from .corrections import (
    v_nullspace_correction,
    k_solid_angle_correction,
    tangential_projector,
)
from .monolithic import build_monolithic_system, split_monolithic_solution

__all__ = [
    "AssemblyConfig",
    "AssemblyTables",
    "build_assembly_tables",
    "assemble_V_K",
    "assemble_rows",
    "v_nullspace_correction",
    "k_solid_angle_correction",
    "tangential_projector",
    "build_monolithic_system",
    "split_monolithic_solution",
    "node_column_samples",
    "node_sweep",
    "node_sweep_reference",
]
