"""Convergence-study harness (port of `bemstokes_tpu/convergence.py`) — the
analog of the reference's `V_test_with_Green.cc:68-204` family driving a
deal.II ParsedConvergenceTable over `n_cycles` global refinements.

The study imposes the fundamental solution u = G(x - x0) e_c from an
interior Stokeslet source, applies the Dirichlet-to-Neumann map, and
measures the traction-trace recovery error per refinement cycle; rates are
reported as log2(err_{k-1}/err_k) per cycle (quad refinement halves h).
Each cycle assembles V and K through the node sweep (K1 on the card) and
runs on the CUDA card unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fem.geometry import euler_from_mesh, support_points
from .kernels.helpers import impose_G_as_trace, impose_G_as_velocity
from .mesh import build_scalar_space
from .mesh.refine import refine_uniform
from .ops import (
    AssemblyConfig,
    assemble_V_K,
    build_assembly_tables,
    k_solid_angle_correction,
    tangential_projector,
)
from .ops.resistance import dirichlet_to_neumann
from .physics.rigid import build_mass_operator, flatten, normal_vector_l2
from .problem import resolve_device


def green_recovery_error(
    mesh,
    dim: int,
    source,
    fe_degree: int = 1,
    map_degree: int | None = None,
    quad_order: int = 4,
    sing_order: int = 8,
    component: int = 0,
    manifold=None,
    device=None,
) -> tuple[float, int]:
    """Relative L2 error of the D2N traction recovery for an interior
    Stokeslet source; returns (error, n_scalar_nodes)."""
    dev = resolve_device(device)
    space = build_scalar_space(mesh, fe_degree)
    mspace = space if map_degree in (None, fe_degree) else build_scalar_space(mesh, map_degree)
    cfg = AssemblyConfig(dim=dim, quad_order=quad_order, singular_quadrature_order=sing_order)
    tables = build_assembly_tables(space, mspace, cfg)
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, mspace, manifold), device=dev)
    sp = support_points(euler, mspace, space)

    mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, tables)
    body_mask = torch.ones((space.n_nodes,), dtype=cfg.dtype, device=dev)
    nv = normal_vector_l2(mass_op, normals_q, jxw, body_mask)
    n_pure_f = flatten(nv["normal_pure"])
    Mn_pure_f = flatten(nv["M_normal_pure"])
    l2g = nv["l2_gamma_pure"]

    V, K = assemble_V_K(euler, sp, tables)
    K, _ = k_solid_angle_correction(K, space.n_nodes, dim)

    u_flat = flatten(impose_G_as_velocity(sp, source, component))
    t_exact_flat = flatten(impose_G_as_trace(sp, nv["normal"], source, component))

    f = dirichlet_to_neumann(V, K, u_flat, n_pure_f, Mn_pure_f, l2g)
    t_exact_proj = tangential_projector(t_exact_flat, n_pure_f, Mn_pure_f, l2g)
    err = torch.linalg.vector_norm(f - t_exact_proj) / torch.linalg.vector_norm(t_exact_proj)
    return float(err), space.n_nodes


@dataclasses.dataclass
class ConvergenceRow:
    cycle: int
    n_nodes: int
    error: float
    rate: float | None


def convergence_study(
    base_mesh,
    dim: int,
    source,
    n_cycles: int = 3,
    manifold=None,
    fe_degree: int = 1,
    map_degree: int | None = None,
    quad_order: int = 4,
    sing_order: int = 8,
    device=None,
) -> list[ConvergenceRow]:
    """Run `n_cycles` global refinements of `base_mesh` (reference
    `n_cycles` / `num_convergence_cycles` parameters,
    `source/bem_stokes.cc:210,268`), measuring the Green-recovery error."""
    rows: list[ConvergenceRow] = []
    mesh = base_mesh
    for cycle in range(n_cycles):
        if cycle > 0:
            mesh = refine_uniform(mesh, manifold)
        err, n = green_recovery_error(
            mesh,
            dim,
            source,
            fe_degree=fe_degree,
            map_degree=map_degree,
            quad_order=quad_order,
            sing_order=sing_order,
            manifold=manifold,
            device=device,
        )
        rate = float(np.log2(rows[-1].error / err)) if rows and err > 0 else None
        rows.append(ConvergenceRow(cycle, n, err, rate))
    return rows


def format_table(rows: list[ConvergenceRow]) -> str:
    """deal.II-style convergence table."""
    lines = ["cycle  nodes     L2 error      rate"]
    for r in rows:
        rate = f"{r.rate:6.2f}" if r.rate is not None else "     -"
        lines.append(f"{r.cycle:5d}  {r.n_nodes:8d}  {r.error:.6e}  {rate}")
    return "\n".join(lines)
