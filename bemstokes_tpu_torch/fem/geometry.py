"""Mapped panel geometry (port of `bemstokes_tpu/fem/geometry.py`): the
array-first replacement for deal.II MappingFEField + FEValues (reference
`source/bem_stokes.cc:1850-1851`, `:2845-2856`).

Geometry state is a single node-position array `euler[n_map_nodes, dim]`.
Mapped points, unit normals and JxW are a couple of einsum contractions of
the precomputed reference-element tables with the gathered per-cell node
positions (torch, on the caller's device).  `QuadratureTables`,
`make_tables` and `euler_from_mesh` are host-side numpy, copied from the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference_element import reference_element
from ..mesh.dofs import ScalarSpace
from ..utils import timers


@dataclasses.dataclass(frozen=True)
class QuadratureTables:
    """Static (host-precomputed) tables for one reference quadrature rule and
    a pair of (mapping, field) elements evaluated on it."""

    points: np.ndarray  # [nq, cell_dim]
    weights: np.ndarray  # [nq]
    phi_map: np.ndarray  # [nq, nl_map] mapping shape values
    dphi_map: np.ndarray  # [nq, nl_map, cell_dim] mapping shape gradients
    phi_fe: np.ndarray  # [nq, nl_fe] field shape values


def make_tables(
    cell_dim: int, map_degree: int, fe_degree: int, points: np.ndarray, weights: np.ndarray
) -> QuadratureTables:
    me = reference_element(cell_dim, map_degree)
    fe = reference_element(cell_dim, fe_degree)
    return QuadratureTables(
        points=np.asarray(points, dtype=np.float64),
        weights=np.asarray(weights, dtype=np.float64),
        phi_map=me.shape_values(points),
        dphi_map=me.shape_grads(points),
        phi_fe=fe.shape_values(points),
    )


def parametric_normal(J: torch.Tensor, ambient_dim: int) -> torch.Tensor:
    """The unnormalized normal of Jacobians J [..., dim, cell_dim]: t_u x t_v
    in 3D; in 2D the left rotation of the tangent, (-t_y, t_x), which points
    outward on a clockwise-parametrized circle (the reference's 2D meshes,
    matching deal.II; a counter-clockwise circle gets inward normals)."""
    if ambient_dim == 3:
        return torch.linalg.cross(J[..., 0], J[..., 1], dim=-1)
    t = J[..., 0]
    return torch.stack([-t[..., 1], t[..., 0]], dim=-1)


def panel_geometry(
    euler_cells: torch.Tensor,  # [Nc, nl_map, dim] gathered node positions
    phi_map: torch.Tensor,  # [nq, nl_map]
    dphi_map: torch.Tensor,  # [nq, nl_map, cell_dim]
    weights: torch.Tensor,  # [nq]
    flip_sign: torch.Tensor,  # [Nc] +-1.0
    ambient_dim: int = 3,
):
    """Returns (xq [Nc, nq, dim], normals [Nc, nq, dim], jxw [Nc, nq]).

    Normals follow the parametric orientation (t_u x t_v in 3D; the left
    rotation of the tangent in 2D), times flip_sign."""
    xq = torch.einsum("ql,cld->cqd", phi_map, euler_cells)
    J = torch.einsum("qlk,cld->cqdk", dphi_map, euler_cells)
    nrm = parametric_normal(J, ambient_dim)
    jac = torch.sqrt(torch.sum(nrm * nrm, dim=-1))
    normals = nrm / jac[..., None] * flip_sign[:, None, None]
    jxw = jac * weights[None, :]
    return xq, normals, jxw


def support_points(
    euler: torch.Tensor,  # [n_map_nodes, dim]
    map_space: ScalarSpace,
    fe_space: ScalarSpace,
) -> torch.Tensor:
    """Positions of the field-space nodes under the current mapping
    [n_fe_nodes, dim] (deal.II map_dofs_to_support_points).

    Each FE node can be seen from several cells; for a continuous mapping all
    agree, so a scatter-mean is exact."""
    me = reference_element(map_space.cell_dim, map_space.degree)
    dt, dev = euler.dtype, euler.device
    with timers.host_sync():
        phi = torch.as_tensor(
            me.shape_values(fe_space.unit_support_points), dtype=dt, device=dev
        )  # [nl_fe, nl_map]
    with timers.host_sync():
        cells_map = torch.as_tensor(map_space.cells_nodes, dtype=torch.long, device=dev)
    cell_pos = torch.einsum("lm,cmd->cld", phi, euler[cells_map])  # [Nc, nl_fe, dim]
    dim = euler.shape[1]
    n = fe_space.n_nodes
    with timers.host_sync():
        idx = torch.as_tensor(fe_space.cells_nodes.ravel(), dtype=torch.long, device=dev)
    pos = torch.zeros((n, dim), dtype=dt, device=dev).index_add_(
        0, idx, cell_pos.reshape(-1, dim)
    )
    cnt = torch.zeros((n, 1), dtype=dt, device=dev).index_add_(
        0, idx, torch.ones((idx.shape[0], 1), dtype=dt, device=dev)
    )
    return pos / cnt


def euler_from_mesh(
    mesh_vertices: np.ndarray,
    map_space: ScalarSpace,
    manifold=None,
    body_cell_mask: np.ndarray | None = None,
) -> np.ndarray:
    """Initial euler vector (node positions) from raw mesh vertices
    (VectorTools::get_position_vector equivalent).

    With a `manifold` (an object with `project(pts, parent_pts)`, see
    `mesh.refine`), the higher-order map nodes of every cell are placed ON the
    manifold instead of on the bilinear cell — deal.II's MappingQ-on-manifold
    semantics (the reference attaches manifolds per manifold-id, scoped to the
    body cells, in `read_domain`, `source/bem_stokes.cc:609-887`).
    `body_cell_mask` [Nc] bool restricts the manifold to the body cells; on a
    mixed body+wall mesh nodes of non-body cells keep their bilinear
    positions (a body-corner node shared with a wall still snaps — it lies on
    the manifold by construction)."""
    pos = map_space.node_positions(mesh_vertices)
    if manifold is not None:
        mesh = map_space.mesh
        if body_cell_mask is None:
            from ..mesh.surface_mesh import MATERIAL_BODY

            body_cell_mask = np.asarray(mesh.material_id) == MATERIAL_BODY
        body_cell_mask = np.asarray(body_cell_mask, dtype=bool)
        # nodes carried by at least one body cell are manifold nodes
        node_on_body = np.zeros(pos.shape[0], dtype=bool)
        node_on_body[map_space.cells_nodes[body_cell_mask].ravel()] = True
        if getattr(manifold, "radius", None) is not None:
            # exact analytic manifold: snap the body map nodes onto it (mesh
            # files carry only approximate vertex positions)
            pos = np.where(node_on_body[:, None], manifold.snap(pos), pos)
        else:
            # per-cell: project this cell's map nodes through the manifold
            # with the cell's vertices as the parent set, then scatter-mean
            # (cells sharing a node agree because the parents share the same
            # manifold patch)
            body_cells = map_space.cells_nodes[body_cell_mask]  # [Nb, nl]
            cell_nodes = pos[body_cells]  # [Nb, nl, d]
            parents = mesh_vertices[mesh.cells[body_cell_mask]]
            Nb, nl, d = cell_nodes.shape
            proj = manifold.project(
                cell_nodes.reshape(Nb * nl, d),
                np.repeat(parents, nl, axis=0),
            ).reshape(Nb, nl, d)
            out = np.zeros_like(pos)
            cnt = np.zeros((pos.shape[0], 1))
            np.add.at(out, body_cells.ravel(), proj.reshape(-1, d))
            np.add.at(cnt, body_cells.ravel(), 1.0)
            snapped = out / np.where(cnt == 0, 1.0, cnt)
            pos = np.where(node_on_body[:, None], snapped, pos)
    return _distribute_map_constraints(pos, map_space)


def _distribute_map_constraints(pos: np.ndarray, map_space: ScalarSpace):
    """Hanging-node constraint distribution on the MAP vector: slave map
    DoFs are interpolated from their masters, so the geometry stays
    CONFORMING along hanging edges at any map degree (the reference's
    constrained euler_vec — constraints built at `source/bem_stokes.cc:
    1654-1656`, distributed onto the position vector in compute_euler
    `:2247-2440`).  No-op on conforming meshes; cached per space."""
    hc = getattr(map_space, "_hanging_cache", None)
    if hc is None:
        from ..mesh.constraints import hanging_node_constraints_for_space

        hc = hanging_node_constraints_for_space(map_space.mesh, map_space)
        try:
            object.__setattr__(map_space, "_hanging_cache", hc)
        except Exception:
            pass
    if hc.n == 0:
        return pos
    pos = np.array(pos, copy=True)
    pos[hc.slaves] = np.einsum(
        "hm,hmd->hd", np.asarray(hc.weights), pos[np.asarray(hc.masters)]
    )
    return pos
