"""Surface mass operator, centers of mass, rigid-body modes and the
L2-projected normal vector (port of `bemstokes_tpu/physics/rigid.py`;
reference `compute_center_of_mass_and_rigid_modes`
`source/bem_stokes.cc:2441-2788` and `compute_normal_vector` `:3923-4011`).

The consistent mass matrix is never materialized: it acts as a
gather-contract-scatter operator over cells (same scalar mass on each of the
dim components).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.geometry import panel_geometry
from ..utils import timers


@dataclasses.dataclass(frozen=True)
class MassOperator:
    """Scalar consistent-mass operator tables for one space/quadrature."""

    n_nodes: int
    cells_nodes: np.ndarray  # [Nc, nl]
    phi: np.ndarray  # [nq, nl]
    jxw: torch.Tensor  # [Nc, nq] (depends on euler; rebuilt per frame)

    def _cells(self):
        with timers.host_sync():
            return torch.as_tensor(self.cells_nodes, dtype=torch.long, device=self.jxw.device)

    def _phi(self, like):
        with timers.host_sync():
            return torch.as_tensor(self.phi, dtype=like.dtype, device=like.device)

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """v [n, d] or [n] (or a batch [B, n, d]) -> M v, componentwise."""
        batched = v.ndim == 3
        if batched:
            return torch.stack([self.matvec(vb) for vb in v])
        squeeze = v.ndim == 1
        if squeeze:
            v = v[:, None]
        cells = self._cells()
        phi = self._phi(v)
        vq = torch.einsum("ql,clD->cqD", phi, v[cells])
        rc = torch.einsum("ql,cqD,cq->clD", phi, vq, self.jxw)
        out = torch.zeros_like(v).index_add_(
            0, cells.reshape(-1), rc.reshape(-1, v.shape[1])
        )
        return out[:, 0] if squeeze else out

    def lumped(self) -> torch.Tensor:
        """Row-sum lumped mass [n]."""
        cells = self._cells()
        phi = self._phi(self.jxw)
        rl = torch.einsum("ql,cq->cl", phi, self.jxw)
        return torch.zeros(
            (self.n_nodes,), dtype=rl.dtype, device=rl.device
        ).index_add_(0, cells.reshape(-1), rl.reshape(-1))


def build_mass_operator(euler, tables) -> tuple[MassOperator, tuple]:
    """Build the mass operator and smooth panel geometry for the current
    euler vector; `tables` is an AssemblyTables (reuses its smooth rule)."""
    cfg = tables.cfg
    dt, dev = cfg.dtype, euler.device

    def t(a, dtype=dt):
        with timers.host_sync():
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    cells_map = t(tables.cells_nodes_map, torch.long)
    xq, normals, jxw = panel_geometry(
        euler[cells_map].to(dt),
        t(tables.phi_map),
        t(tables.dphi_map),
        t(tables.q_weights),
        t(tables.flip_sign),
        ambient_dim=cfg.dim,
    )
    op = MassOperator(
        n_nodes=tables.n_nodes,
        cells_nodes=tables.cells_nodes_fe,
        phi=tables.phi_fe,
        jxw=jxw,
    )
    return op, (xq, normals, jxw)


def surface_mass_and_com(xq, jxw, cell_mask=None):
    """Total surface measure and center of mass; cell_mask [Nc] restricts to a
    material subset (the reference's body-only CoM, `:2492-2498`)."""
    w = jxw if cell_mask is None else jxw * cell_mask[:, None]
    mass = torch.sum(w)
    com = torch.einsum("cq,cqd->d", w, xq) / mass
    return mass, com


def rigid_modes(support_pts, pole, node_mask=None):
    """N_rigid [R, n, d] with R = 2d-3 rotations + d translations ordered
    (translations, rotations), restricted to `node_mask` nodes (the swimmer
    body; reference N_rigid vs N_rigid_complete).

    3D: 6 modes; 2D: 3 modes (2 translations + 1 rotation)."""
    n, d = support_pts.shape
    r = support_pts - pole[None, :]
    eye = torch.eye(d, dtype=support_pts.dtype, device=support_pts.device)
    modes = [eye[a].expand(n, d) for a in range(d)]
    if d == 3:
        for a in range(3):
            modes.append(torch.linalg.cross(eye[a].expand(n, 3), r, dim=-1))
    else:
        modes.append(torch.stack([-r[:, 1], r[:, 0]], dim=-1))
    N = torch.stack(modes)  # [R, n, d]
    if node_mask is not None:
        N = N * node_mask[None, :, None]
    return N


def _cg(matvec, b, x0, tol=1e-12, maxiter=500, precond=None):
    """Preconditioned CG on flat tensors (the JAX `while_loop`, as a Python
    loop: one host read of the residual norm per iteration)."""
    if precond is None:
        precond = lambda r: r
    x = x0
    r = b - matvec(x0)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter:
        with timers.host_sync():
            go_on = float(torch.linalg.vector_norm(r)) > tol
        if not go_on:
            break
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x


def normal_vector_l2(mass_op: MassOperator, normals_q, jxw, body_node_mask):
    """L2 projection of the outward panel normal onto the FE space, node-wise
    normalization, and the body-only copy + duals (reference
    `compute_normal_vector`, `:3923-4011`).

    Returns dict with normal [n, d], normal_pure [n, d], M_normal,
    M_normal_pure, l2_gamma, l2_gamma_pure.
    """
    cells = mass_op._cells()
    phi = mass_op._phi(jxw)
    n, d = mass_op.n_nodes, normals_q.shape[-1]
    rhs_c = torch.einsum("ql,cqd,cq->cld", phi, normals_q, jxw)
    rhs = torch.zeros((n, d), dtype=jxw.dtype, device=jxw.device).index_add_(
        0, cells.reshape(-1), rhs_c.reshape(-1, d)
    )
    # mass solve with Jacobi (lumped-mass) preconditioning, componentwise
    diag = mass_op.lumped()

    def mv(vf):
        return mass_op.matvec(vf.reshape(n, d)).reshape(-1)

    precond = lambda r: (r.reshape(n, d) / diag[:, None]).reshape(-1)
    x0 = precond(rhs.reshape(-1))
    sol = _cg(mv, rhs.reshape(-1), x0, precond=precond).reshape(n, d)
    norm = torch.linalg.vector_norm(sol, dim=-1, keepdim=True)
    normal = sol / torch.where(norm == 0, torch.ones_like(norm), norm)
    normal_pure = normal * body_node_mask[:, None]
    M_normal = mass_op.matvec(normal)
    M_normal_pure = mass_op.matvec(normal_pure)
    return dict(
        normal=normal,
        normal_pure=normal_pure,
        M_normal=M_normal,
        M_normal_pure=M_normal_pure,
        l2_gamma=torch.sum(M_normal * normal),
        l2_gamma_pure=torch.sum(M_normal_pure * normal_pure),
    )


def flatten(v):
    """[n, d] -> component-blocked flat [d*n] (reference layout i + c*n);
    a batch [B, n, d] -> [B, d*n]."""
    if v.ndim == 3:
        return v.transpose(1, 2).reshape(v.shape[0], -1)
    return v.T.reshape(-1)


def unflatten(vf, d):
    """flat [d*n] -> [n, d]."""
    return vf.reshape(d, -1).T
