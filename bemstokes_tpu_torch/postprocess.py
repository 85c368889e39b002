"""Post-processing: off/on-boundary BIE field evaluation, finite-difference
velocity gradients and Cauchy-stress recovery (port of
`bemstokes_tpu/postprocess.py`; reference `evaluate_stokes_bie`
`source/bem_stokes.cc:5366-5451`, `evaluate_stokes_bie_on_boundary`
`:5454-5560`, `approximate_velocity_gradient` `:5332-5364`).

The BIE representation at a point x off the boundary:

    u_i(x) = int_Gamma G_ij(y - x) f_j(y) dGamma
           - int_Gamma W_ijk(y - x) n_k(y) u_j(y) dGamma

evaluated for a chunk of points against every quadrature point at once.
The Green's functions of a chunk are [P, Nc, nq, d, d, d] tensors (21 MB a
point on the 6,144-panel sphere in f64), so the points go in chunks sized
by `CHUNK_BYTES`; chunking changes no result.  The device is the one
`euler` lies on, the dtype the tables' `cfg.dtype`.
"""

from __future__ import annotations

import torch

from .fem.geometry import panel_geometry, parametric_normal
from .kernels import (
    free_surface_G,
    free_surface_W,
    image_point,
    no_slip_wall_G,
    no_slip_wall_W,
    stokeslet_G,
    stresslet_W,
)
from .ops.assemble import KERNEL_FREE_SPACE, KERNEL_FREE_SURFACE, AssemblyTables
from .physics.rigid import unflatten

#: the largest Green's-function tensor of one chunk of evaluation points
CHUNK_BYTES = 2 * 1024**3


def points_per_chunk(samples: int, dim: int, dtype: torch.dtype) -> int:
    """Evaluation points a chunk holds when each point meets `samples`
    quadrature points: its [P, samples, d, d, d] stresslet within
    CHUNK_BYTES."""
    per_point = samples * dim**3 * torch.finfo(dtype).bits // 8
    return max(1, CHUNK_BYTES // per_point)


def _kernels_at(cfg, x_eval, xq):
    """(G, W) for a batch of evaluation points against all quad points.
    x_eval [P, d]; xq [Nc, nq, d] -> [P, Nc, nq, d, d(,d)]."""
    R = xq[None, :, :, :] - x_eval[:, None, None, :]
    if cfg.kernel == KERNEL_FREE_SPACE:
        return stokeslet_G(R), stresslet_W(R)
    x_img = image_point(x_eval, cfg.wall_axis, cfg.wall_position)
    return _image_pair(cfg, R, xq[None, :, :, :] - x_img[:, None, None, :])


def _image_pair(cfg, R, R_img):
    """(G, W) of the wall's image system at separations R from the point
    and R_img from its mirror image."""
    if cfg.kernel == KERNEL_FREE_SURFACE:
        return (
            free_surface_G(R, R_img, cfg.wall_axis),
            free_surface_W(R, R_img, cfg.wall_axis),
        )
    return (
        no_slip_wall_G(R, R_img, cfg.wall_axis),
        no_slip_wall_W(R, R_img, cfg.wall_axis),
    )


def _smooth_fields(velocities_flat, forces_flat, euler, tables: AssemblyTables):
    """Smooth-rule geometry and the traces at its quadrature points:
    (xq, normals, jxw, f_q, u_q, f_nodes, u_nodes)."""
    cfg = tables.cfg
    d, dt, dev = cfg.dim, cfg.dtype, euler.device

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    cells_map = torch.as_tensor(tables.cells_nodes_map, dtype=torch.long, device=dev)
    cells_fe = torch.as_tensor(tables.cells_nodes_fe, dtype=torch.long, device=dev)
    xq, normals, jxw = panel_geometry(
        euler[cells_map].to(dt),
        t(tables.phi_map),
        t(tables.dphi_map),
        t(tables.q_weights),
        t(tables.flip_sign),
        ambient_dim=d,
    )
    phi = t(tables.phi_fe)  # [nq, nl]
    f_nodes = unflatten(t(forces_flat), d)
    u_nodes = unflatten(t(velocities_flat), d)
    f_q = torch.einsum("ql,cld->cqd", phi, f_nodes[cells_fe])  # [Nc, nq, d]
    u_q = torch.einsum("ql,cld->cqd", phi, u_nodes[cells_fe])
    return xq, normals, jxw, f_q, u_q, f_nodes, u_nodes


def _points(val_points, cfg, device):
    return torch.atleast_2d(torch.as_tensor(val_points, dtype=cfg.dtype, device=device))


def evaluate_stokes_bie(
    val_points,  # [P, d]
    velocities_flat: torch.Tensor,  # [d*n] boundary velocity trace
    forces_flat: torch.Tensor,  # [d*n] boundary traction
    euler: torch.Tensor,  # [n_map, d]
    tables: AssemblyTables,
) -> torch.Tensor:
    """u at off-boundary points [P, d]."""
    cfg = tables.cfg
    pts = _points(val_points, cfg, euler.device)
    xq, normals, jxw, f_q, u_q, _, _ = _smooth_fields(velocities_flat, forces_flat, euler, tables)
    fw = f_q * jxw[..., None]
    uw = u_q * jxw[..., None]
    chunk = points_per_chunk(xq.shape[0] * xq.shape[1], cfg.dim, cfg.dtype)
    out = []
    for s in range(0, pts.shape[0], chunk):
        G, W = _kernels_at(cfg, pts[s : s + chunk], xq)  # [p, Nc, nq, d, d(,d)]
        Wn = torch.einsum("pcqijk,cqk->pcqij", W, normals)
        del W
        # each point's sum over (panel, point) is its own reduction, so a
        # point gets the same bits in a chunk of any size (one contraction
        # "pcqij,cqj->pi" lets the matrix product's blocking follow p)
        out.append(
            torch.einsum("pcqij,cqj->pcqi", G, fw).sum(dim=(1, 2))
            - torch.einsum("pcqij,cqj->pcqi", Wn, uw).sum(dim=(1, 2))
        )
    return torch.cat(out)


def evaluate_stokes_bie_on_boundary(
    val_points,
    velocities_flat: torch.Tensor,
    forces_flat: torch.Tensor,
    euler: torch.Tensor,
    support_pts: torch.Tensor,  # [n, d]
    tables: AssemblyTables,
    match_tol: float = 1e-8,
) -> torch.Tensor:
    """BIE evaluation at points that may lie ON the boundary: panels whose
    own nodes coincide (within match_tol) with the evaluation point are
    integrated with the per-local-node singular rules instead of the smooth
    rule (reference `:5454-5560`).

    The JAX package maps each point over every (panel, local node) with a
    0/1 weight; here only the coinciding (point, panel, local node) triples
    are gathered and evaluated, in chunks: the same terms, without the
    zero-weighted ones."""
    cfg = tables.cfg
    d, dt, dev = cfg.dim, cfg.dtype, euler.device
    pts = _points(val_points, cfg, dev)
    cells_map = torch.as_tensor(tables.cells_nodes_map, dtype=torch.long, device=dev)
    cells_fe = torch.as_tensor(tables.cells_nodes_fe, dtype=torch.long, device=dev)
    xq, normals, jxw, f_q, u_q, f_nodes, u_nodes = _smooth_fields(
        velocities_flat, forces_flat, euler, tables
    )

    # ---- smooth part with singular panels masked per evaluation point ----
    node_xy = support_pts[cells_fe].to(dt)  # [Nc, nl, d]
    chunk = points_per_chunk(xq.shape[0] * xq.shape[1], d, dt)
    val, hits = [], []
    for s in range(0, pts.shape[0], chunk):
        x = pts[s : s + chunk]
        dist2 = torch.sum((node_xy[None] - x[:, None, None, :]) ** 2, dim=-1)  # [p, Nc, nl]
        hit = dist2 < match_tol**2
        sing_panel = torch.any(hit, dim=-1)  # [p, Nc]
        hit_p, hit_c, hit_l = torch.nonzero(hit, as_tuple=True)
        hits.append(torch.stack([hit_p + s, hit_c, hit_l]))
        R = xq[None] - x[:, None, None, :]
        R = torch.where(sing_panel[:, :, None, None], torch.ones_like(R), R)
        if cfg.kernel == KERNEL_FREE_SPACE:
            G, W = stokeslet_G(R), stresslet_W(R)
        else:
            x_img = image_point(x, cfg.wall_axis, cfg.wall_position)
            R_img = xq[None] - x_img[:, None, None, :]
            R_img = torch.where(sing_panel[:, :, None, None], torch.ones_like(R_img), R_img)
            G, W = _image_pair(cfg, R, R_img)
        Wn = torch.einsum("pcqijk,cqk->pcqij", W, normals)
        del W
        w = jxw[None] * (~sing_panel)[:, :, None].to(dt)  # [p, Nc, nq]
        val.append(
            torch.einsum("pcqij,cqj,pcq->pi", G, f_q, w)
            - torch.einsum("pcqij,cqj,pcq->pi", Wn, u_q, w)
        )
    val = torch.cat(val)
    hit_p, hit_c, hit_l = torch.cat(hits, dim=1)

    # ---- singular panels: per-local-node singular rules ----
    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    euler_cells = euler[cells_map].to(dt)
    sq_w = t(tables.sq_weights)  # [nl, qs]
    ec = euler_cells[hit_c]  # [H, nl_map, d]
    xq_s = torch.einsum("hqm,hmd->hqd", t(tables.sphi_map)[hit_l], ec)  # [H, qs, d]
    J = torch.einsum("hqmk,hmd->hqdk", t(tables.sdphi_map)[hit_l], ec)
    nrm = parametric_normal(J, d)
    jac = torch.linalg.vector_norm(nrm, dim=-1)
    flip = t(tables.flip_sign)[hit_c][:, None, None]
    normals_s = nrm / jac[..., None] * flip
    jxw_s = jac * sq_w[hit_l]  # [H, qs]
    sphi = t(tables.sphi_fe)[hit_l]  # [H, qs, nl]
    f_qs = torch.einsum("hqm,hmd->hqd", sphi, f_nodes[cells_fe[hit_c]])
    u_qs = torch.einsum("hqm,hmd->hqd", sphi, u_nodes[cells_fe[hit_c]])
    x = pts[hit_p][:, None, :]  # [H, 1, d]
    Rs = xq_s - x
    wz = (jxw_s == 0) | (torch.sum(Rs * Rs, -1) < 1e-28)
    Rs = torch.where(wz[..., None], torch.ones_like(Rs), Rs)
    chunk = points_per_chunk(xq_s.shape[1], d, dt)
    val_s = torch.zeros_like(val)
    for s in range(0, Rs.shape[0], chunk):
        sl = slice(s, s + chunk)
        if cfg.kernel == KERNEL_FREE_SPACE:
            Gs, Ws = stokeslet_G(Rs[sl]), stresslet_W(Rs[sl])
        else:
            xi = image_point(x[sl], cfg.wall_axis, cfg.wall_position)
            Rsi = torch.where(wz[sl][..., None], torch.ones_like(Rs[sl]), xq_s[sl] - xi)
            Gs, Ws = _image_pair(cfg, Rs[sl], Rsi)
        Wns = torch.einsum("hqijk,hqk->hqij", Ws, normals_s[sl])
        contrib = torch.einsum("hqij,hqj,hq->hi", Gs, f_qs[sl], jxw_s[sl]) - torch.einsum(
            "hqij,hqj,hq->hi", Wns, u_qs[sl], jxw_s[sl]
        )
        val_s.index_add_(0, hit_p[sl], contrib)
    return val + val_s


def approximate_velocity_gradient(
    val_points,  # [P, d]
    velocities_flat: torch.Tensor,
    forces_flat: torch.Tensor,
    euler: torch.Tensor,
    tables: AssemblyTables,
    h: float = 1e-5,
) -> torch.Tensor:
    """Central-difference velocity gradient at off-boundary points
    [P, d, d] with grad[i][j][k] = du_j/dx_k (reference `:5332-5364`; note
    the reference divides the central difference by h, i.e. uses a one-sided
    normalization — this uses the standard 2h, as the JAX package does)."""
    pts = _points(val_points, tables.cfg, euler.device)
    P, d = pts.shape
    eye = torch.eye(d, dtype=pts.dtype, device=pts.device)
    offsets = torch.cat([eye * h, -eye * h], dim=0)  # [2d, d] (+h rows first)
    shifted = (pts[:, None, :] + offsets[None, :, :]).reshape(-1, d)
    u = evaluate_stokes_bie(shifted, velocities_flat, forces_flat, euler, tables)
    u = u.reshape(P, 2 * d, d)
    grad = (u[:, :d, :] - u[:, d:, :]) / (2 * h)  # [P, k, j] = du_j/dx_k
    return grad.permute(0, 2, 1)  # [P, j, k]


def cauchy_viscous_stress(grad_u: torch.Tensor, mu: float = 1.0) -> torch.Tensor:
    """Viscous part of the Cauchy stress 2 mu e(u) from velocity gradients
    [P, d, d] (the pressure part is recovered separately or via the normal
    traction balance)."""
    return mu * (grad_u + torch.swapaxes(grad_u, -1, -2))


def make_bie_evaluator(tables):
    """Off-boundary evaluator bound to one tables object (the JAX package
    jits it once per tables; torch runs eagerly, so this is the closure
    alone)."""

    def evaluate(val_points, velocities_flat, forces_flat, euler):
        return evaluate_stokes_bie(val_points, velocities_flat, forces_flat, euler, tables)

    return evaluate


def sharded_evaluate_stokes_bie(val_points, velocities_flat, forces_flat, euler, tables, mesh):
    """Off-boundary BIE evaluation with the POINTS split over the ranks of a
    row mesh (`parallel.row_mesh`; fields replicated): the distributed
    counterpart of the reference's replicated `evaluate_stokes_bie`
    (`source/bem_stokes.cc:5366-5451`).  The points are padded to a multiple
    of the world size, each rank integrates the whole boundary against its
    own share, and an all-gather returns every value [P, d] to every rank."""
    from .parallel.sharded import all_gather_rows

    pts = _points(val_points, tables.cfg, euler.device)
    P = pts.shape[0]
    share = -(-P // mesh.world)
    pad = pts.new_full((share * mesh.world - P, pts.shape[1]), 1e6)
    mine = torch.cat([pts, pad])[mesh.rank * share : (mesh.rank + 1) * share]
    out = evaluate_stokes_bie(mine, velocities_flat, forces_flat, euler, tables)
    return all_gather_rows(out, mesh)[:P]
