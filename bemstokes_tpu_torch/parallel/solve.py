"""Sharded end-to-end frame step (port of `bemstokes_tpu/parallel/solve.py`):
row-partitioned assembly, slab-layout operator corrections, the implicit
monolithic matvec and preconditioned GMRES: the distributed counterpart of
`StokesBEMProblem._pipeline` + `solve_frame`, with every dense operator held
as one row slab per rank (`parallel.sharded`) and no rank holding the whole
matrix.

The JAX package compiles the step (two variants with `jax.jit`); the port
runs it eagerly and keeps the same host-side state machine.  Every rank
computes the replicated values (geometry, rigid modes, normals) itself,
like the JAX package's devices; the ones that go through a mass-matrix or
support-point scatter (`index_add_`, whose order on a CUDA card changes
between runs) are then broadcast from rank 0, so that the GMRES iterates,
and the branches taken on them, are the same on every rank.

In the tracer (`utils/timers.py`) a frame's slab system (V, K and A slabs
with their corrections, the tail and the right-hand side) is the scope
"Slab assembly", and each product with a slab operator inside GMRES the
span "Sharded matvec" (attributes `world` and `m`, the rows a rank holds);
the slab LU's scope and span are `parallel/lu.py`'s, and every collective
is counted by `sharded.collective`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..fem.geometry import support_points
from ..la.direct import bordered_solver, lu_apply, lu_factor_dense, lu_solve_dense, pivots_to_permutation
from ..la.gmres import gmres, restart_params
from ..ops import lu_trsv
from ..ops.corrections import tangential_projector
from ..ops.monolithic import SaddleTail, operator_column_mask
from ..physics.kinematics import update_rotation_matrix
from ..physics.rigid import (
    build_mass_operator,
    flatten,
    normal_vector_l2,
    rigid_modes,
    surface_mass_and_com,
    unflatten,
)
from ..utils import timers
from .lu import slab_lu_factor, slab_lu_solve, slab_reorder_columns
from .multihost import replicate_to_global
from .sharded import (
    RowMesh,
    collective,
    flat_to_slab,
    padded_rows,
    sharded_assemble,
    sharded_matvec,
    slab_to_flat,
)


def _slab_nodes(n_nodes: int, mesh: RowMesh, device):
    """(nloc, global node ids of this rank's slab [nloc], real mask)."""
    _, nloc = padded_rows(n_nodes, mesh)
    node = mesh.rank * nloc + torch.arange(nloc, device=device)
    return nloc, node, node < n_nodes


def _replicated(mesh: RowMesh, *tensors):
    """The tensors (one dtype) as rank 0 has them: one broadcast of their
    concatenation when the group has more than one rank."""
    if mesh.world == 1:
        return tensors
    flat = replicate_to_global(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o : o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


def slab_rank1_update(A_loc, u_loc, v_rep, mesh: RowMesh):
    """A += outer(u, v) with u this rank's slab piece and v replicated
    (in place)."""
    return A_loc.addr_(u_loc, v_rep)


def slab_solid_angle_correction(
    K_loc,
    n_nodes,
    dim,
    mesh: RowMesh,
    use_internal_alpha=False,
    component_labels=None,
    component_alpha=None,
    return_check=False,
):
    """Distributed `ops.corrections.k_solid_angle_correction`: each rank
    corrects the diagonal blocks of its own rows (in place).  With
    `component_labels`/`component_alpha` the row sums are restricted to each
    node's own connected component.  With `return_check` also returns the
    post-correction versor check [d] (max restricted row sum per component,
    from the rows in hand, reduced over the ranks)."""
    n, d = n_nodes, dim
    dev = K_loc.device
    nloc, node, valid = _slab_nodes(n, mesh, dev)
    nc = node.clamp(max=n - 1)
    if component_labels is None:
        same = None
        shift = 0.0 if use_internal_alpha else 1.0
    else:
        lab = torch.as_tensor(component_labels, device=dev)
        same = lab[nc].repeat(d)[:, None] == lab[None, :]  # [d*nloc, n]
        alpha = torch.as_tensor(component_alpha, dtype=K_loc.dtype, device=dev)[nc]
        shift = alpha - 1.0 if use_internal_alpha else alpha

    def row_sums():
        blocks = [K_loc[:, b * n : (b + 1) * n] for b in range(d)]
        if same is not None:
            blocks = [blk * same for blk in blocks]
        return torch.stack([blk.sum(dim=1) for blk in blocks], dim=-1)  # [d*nloc, d]

    C = row_sums()
    ar = torch.arange(d, device=dev)
    i = torch.arange(nloc, device=dev)
    rows = (ar[:, None, None] * nloc + i[None, None, :]).expand(d, d, nloc)
    cols = (ar[None, :, None] * n + node[None, None, :]).expand(d, d, nloc)
    eye = torch.eye(d, dtype=K_loc.dtype, device=dev)[:, :, None]
    vals = -C.reshape(d, nloc, d).permute(0, 2, 1) + eye * shift  # [a, b, i]
    keep = valid.expand(d, d, nloc)
    K_loc.index_put_((rows[keep], cols[keep]), vals[keep], accumulate=True)
    if not return_check:
        return K_loc
    C2 = torch.where(valid.repeat(d)[:, None], row_sums(), 0.0)
    check = torch.max(torch.abs(C2), dim=0).values
    return K_loc, collective("all_reduce", check, mesh, op=dist.ReduceOp.MAX)


def slab_apply_hanging_constraints(A_loc, hc, n_nodes, dim, mesh: RowMesh):
    """Distributed `mesh.constraints.apply_hanging_constraints_monolithic`:
    each rank overwrites the d rows of the hanging nodes it owns with the
    interpolation identity u_h - sum_k w_k u_{m_k} = 0 (reference
    constrained-row assembly `source/bem_stokes.cc:2970-2995`, woven through
    the distributed row maps `:1661-1712`).  Rows in slab layout, columns
    flat; in place."""
    if hc.n == 0:
        return A_loc
    n, d = n_nodes, dim
    _, nloc = padded_rows(n, mesh)
    node = mesh.rank * nloc + np.arange(nloc)
    slave_of = np.full(n, -1)
    slave_of[hc.slaves] = np.arange(hc.n)
    owned = np.flatnonzero(node < n)
    owned = owned[slave_of[node[owned]] >= 0]  # local slots of owned slaves
    if owned.size == 0:
        return A_loc
    h = slave_of[node[owned]]
    a = np.arange(d)[:, None]
    rows = (a * nloc + owned[None, :]).reshape(-1)  # [d*H]
    A_loc[torch.as_tensor(rows, device=A_loc.device)] = 0.0
    M = hc.masters.shape[1]
    ri = np.concatenate([rows, np.repeat(rows, M)])
    ci = np.concatenate(
        [
            (a * n + node[owned][None, :]).reshape(-1),
            (a[:, :, None] * n + hc.masters[h][None, :, :]).reshape(-1),
        ]
    )
    vals = np.concatenate([np.ones(rows.size), np.broadcast_to(-hc.weights[h], (d,) + hc.weights[h].shape).reshape(-1)])
    dev = A_loc.device
    A_loc.index_put_(
        (torch.as_tensor(ri, device=dev), torch.as_tensor(ci, device=dev)),
        torch.as_tensor(vals, dtype=A_loc.dtype, device=dev),
        accumulate=True,
    )
    return A_loc


def slab_block_jacobi_lu(A_loc, tail_rows, n_nodes, dim, n_rigid, mesh: RowMesh):
    """Factor this rank's diagonal block (its rows x its columns) for a
    block-Jacobi preconditioner: for each component b the columns
    [b*n + r0, b*n + r0 + nr) of the nr real nodes, with the identity on the
    padded rows and columns.  Returns torch's (LU, pivots) of the
    [d*nloc, d*nloc] block.

    (The JAX package takes the columns with `dynamic_slice`, which clamps its
    start so that the slice fits: on the last device of a padded partition
    its block is the columns of nodes [n - nloc, n), shifted by the pad
    count; the port takes the block the JAX docstring names.)"""
    n, d = n_nodes, dim
    _, nloc = padded_rows(n, mesh)
    r0 = mesh.rank * nloc
    nr = max(0, min(nloc, n - r0))
    dev = A_loc.device
    own = torch.eye(d * nloc, dtype=A_loc.dtype, device=dev)
    if nr > 0:
        j = torch.arange(nr, device=dev)
        b = torch.arange(d, device=dev)[:, None]
        local = (b * nloc + j).reshape(-1)
        cols = (b * n + r0 + j).reshape(-1)
        own[local[:, None], local[None, :]] = A_loc[local][:, cols]
    return lu_factor_dense(own)


def slab_block_jacobi_apply(lu_loc, piv_loc, v_loc, mesh: RowMesh):
    return lu_solve_dense((lu_loc, piv_loc), v_loc)


def slab_diagonal(A_loc, n_nodes, dim, mesh: RowMesh):
    """This rank's diagonal entries of its own rows (slab piece [d*nloc],
    one on padded rows): the distributed Jacobi preconditioner."""
    n, d = n_nodes, dim
    nloc, node, valid = _slab_nodes(n, mesh, A_loc.device)
    rows = torch.arange(d * nloc, device=A_loc.device)
    a, i = rows // nloc, rows % nloc
    cols = (a * n + node[i]).clamp(max=d * n - 1)
    return torch.where(valid[i], A_loc[rows, cols], torch.ones((), dtype=A_loc.dtype, device=A_loc.device))


def _build_sharded_operators(problem, dmesh: RowMesh, euler, return_check=False):
    """Geometry, rigid modes, L2 normals, sharded assembly and the two slab
    operator corrections: the shared prefix of the monolithic and resistance
    distributed steps (the distributed analog of the first half of
    `StokesBEMProblem._pipeline`)."""
    tables = problem.tables
    cfg = problem.cfg
    d, n = problem.dim, problem.n
    dt = tables.cfg.dtype
    euler = problem._as_device(euler)
    mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, tables)
    body_nodes = problem._body_node_mask_t
    mass_body, com_body = surface_mass_and_com(xq, jxw, problem._body_cell_mask_t)
    pole = problem.force_pole_point(com_body)
    sp = support_points(euler, problem.map_space, problem.fe_space).to(dt)
    N = rigid_modes(sp, pole, node_mask=body_nodes)
    N_dual = mass_op.matvec(N)
    N_dual_c = mass_op.matvec(rigid_modes(sp, pole))
    nv = normal_vector_l2(mass_op, normals_q, jxw, body_nodes)
    names = ("normal", "normal_pure", "M_normal_pure", "l2_gamma_pure")
    sp, N, N_dual, N_dual_c, *vals = _replicated(
        dmesh, sp, N, N_dual, N_dual_c, *(nv[k] for k in names)
    )
    nv = dict(zip(names, vals))
    n_pure_f = flatten(nv["normal_pure"])
    Mn_pure_f = flatten(nv["M_normal_pure"])
    l2g_pure = nv["l2_gamma_pure"]

    V_loc, K_loc = sharded_assemble(euler, sp, tables, dmesh)
    Vn_loc = sharded_matvec(V_loc, n_pure_f, dmesh)
    resid_loc = flat_to_slab(n_pure_f, n, d, dmesh) - Vn_loc
    V_loc = slab_rank1_update(V_loc, resid_loc, Mn_pure_f / l2g_pure, dmesh)
    k_out = slab_solid_angle_correction(
        K_loc,
        n,
        d,
        dmesh,
        use_internal_alpha=cfg.use_internal_alpha,
        component_labels=problem.node_component_label,
        component_alpha=problem.node_component_alpha,
        return_check=return_check,
    )
    K_loc, k_check = k_out if return_check else (k_out, None)
    return dict(
        euler=euler,
        mass_op=mass_op,
        mass_body=mass_body,
        com_body=com_body,
        pole=pole,
        sp=sp,
        N=N,
        N_dual=N_dual,
        N_dual_c=N_dual_c,
        nv=nv,
        n_pure_f=n_pure_f,
        Mn_pure_f=Mn_pure_f,
        l2g_pure=l2g_pure,
        V_slab=V_loc,
        K_slab=K_loc,
        k_check=k_check,
        resid_slab=resid_loc,
    )


def _slab_product(A_loc, x, n_nodes, dim, mesh: RowMesh):
    """A x, replicated, with A held as row slabs: this rank's slab GEMV,
    then the all-gather of the pieces (the span "Sharded matvec")."""
    with timers.span("Sharded matvec", world=mesh.world, m=A_loc.shape[0]):
        return slab_to_flat(sharded_matvec(A_loc, x, mesh), n_nodes, dim, mesh)


def _map_body(problem):
    """Body-node mask in MAP space [n_map, 1] (walls never move; reference
    rotates only body DoFs in compute_euler_vector, `:2247-2440`)."""
    map_sp = problem.map_space
    mask = np.zeros(map_sp.n_nodes)
    mask[np.unique(map_sp.cells_nodes[problem.body_cell_mask > 0])] = 1.0
    return torch.as_tensor(mask, dtype=problem.asm_cfg.dtype, device=problem.device)[:, None]


def _advance(cfg, d, euler, pole, rigid_vel, body):
    """The rigid update of the body nodes: translation, then rotation about
    the pole (forward-Euler axis-angle, reference `:4728-4846`)."""
    euler_next = euler + cfg.time_step * rigid_vel[:d][None, :] * body
    if cfg.consider_rigid_rotations:
        Rm = update_rotation_matrix(
            torch.eye(d, dtype=euler.dtype, device=euler.device),
            rigid_vel[d : 2 * d] if d == 3 else rigid_vel[d],
            cfg.time_step,
            forward_euler=True,
        )
        rotated = (euler_next - pole[None, :]) @ Rm.T + pole[None, :]
        euler_next = torch.where(body > 0, rotated, euler_next)
    return euler_next


def make_sharded_frame_step(
    problem,
    dmesh: RowMesh,
    return_fields: bool = False,
    keep_frozen_pieces: bool = False,
):
    """Build the distributed frame step for a StokesBEMProblem.

    Returns step(euler, sdot_flat, rotation=None) -> (rigid_velocities [R],
    euler_next, info) running: sharded assembly -> slab corrections ->
    implicit monolithic GMRES -> rigid update (translation + rotation of body
    nodes about the force pole).  Every rank of `dmesh` calls it with the
    same arguments and gets the same (replicated) results.  With
    `return_fields` the step additionally returns a fields dict (forces, wall
    velocities, rigid modes, normals, rigid force sums, per-frame invariant
    diagnostics) so that the swimmer frame loop can write its full output
    set from the distributed solve (SwimmerSimulation with cfg.distributed).

    Config parity with the single-card path:
    - `solver.gmres_restart` / `solver.max_steps` bound the Arnoldi work
      exactly like `StokesBEMProblem.solve_frame`;
    - `solver.preconditioner_type == "Direct"` uses the DISTRIBUTED stale-LU
      preconditioner (`parallel.lu`): the slab surface block is factored by
      the blocked LU, the R rigid tail rows/columns are folded in exactly
      via a bordered Schur complement (one distributed LU solve per
      application), and the factors are REUSED across frames with the
      reference's refactor-on-iteration-trigger semantics
      (`source/direct_preconditioner.cc`, trigger `source/bem_stokes.cc:
      4336-4339, 5768-5779`); `solver.preconditioner_dtype == "float32"`
      factors in f32;
    - `solver.preconditioner_type == "Jacobi"` uses the distributed diagonal;
      every other type maps to block-Jacobi LU, each rank's diagonal block
      its local dense LU;
    - `time_integration == "Heun"` is provided by `sharded_heun_step`;
    - `solve_with_torque` adds the motor-torque unknown: an extra rigid
      column (-scale tmp_torque) on the surface rows, the motor balance row,
      and the omega/motor-torque output set, all folded through the bordered
      tail of the distributed LU (reference `source/bem_stokes.cc:3191-3192,
      3252-3256, 3297-3356`);
    - hanging-node constraints are applied in slab layout
      (`slab_apply_hanging_constraints`), matching the single-card
      monolithic constraint rows (reference `:1654-1712, 2970-2995`).
    """
    cfg = problem.cfg
    if not cfg.monolithic:
        return make_sharded_resistance_step(problem, dmesh, return_fields)
    if keep_frozen_pieces and (
        cfg.solve_with_torque
        or cfg.grid_type != "Real"
        or cfg.solver.preconditioner_type != "Direct"
    ):
        raise ValueError(
            "the frozen-geometry fast path needs grid_type='Real', no "
            "torque unknown, and the Direct preconditioner (matching the "
            "single-card solve_frame_frozen semantics)"
        )
    d, n = problem.dim, problem.n
    dn = d * n
    R = problem.num_rigid
    # the motor-torque unknown (one extra column and balance row, rank-0 rows
    # in the reference `:3297-3352`) lives in the SaddleTail; its mode also
    # gives the transmitted torque under an imposed rotation
    with_torque = bool(cfg.solve_with_torque)
    with_torque_dual = with_torque or cfg.imposed_rotation_as_flagellum_shape
    dt = problem.asm_cfg.dtype
    dev = problem.device
    scale = cfg.assemble_scaling
    body = _map_body(problem)
    agree = dmesh.agree if dmesh.world > 1 else None
    _, nloc = padded_rows(n, dmesh)

    def build_system(euler, sdot_flat, rotation):
        """Sharded assembly + corrections + implicit monolithic system: the
        pieces every preconditioner variant shares.  `rotation` is the
        accumulated body rotation (read by the flagellum torque mode only,
        like the single-card pipeline)."""
        ops = _build_sharded_operators(problem, dmesh, euler, return_check=return_fields)
        euler = ops["euler"]
        nv = ops["nv"]
        n_pure_f, Mn_pure_f, l2g_pure = ops["n_pure_f"], ops["Mn_pure_f"], ops["l2g_pure"]
        V_loc, K_loc = ops.pop("V_slab"), ops.pop("K_slab")

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        def PKP(v):  # v [dn] or rows [B, dn]
            x = P_t(v).reshape(-1, dn)
            Kx = slab_to_flat(K_loc @ x.T, n, d, dmesh)  # [dn, B]
            return P_t(Kx.T).reshape(v.shape)

        N_flat = flatten(ops["N"])  # [R, dn]
        tmp_N = PKP(N_flat)
        N_dual_flat = flatten(ops["N_dual"])
        rhs_surface = PKP(problem._as_device(sdot_flat))
        tmp_torque = torque_dual_flat = torque_mode_flat = None
        if with_torque_dual:
            torque_mode_flat = flatten(problem.flagellum_torque_mode(euler, rotation))
            torque_dual_flat = flatten(ops["mass_op"].matvec(unflatten(torque_mode_flat, d)))
            torque_mode_flat, torque_dual_flat = _replicated(dmesh, torque_mode_flat, torque_dual_flat)
            if with_torque:
                tmp_torque = PKP(torque_mode_flat)
        # constrained rows: the monolithic row (its rigid columns and rhs
        # entry included) is the interpolation identity; the tail leaves them
        # out, and slab_apply_hanging_constraints below rewrites the slab rows
        tail = SaddleTail.from_config(
            cfg, tmp_N, N_dual_flat, tmp_torque, torque_dual_flat, problem._constrained_t
        )

        sel_V = operator_column_mask(problem._node_material_t, flatten(nv["normal"]), n, d)
        # the surface block of the implicit monolithic operator: V or -K
        # columns, in slab rows
        A_loc = torch.where(sel_V[None, :], V_loc, -K_loc)
        del V_loc
        A_loc = slab_apply_hanging_constraints(A_loc, problem.hanging, n, d, dmesh)

        rhs = tail.rhs(rhs_surface)
        sysd = dict(euler=euler, A_slab=A_loc, tail=tail, rhs=rhs, pole=ops["pole"])
        if with_torque_dual:
            sysd["torque_dual"] = torque_dual_flat
            sysd["torque_mode_flat"] = torque_mode_flat
        if keep_frozen_pieces:
            # frozen-geometry squirmer fast path: the per-frame rhs rebuild
            # P_t K P_t sdot needs the double-layer slab and the projector
            # vectors (reference squirmer branch skipping re-assembly,
            # `source/bem_stokes.cc:5734-5759`)
            sysd["frozen"] = dict(K_slab=K_loc, n_pure_f=n_pure_f, Mn_pure_f=Mn_pure_f, l2g=l2g_pure)
        if return_fields:
            # per-frame output fields + invariant diagnostics (the swimmer
            # frame loop's txt/VTU emitters and per-frame checks); the versor
            # check comes from the correction's in-hand row sums
            sysd["fields"] = dict(
                N=ops["N"],
                normal=nv["normal"],
                N_dual_flat=N_dual_flat,
                N_dual_c_flat=flatten(ops["N_dual_c"]),
                sel_V=sel_V,
                mass_body=ops["mass_body"],
                com_body=ops["com_body"],
                rhs_norm=torch.linalg.vector_norm(rhs),
                v_null_residual_pre=torch.max(torch.abs(slab_to_flat(ops["resid_slab"], n, d, dmesh))),
                k_solid_angle_check=ops["k_check"],
            )
        return sysd

    def make_matvec(sysd):
        A_loc, tail = sysd["A_slab"], sysd["tail"]

        def matvec(x):  # x = [dn + R (+1 torque)], replicated
            return tail.apply(_slab_product(A_loc, x[:dn], n, d, dmesh), x)

        return matvec

    # ---- distributed stale-LU direct preconditioner (parallel.lu) ----
    fdt = torch.float32 if cfg.solver.preconditioner_dtype == "float32" else dt

    def direct_factor(sysd):
        """Distributed blocked LU of the surface slab, closed over the tail
        rows and columns (R rigid + optional torque) by the bordered Schur
        complement (`la.direct.bordered_solver`, in the factor dtype): the
        EXACT monolithic inverse, one distributed LU solve per application.
        Returns the preconditioner."""
        with timers.scope("DirectPreconditioner Refactorisation"):
            A2 = slab_reorder_columns(sysd["A_slab"], n, d, dmesh).to(fdt)
            lu, perm, plan = slab_lu_factor(A2, dmesh)
            del A2

            def surface_solve(v):  # flat [dn] or [dn, k]
                return slab_to_flat(slab_lu_solve(lu, perm, flat_to_slab(v, n, d, dmesh), dmesh, plan), n, d, dmesh)

            solve = bordered_solver(surface_solve, *(m.to(fdt) for m in sysd["tail"].border()))
        return lambda x: solve(x.to(fdt)).to(x.dtype)

    def make_precond(sysd):
        A_loc = sysd["A_slab"]
        if cfg.solver.preconditioner_type == "Jacobi":
            diag_loc = slab_diagonal(A_loc, n, d, dmesh)

            def apply_surface(v_loc):
                return v_loc / diag_loc

        else:  # block-Jacobi LU slab blocks (the SOR/SSOR/ILU/AMG analogs)
            lu_loc, piv_loc = slab_block_jacobi_lu(A_loc, None, n, d, R, dmesh)
            perm_loc = pivots_to_permutation(piv_loc)
            plan_loc = lu_trsv.plan(lu_loc)

            def apply_surface(v_loc):
                if plan_loc is None:
                    return lu_apply(lu_loc, perm_loc, v_loc)
                return plan_loc.solve(perm_loc, v_loc)

        def precond(x):
            xs, u = x[:dn], x[dn:]
            ys = slab_to_flat(apply_surface(flat_to_slab(xs, n, d, dmesh)), n, d, dmesh)
            return torch.cat([ys, u])

        return precond

    restart, max_restarts = restart_params(cfg.solver)

    def solve_and_finish(sysd, precond):
        x, info = gmres(
            make_matvec(sysd),
            sysd["rhs"],
            precond=precond,
            restart=restart,
            tol=cfg.solver.tolerance,
            max_restarts=max_restarts,
            agree=agree,
        )
        rigid_vel = x[dn : dn + R] * scale
        euler_next = _advance(cfg, d, sysd["euler"], sysd["pole"], rigid_vel, body)
        if not return_fields:
            return rigid_vel, euler_next, info
        f = sysd["fields"]
        xs = x[:dn]
        forces = torch.where(f["sel_V"], xs, 0.0)
        f = dict(
            f,
            forces=forces,
            wall_velocities=torch.where(f["sel_V"], 0.0, xs),
            F=f["N_dual_flat"] @ forces,
            F_complete=f["N_dual_c_flat"] @ forces,
        )
        if with_torque:
            # the motor-balance unknown: flagellum rotation rate omega; the
            # effective gait velocity is omega * N_flagellum_torque
            # (reference `:4398-4410`)
            omega = x[-1] * scale
            f["flagellum_omega"] = omega
            f["shape_velocities_flat"] = omega * sysd["torque_mode_flat"]
        if with_torque_dual:
            # motor torque actually transmitted (reference `:4374-4384`)
            f["motor_torque"] = torch.dot(sysd["torque_dual"], forces)
            f["torque_mode_flat"] = sysd["torque_mode_flat"]
        return rigid_vel, euler_next, info, f

    def assembled(euler, sdot_flat, rotation):
        with timers.scope("Slab assembly", world=dmesh.world, m=d * nloc):
            if rotation is None:
                rotation = torch.eye(d, dtype=dt, device=dev)
            return build_system(euler, sdot_flat, problem._as_device(rotation))

    if cfg.solver.preconditioner_type != "Direct":

        def step(euler, sdot_flat, rotation=None):
            sysd = assembled(euler, sdot_flat, rotation)
            return solve_and_finish(sysd, make_precond(sysd))

        return step

    # Direct: host-side stale-reuse bookkeeping (reference refactor-on-
    # trigger, `source/bem_stokes.cc:4336-4339`)
    state = {"factors": None, "last_iterations": 0, "refactored": False, "sysd": None}

    def step(euler, sdot_flat, rotation=None):
        reuse = (
            state["factors"] is not None
            and state["last_iterations"] <= cfg.solver.refactor_iteration_trigger
        )
        sysd = assembled(euler, sdot_flat, rotation)
        if not reuse:
            state["factors"] = None  # the old factors go before the new ones come
            state["factors"] = direct_factor(sysd)
        out = solve_and_finish(sysd, state["factors"])
        state["refactored"] = not reuse
        state["sysd"] = sysd if keep_frozen_pieces else None
        state["last_iterations"] = int(out[2]["iterations"])
        return out

    if keep_frozen_pieces:
        # frozen-geometry squirmer fast path (reference `:5734-5759`): the
        # operators, corrections and LU factors of the last full step are
        # reused; only the rhs P_t K P_t sdot is rebuilt and re-solved
        def step_frozen(sdot_flat):
            if state["sysd"] is None or state["factors"] is None:
                raise RuntimeError("frozen step requires one full step() call first")
            sysd = state["sysd"]
            fz = sysd["frozen"]

            def P_t(v):
                return tangential_projector(v, fz["n_pure_f"], fz["Mn_pure_f"], fz["l2g"])

            sdot = problem._as_device(sdot_flat)
            rhs_surface = P_t(slab_to_flat(sharded_matvec(fz["K_slab"], P_t(sdot), dmesh), n, d, dmesh))
            rhs = sysd["tail"].frozen_rhs(rhs_surface)
            sysd2 = dict(sysd, rhs=rhs)
            if return_fields:
                sysd2["fields"] = dict(sysd["fields"], rhs_norm=torch.linalg.vector_norm(rhs))
            out = solve_and_finish(sysd2, state["factors"])
            state["last_iterations"] = int(out[2]["iterations"])
            state["refactored"] = False
            return out

        step.frozen = step_frozen

    step.stale_state = state
    return step


def make_sharded_resistance_step(problem, dmesh: RowMesh, return_fields: bool = False):
    """Distributed non-monolithic (grand resistance matrix) strategy: the
    sharded counterpart of `StokesBEMProblem._solve_frame_resistance`
    (reference `solve_system(monolithic=false)` on distributed vectors,
    `source/bem_stokes.cc:4163-4258`, D2N `:4073-4129`).

    Each Dirichlet-to-Neumann application f = P_t V^-1 P_t K P_t v runs as
    GMRES over the slab matvec of V preconditioned by the distributed
    blocked LU of V (the reference's GMRES + DirectPreconditioner inner
    solve, `:4106-4117`); the R+1 D2N solves share one factorization.  The
    R x R resistance system is replicated (the reference's rank-0 tiny
    GMRES, `:4244-4258`)."""
    cfg = problem.cfg
    if problem.hanging.n:
        # the reference's resistance path predates constraints too: its D2N
        # operates on the raw V/K blocks with no constrained rows
        # (`:4073-4129` has no ConstraintMatrix use); refuse rather than
        # silently drop the interpolation conditions
        raise NotImplementedError(
            "the resistance strategy does not support hanging-node meshes "
            "(the reference's dirichlet_to_neumann_operator has no "
            "constraint handling either); use the monolithic strategy"
        )
    d, n = problem.dim, problem.n
    R = problem.num_rigid
    dt = problem.asm_cfg.dtype
    dev = problem.device
    restart, max_restarts = restart_params(cfg.solver)
    body = _map_body(problem)
    agree = dmesh.agree if dmesh.world > 1 else None
    _, nloc = padded_rows(n, dmesh)

    def step(euler, sdot_flat, rotation=None):
        # rotation is accepted for signature parity with the monolithic
        # step; the resistance strategy has no torque mode to rotate
        with timers.scope("Slab assembly", world=dmesh.world, m=d * nloc):
            ops = _build_sharded_operators(problem, dmesh, euler, return_check=return_fields)
        V_loc, K_loc = ops["V_slab"], ops["K_slab"]
        n_pure_f, Mn_pure_f, l2g_pure = ops["n_pure_f"], ops["Mn_pure_f"], ops["l2g_pure"]

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        with timers.scope("Resistance V factor"):
            lu, perm, plan = slab_lu_factor(slab_reorder_columns(V_loc, n, d, dmesh), dmesh)

        def V_precond(x):
            return slab_to_flat(slab_lu_solve(lu, perm, flat_to_slab(x, n, d, dmesh), dmesh, plan), n, d, dmesh)

        def d2n(v):
            rhs = P_t(slab_to_flat(sharded_matvec(K_loc, P_t(v), dmesh), n, d, dmesh))
            f, info = gmres(
                lambda x: _slab_product(V_loc, x, n, d, dmesh),
                rhs,
                precond=V_precond,
                restart=restart,
                tol=cfg.solver.tolerance,
                max_restarts=max_restarts,
                agree=agree,
            )
            return P_t(f), info

        N_flat = flatten(ops["N"])  # [R, dn]
        N_dual_flat = flatten(ops["N_dual"])
        with timers.scope("Resistance D2N"):
            f_s, info_s = d2n(problem._as_device(sdot_flat))
            DN_rows, iters, res = [], info_s["iterations"], info_s["residual"]
            for r in range(R):
                fr, ir = d2n(N_flat[r])
                DN_rows.append(fr)
                iters = max(iters, ir["iterations"])
                res = torch.maximum(res, ir["residual"])
        DN_N = torch.stack(DN_rows)  # [R, dn]
        res_matrix = N_dual_flat @ DN_N.T
        rhs_R = -(N_dual_flat @ f_s)
        if cfg.grid_type == "ImposedForce":
            A_R = res_matrix
            rhs_R[cfg.imposed_component] += 1.0
        elif cfg.grid_type == "ImposedVelocity":
            A_R = torch.eye(R, dtype=dt, device=dev)
            rhs_R = torch.zeros((R,), dtype=dt, device=dev)
            rhs_R[cfg.imposed_component] = 1.0
        else:
            A_R = res_matrix
        U = torch.linalg.solve(A_R, rhs_R)
        forces = f_s + U @ DN_N
        euler_next = _advance(cfg, d, ops["euler"], ops["pole"], U, body)
        # the worst inner D2N residual, so that the frame loop's convergence
        # warning fires when any of the R+1 V-solves fails to converge
        info = dict(iterations=iters, residual=res)
        if not return_fields:
            return U, euler_next, info
        fields = dict(
            forces=forces,
            wall_velocities=torch.zeros_like(forces),
            resistance_matrix=res_matrix,
            N=ops["N"],
            normal=ops["nv"]["normal"],
            N_dual_flat=N_dual_flat,
            F=N_dual_flat @ forces,
            F_complete=flatten(ops["N_dual_c"]) @ forces,
            mass_body=ops["mass_body"],
            com_body=ops["com_body"],
            rhs_norm=torch.linalg.vector_norm(rhs_R),
            v_null_residual_pre=torch.max(torch.abs(slab_to_flat(ops["resid_slab"], n, d, dmesh))),
            k_solid_angle_check=ops["k_check"],
        )
        return U, euler_next, info, fields

    return step


def sharded_heun_step(step, euler, sdot_flat, euler_pred=None, sdot_pred=None, rotation=None):
    """Heun predictor-corrector around a sharded frame step: solve at
    `euler`, re-solve at the midpoint geometry, average the rigid velocities
    (reference `source/bem_stokes.cc:5787-5835`).  Like the single-card
    `SwimmerSimulation` Heun branch, the corrector runs at the NEXT frame's
    gait shape `euler_pred` with the next frame's gait velocity `sdot_pred`
    (both default to the predictor's outputs when the gait is frozen)."""
    rigid_vel, euler_next, info = step(euler, sdot_flat, rotation)[:3]
    if euler_pred is None:
        euler_pred = euler_next
    if sdot_pred is None:
        sdot_pred = sdot_flat
    rigid_vel2, _, info2 = step(euler_pred, sdot_pred, rotation)[:3]
    return 0.5 * (rigid_vel + rigid_vel2), info, info2
