"""Matrix-free monolithic frame solve: assembly-fused GMRES (port of
`bemstokes_tpu/matfree.py`).

Every materialized path stores V, K and A as [3n, 3n] buffers plus an LU:
four dense squares, 43.5 GB each in f64 at 73,740 unknowns.  This path forms
none of them: the GMRES matvec recomputes the operator inside the fused node
sweep (`ops.matfree_node.sweep_matvec`, the kernel K5 on a CUDA tensor; where
every column of the system is single-layer, as on every all-body mesh, it
sweeps V alone) and adds the exact sparse corrections:

- singular / near-pair quadrature deltas as COO triplets
  (`ops.assemble._singular_coo` / `_near_coo`: the same arrays the
  materialized path scatters into the dense operators);
- the rank-1 V null-space fix as an analytic rank-1 action
  (V + (n - Vn)(Mn)^T/l2) @ u = V u + (n - Vn) (Mn.u)/l2;
- the K solid-angle diagonal replacement as a [d, d, n] block-diagonal
  apply, with the versor row sums C = K e_b computed by ONE batched setup
  sweep (component-restricted columns when alpha_row_sum="component");
- hanging-node rows as a functional row replacement
  (out[slave] = x[slave] - sum w_k x[master_k]).

Preconditioner: block-Jacobi of materialized diagonal node blocks of A
(assembled per block by `ops.assemble.assemble_rows`, so each block holds
its singular/near corrections; slave and padding rows become identity),
closed with an EXACT bordered Schur complement over the rigid(+torque) tail
so the saddle rows are solved, not just scaled.

Not carried over from the JAX package: its host-driven loop of one GMRES
cycle per dispatch (a work-around for a remote-execution watchdog; here
`la.gmres.gmres` runs all restarts in one call, each from the true
residual, so the iteration counts are the same); its `jax.jit` staging;
the fake far-away rows that pad its last block to the common shape (the
last block is assembled ragged and set into an identity of the common size,
which is the same matrix).
"""

from __future__ import annotations

import numpy as np
import torch

from .fem.geometry import support_points
from .la.gmres import gmres
from .ops.assemble import _near_coo, _singular_coo, assemble_rows
from .ops.corrections import tangential_projector
from .ops.matfree_node import build_sweep_arrays, sweep_matvec, sweep_static
from .ops.monolithic import (
    GRID_IMPOSED_VELOCITY,
    GRID_REAL,
    imposed_tail_vector,
    operator_column_mask,
)
from .physics.rigid import (
    build_mass_operator,
    flatten,
    normal_vector_l2,
    rigid_modes,
    surface_mass_and_com,
    unflatten,
)
from .utils import timers


def _delta_apply(coo, vals, x, out_len):
    """COO action out[ri] += vals * x[ci] of the triplets coo = (ri, ci),
    for x [dn] or [dn, B].  The triplets were filtered to rows < out_len
    when the frame was set up (`_kept_coo`)."""
    ri, ci = coo
    upd = vals * x[ci] if x.ndim == 1 else vals[:, None] * x[ci]
    out = torch.zeros((out_len,) + tuple(x.shape[1:]), dtype=upd.dtype, device=upd.device)
    return out.index_put_((ri,), upd, accumulate=True)


def _kept_coo(coos, out_len):
    """The singular and near triplets as one set (ri, ci), dV, dK, without
    those whose row index is out of range (the JAX package scatters with
    `mode="drop"`; torch has no drop mode, `ops.assemble.scatter_coo`)."""
    coos = [c for c in coos if c is not None]
    ri, ci, dV, dK = (torch.cat([c[k] for c in coos]) for k in range(4))
    keep = ri < out_len
    return (ri[keep], ci[keep]), dV[keep], dK[keep]


class MatfreeSolver:
    """Per-problem matrix-free solve state (sweep statics, constraint index
    tables).  Built lazily by StokesBEMProblem the first time
    cfg.matrix_free routes a frame here."""

    def __init__(self, problem):
        p = problem
        self.p = p
        cfg = p.cfg
        d, n = p.dim, p.n
        dev = p.device
        self.d, self.n = d, n
        self.dn = d * n
        self.R = p.num_rigid
        self.with_torque = bool(cfg.solve_with_torque)
        self.RT = self.R + (1 if self.with_torque else 0)
        self.has_torque_dual = (
            cfg.solve_with_torque or cfg.imposed_rotation_as_flagellum_shape
        )
        self.dt = p.asm_cfg.dtype
        self.st = sweep_static(p.tables, n)
        self.labels = (
            None
            if p.node_component_label is None
            else np.unique(np.asarray(p.node_component_label))
        )
        # preconditioner blocking over nodes (component-blocked flat layout:
        # block k owns rows/cols {a*n + i : i in [k*bn, (k+1)*bn)})
        self.bn = int(min(cfg.matfree_block_nodes, n))
        self.nblk = -(-n // self.bn)
        self.npad = self.nblk * self.bn
        fd = cfg.solver.preconditioner_dtype
        self.factor_dt = torch.float32 if fd == "float32" else self.dt
        # hanging-node row-replacement tables (static)
        hc = p.hanging
        if hc.n:
            comp = np.arange(d)[:, None] * n
            self.h_rows = torch.as_tensor(
                (hc.slaves[None, :] + comp).reshape(-1), dtype=torch.long, device=dev
            )
            M = hc.masters.shape[1]
            self.h_cols = torch.as_tensor(
                (hc.masters[None, :, :] + comp[:, :, None]).reshape(-1, M),
                dtype=torch.long,
                device=dev,
            )
            self.h_wts = torch.as_tensor(
                np.broadcast_to(np.asarray(hc.weights)[None], (d, hc.n, M)).reshape(-1, M),
                dtype=self.dt,
                device=dev,
            )
        else:
            self.h_rows = None

    # ------------------------------------------------------------------
    def _versor_columns(self):
        """Static K setup columns for the solid-angle row sums: e_b per
        component (optionally restricted per connected component label —
        reference full-row replacement `source/bem_stokes.cc:3044-3098`,
        component restriction as ops.corrections.k_solid_angle_correction)."""
        d, n = self.d, self.n
        cols = []
        if self.labels is None:
            for b in range(d):
                e = np.zeros((d * n,))
                e[b * n : (b + 1) * n] = 1.0
                cols.append(e)
        else:
            lab = np.asarray(self.p.node_component_label)
            for b in range(d):
                for L in self.labels:
                    e = np.zeros((d * n,))
                    e[b * n : (b + 1) * n] = (lab == L).astype(float)
                    cols.append(e)
        return torch.as_tensor(
            np.stack(cols, axis=1), dtype=self.dt, device=self.p.device
        )  # [dn, BKv]

    def _solid_angle_vals(self, C):
        """[d, d, n] diagonal-block replacement values from the versor row
        sums C [dn, d] (mirrors k_solid_angle_correction exactly)."""
        d, n = self.d, self.n
        cfg = self.p.cfg
        if self.p.node_component_alpha is None:
            alpha = 1.0
        else:
            alpha = torch.as_tensor(
                self.p.node_component_alpha, dtype=self.dt, device=C.device
            )
        Cab = C.reshape(d, n, d)  # [a, i, b]
        tgt = alpha - 1.0 if cfg.use_internal_alpha else alpha
        eye = torch.eye(d, dtype=self.dt, device=C.device)[:, :, None]
        return -Cab.permute(0, 2, 1) + eye * tgt

    def _sa_apply(self, sa_vals, w):
        """Block-diagonal solid-angle action on a flat [dn] (or [dn, B])
        vector."""
        d, n = self.d, self.n
        if w.ndim == 1:
            return torch.einsum("abi,bi->ai", sa_vals, w.reshape(d, n)).reshape(d * n)
        return torch.einsum("abi,biB->aiB", sa_vals, w.reshape(d, n, -1)).reshape(
            d * n, w.shape[1]
        )

    # ------------------------------------------------------------------
    def _setup(self, euler, sdot_flat, rotation):
        """Geometry, sweep tables, COO deltas, and ONE batched setup sweep
        providing every operator application the corrections and the rhs
        need (Vn, versor row sums, K P_t N_r, K P_t sdot, K P_t
        torque-mode)."""
        p = self.p
        cfg = p.cfg
        d, n, R = self.d, self.n, self.R
        dn = self.dn
        dt, dev = self.dt, p.device
        euler = p._as_device(euler)
        sdot_flat = p._as_device(sdot_flat)

        mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, p.tables)
        body_mask_nodes = p._body_node_mask_t
        mass_body, com_body = surface_mass_and_com(xq, jxw, p._body_cell_mask_t)
        pole = p.force_pole_point(com_body)
        sp = support_points(euler, p.map_space, p.fe_space).to(dt)
        N = rigid_modes(sp, pole, node_mask=body_mask_nodes)
        N_complete = rigid_modes(sp, pole)
        N_dual = mass_op.matvec(N)
        N_dual_complete = mass_op.matvec(N_complete)
        nv = normal_vector_l2(mass_op, normals_q, jxw, body_mask_nodes)
        n_pure_f = flatten(nv["normal_pure"])
        Mn_pure_f = flatten(nv["M_normal_pure"])
        l2g = nv["l2_gamma_pure"]

        arrs = build_sweep_arrays(self.st, p.tables, sp, xq, normals_q, jxw)
        coo, dV, dK = _kept_coo(
            [
                _singular_coo(euler, sp, p.tables, 0, n, subtract_smooth=True),
                _near_coo(
                    euler, sp, sp, torch.arange(n, dtype=torch.long, device=dev), p.tables, n
                ),
            ],
            dn,
        )

        def Pt(v):  # v [dn] or rows [B, dn]
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g)

        # ---- one batched sweep for every setup application ----
        versors = self._versor_columns()
        nBv = versors.shape[1]
        PtN = Pt(flatten(N))  # [R, dn]
        Pt_sdot = Pt(sdot_flat)
        k_cols = [versors, PtN.T, Pt_sdot[:, None]]
        torque_mode_flat = None
        torque_dual = None
        if self.has_torque_dual:
            torque_mode_flat = flatten(p.flagellum_torque_mode(euler, rotation))
            torque_dual = flatten(mass_op.matvec(unflatten(torque_mode_flat, d)))
            Pt_tq = Pt(torque_mode_flat)
            k_cols.append(Pt_tq[:, None])
        XK = torch.cat(k_cols, dim=1)
        XV = n_pure_f[:, None]
        VX, KX = sweep_matvec(self.st, arrs, XV, XK)
        VX = VX + _delta_apply(coo, dV, XV, dn)
        KX = KX + _delta_apply(coo, dK, XK, dn)

        Vn = VX[:, 0]  # raw V @ n_pure (the null-space residual)
        # versor row sums C[r, b] (component-restricted when labeled)
        if self.labels is None:
            C = KX[:, :nBv]
        else:
            lab_rows = torch.as_tensor(
                np.tile(np.asarray(p.node_component_label), d), device=dev
            )
            nL = len(self.labels)
            C = torch.stack(
                [
                    sum(
                        KX[:, b * nL + li] * (lab_rows == int(L)).to(dt)
                        for li, L in enumerate(self.labels)
                    )
                    for b in range(d)
                ],
                dim=-1,
            )
        sa_vals = self._solid_angle_vals(C)
        # post-correction check ||K_corr e_b||_inf restricted like the
        # materialized diagnostic: y_b = C[:, b] + vals[:, b, :]
        k_check = torch.stack(
            [
                torch.max(torch.abs(C[:, b] + sa_vals[:, b, :].reshape(-1)))
                for b in range(d)
            ]
        )

        off = nBv
        KPtN = KX[:, off : off + R]  # raw K @ P_t N_r
        # [R, dn] = P_t (K_corr P_t N_r)
        tmp_N = Pt((KPtN + self._sa_apply(sa_vals, PtN.T)).T)
        rhs_surface = Pt(KX[:, off + R] + self._sa_apply(sa_vals, Pt_sdot))
        tmp_torque = None
        if self.has_torque_dual:
            tmp_torque = Pt(KX[:, off + R + 1] + self._sa_apply(sa_vals, Pt_tq))

        sel_V = operator_column_mask(p._node_material_t, flatten(nv["normal"]), n, d)
        # which operators the matvec needs: every column single-layer (bodies,
        # no-slip and Dirichlet walls: every all-body mesh), every column
        # double-layer, or both.  One host read a frame, none a matvec.
        n_sel = int(sel_V.sum())
        side = "V" if n_sel == dn else "K" if n_sel == 0 else "both"

        # ---- rhs (mirrors ops.monolithic.build_monolithic_system) ----
        rhs_tail = torch.zeros((R,), dtype=dt, device=dev)
        if cfg.grid_type != GRID_REAL:
            rhs_head = torch.zeros((dn,), dtype=dt, device=dev)
            rhs_tail = imposed_tail_vector(
                R,
                d,
                cfg.imposed_component,
                angle=cfg.angle_for_imposed_stuff,
                rotate=cfg.extra_debug_info,
                dtype=dt,
                device=dev,
            )
        else:
            rhs_head = rhs_surface
        if self.with_torque:
            rhs = torch.cat(
                [
                    torch.zeros((dn,), dtype=dt, device=dev),
                    rhs_tail,
                    torch.full((1,), cfg.imposed_motor_torque, dtype=dt, device=dev),
                ]
            )
        else:
            rhs = torch.cat([rhs_head, rhs_tail])
        if self.h_rows is not None:
            rhs[self.h_rows] = 0.0

        diagnostics = dict(
            mass_body=mass_body,
            com_body=com_body,
            v_null_residual_pre=torch.max(torch.abs(Vn)),
            k_solid_angle_check=k_check,
        )
        operators = dict(
            sel_V=sel_V,
            normal=nv,
            N=N,
            N_dual=N_dual,
            N_dual_complete=N_dual_complete,
            tmp_N=tmp_N,
            mass_jxw=jxw,
        )
        if torque_mode_flat is not None:
            operators["N_flagellum_torque"] = torque_mode_flat
            operators["N_flagellum_torque_dual"] = torque_dual
        sys = dict(
            arrs=arrs,
            coo=coo,
            dV=dV,
            dK=dK,
            Vn=Vn,
            n_pure_f=n_pure_f,
            Mn_pure_f=Mn_pure_f,
            l2g=l2g,
            sa_vals=sa_vals,
            sel_V=sel_V,
            side=side,
            tmp_N=tmp_N,
            tmp_torque=tmp_torque,
            torque_dual=torque_dual,
            N_dual_flat=flatten(N_dual),
            rhs=rhs,
            sp=sp,
            euler=euler,
        )
        return sys, operators, diagnostics

    # ------------------------------------------------------------------
    def _matvec(self, sys):
        """The monolithic operator action (closure over the frame state).

        `sys["side"]` says which operators it applies: "both" splits the
        unknown into its single-layer part u and its double-layer part w and
        sweeps V @ u and K @ w in one two-sided launch; "V" (or "K") sweeps
        the one operator alone, with a zero-width batch for the other, and
        leaves out the other's delta, rank-1 and solid-angle terms, whose
        input would be exactly zero: the same result bit for bit (up to the
        sign of a zero when only K is applied)."""
        cfg = self.p.cfg
        dn, R = self.dn, self.R
        scale = cfg.assemble_scaling
        sel = sys["sel_V"]
        side = sys["side"]
        coo, dV, dK = sys["coo"], sys["dV"], sys["dK"]
        vec_u = sys["n_pure_f"] - sys["Vn"]
        w_dual = sys["Mn_pure_f"] / sys["l2g"]
        zero = torch.zeros((), dtype=self.dt, device=sel.device)
        none = torch.zeros((dn, 0), dtype=self.dt, device=sel.device)

        def mv(x):
            xs = x[:dn]
            tail = x[dn : dn + R]
            u = none if side == "K" else xs if side == "V" else torch.where(sel, xs, zero)
            w = none if side == "V" else xs if side == "K" else torch.where(sel, zero, xs)
            Vu, Kw = sweep_matvec(self.st, sys["arrs"], u, w)
            if side != "K":
                Vu = Vu + _delta_apply(coo, dV, u, dn)
                Vu = Vu + vec_u * torch.dot(w_dual, u)
            if side != "V":
                Kw = Kw + _delta_apply(coo, dK, w, dn)
                Kw = Kw + self._sa_apply(sys["sa_vals"], w)
            head = Vu if side == "V" else -Kw if side == "K" else Vu - Kw
            top = head - scale * (tail @ sys["tmp_N"])
            if self.with_torque:
                top = top - scale * sys["tmp_torque"] * x[-1]
            if cfg.grid_type == GRID_IMPOSED_VELOCITY:
                mid = scale * tail
            elif cfg.grid_type == GRID_REAL:
                mid = scale * (sys["N_dual_flat"] @ xs)
            else:  # ImposedForce / Convergence
                mid = sys["N_dual_flat"] @ xs
            parts = [top, mid]
            if self.with_torque:
                parts.append(scale * torch.dot(sys["torque_dual"], xs)[None])
            out = torch.cat(parts)
            if self.h_rows is not None:
                out[self.h_rows] = x[self.h_rows] - torch.sum(
                    self.h_wts * x[self.h_cols], dim=1
                )
            return out

        return mv

    # ------------------------------------------------------------------
    def _block(self, sys, b0, b1, slave_scalar):
        """The diagonal node-block [b0, b1) of A, set into an identity of
        the common block size d*bn (rows of hanging slaves become identity
        too: preconditioner only)."""
        p = self.p
        d, n, bn = self.d, self.n, self.bn
        nb = b1 - b0
        dev = p.device
        ids = torch.arange(b0, b1, dtype=torch.long, device=dev)
        Vb, Kb = assemble_rows(sys["euler"], sys["sp"], sys["sp"][b0:b1], ids, b0, p.tables)
        Vblk = Vb.reshape(d, nb, d, n)[:, :, :, b0:b1]
        Kblk = Kb.reshape(d, nb, d, n)[:, :, :, b0:b1]
        sel_blk = sys["sel_V"].reshape(d, n)[:, b0:b1]  # [b, j]
        A4 = torch.where(sel_blk[None, None, :, :], Vblk, -Kblk)  # [a, i, b, j]
        # solid-angle diagonal replacement on the -K columns
        sa_blk = sys["sa_vals"][:, :, b0:b1]  # [a, b, i]
        ii = torch.arange(nb, device=dev)
        A4[:, ii, :, ii] -= (sa_blk * (~sel_blk)[None, :, :]).permute(2, 0, 1)
        keep = ~torch.as_tensor(slave_scalar[b0:b1], device=dev)
        eye4 = torch.eye(d * nb, dtype=A4.dtype, device=dev).reshape(d, nb, d, nb)
        A4 = torch.where(keep[None, :, None, None], A4, eye4)
        A_blk = torch.eye(d * bn, dtype=self.factor_dt, device=dev).reshape(d, bn, d, bn)
        A_blk[:, :nb, :, :nb] = A4.to(self.factor_dt)
        return A_blk.reshape(d * bn, d * bn)

    def _build_blocks(self, sys):
        """Sequential per-block assembly and factorization (memory stays at
        one [d*bn, d*n] row panel of V and of K)."""
        slave_scalar = np.zeros(self.n, bool)
        if self.h_rows is not None:
            slave_scalar[np.asarray(self.p.hanging.slaves)] = True
        lus, pivs = [], []
        for k in range(self.nblk):
            b0 = k * self.bn
            lu, piv = torch.linalg.lu_factor(
                self._block(sys, b0, min(b0 + self.bn, self.n), slave_scalar)
            )
            lus.append(lu)
            pivs.append(piv)
        return torch.stack(lus), torch.stack(pivs)

    # ------------------------------------------------------------------
    def _ms_inv(self, lus, pivs):
        d, n, bn = self.d, self.n, self.bn
        fdt = self.factor_dt

        def apply(v):  # [dn] or [dn, B]
            B = 1 if v.ndim == 1 else v.shape[1]
            v3 = torch.zeros((d, self.npad, B), dtype=fdt, device=v.device)
            v3[:, :n] = v.reshape(d, n, B)
            vb = v3.reshape(d, self.nblk, bn, B).permute(1, 0, 2, 3).reshape(self.nblk, d * bn, B)
            xb = torch.linalg.lu_solve(lus, pivs, vb)
            x3 = xb.reshape(self.nblk, d, bn, B).permute(1, 0, 2, 3).reshape(d, self.npad, B)
            return x3[:, :n].reshape(v.shape).to(v.dtype)

        return apply

    def _schur(self, sys, ms_inv):
        """Bordered Schur closure over the rigid(+torque) tail: the pieces
        the preconditioner applies every iteration, computed once."""
        cfg = self.p.cfg
        dn, R = self.dn, self.R
        dt, dev = self.dt, self.p.device
        scale = cfg.assemble_scaling
        C_cols = [-scale * sys["tmp_N"].T]  # [dn, R]
        if self.with_torque:
            C_cols.append(-scale * sys["tmp_torque"][:, None])
        C = torch.cat(C_cols, dim=1)
        if self.h_rows is not None:
            C[self.h_rows, :] = 0.0
        B_rows = []
        if cfg.grid_type == GRID_IMPOSED_VELOCITY:
            B_rows.append(torch.zeros((R, dn), dtype=dt, device=dev))
            D = scale * torch.eye(R, dtype=dt, device=dev)
        elif cfg.grid_type == GRID_REAL:
            B_rows.append(scale * sys["N_dual_flat"])
            D = torch.zeros((R, R), dtype=dt, device=dev)
        else:
            B_rows.append(sys["N_dual_flat"])
            D = torch.zeros((R, R), dtype=dt, device=dev)
        if self.with_torque:
            B_rows.append(scale * sys["torque_dual"][None, :])
            D = torch.nn.functional.pad(D, (0, 1, 0, 1))
        B = torch.cat(B_rows, dim=0)  # [RT, dn]
        MsC = ms_inv(C)  # [dn, RT]
        S_lu, S_piv = torch.linalg.lu_factor(D - B @ MsC)
        return dict(B=B, MsC=MsC, S_lu=S_lu, S_piv=S_piv)

    def _precond(self, pre, ms_inv):
        dn = self.dn

        def precond(v):
            vs, t = v[:dn], v[dn:]
            ys = ms_inv(vs)
            t2 = torch.linalg.lu_solve(
                pre["S_lu"], pre["S_piv"], (t - pre["B"] @ ys)[:, None]
            )[:, 0]
            return torch.cat([ys - pre["MsC"] @ t2, t2])

        return precond

    def _gmres(self, sys, pre, ms_inv):
        restart, max_restarts = self.p._gmres_solver_params()
        return gmres(
            self._matvec(sys),
            sys["rhs"],
            precond=self._precond(pre, ms_inv),
            restart=restart,
            tol=self.p.cfg.solver.tolerance,
            max_restarts=max_restarts,
        )

    # ------------------------------------------------------------------
    def solve_frame(self, euler, sdot_flat, rotation=None):
        """Full matrix-free frame: setup sweep -> block factors -> Schur
        tail -> restarted GMRES -> the standard packed finish (same result
        contract as the materialized `solve_frame`, minus the dense A and
        the V, K operators)."""
        p = self.p
        with timers.scope("Matfree setup sweep"):
            sys, ops, diag = self._setup(euler, sdot_flat, rotation)
        with timers.scope("Matfree block preconditioner"):
            ms_inv = self._ms_inv(*self._build_blocks(sys))
            pre = self._schur(sys, ms_inv)
        with timers.scope("Matfree GMRES"):
            x, info = self._gmres(sys, pre, ms_inv)
            forces, wall, packed_dev = p._finish(
                self._matvec(sys), sys["rhs"], ops, diag, x, info["iterations"], info["residual"]
            )
            packed = packed_dev.cpu().numpy()
        return p._unpack_result(None, sys["rhs"], ops, forces, wall, packed, False)
