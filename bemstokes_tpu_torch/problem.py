"""StokesBEMProblem: the orchestrator (port of `bemstokes_tpu/problem.py`;
the reference's `BEMProblem<dim>`, `include/bem_stokes.h:107-660`).

The per-frame pipeline (reference `run`, `source/bem_stokes.cc:5636-5884`):

  euler(frame)
    -> rigid modes + center of mass        (physics.rigid)
    -> L2 normal vector                    (physics.rigid.normal_vector_l2)
    -> assemble V, K + corrections         (ops.assemble / ops.corrections)
    -> monolithic system                   (ops.monolithic)
    -> LU factor (fresh or stale) + GMRES  (la.direct / la.gmres)

Ported: the Direct frame solve (fresh and stale LU) and the
`solve_directly` branch in 3D, for the free-space kernel and the two image
kernels of a plane wall (`reflect_kernel`, `no_slip_kernel`), the flagellum
torque mode (`solve_with_torque`, `imposed_rotation_as_flagellum_shape`),
the frozen-geometry re-solve (`solve_frame_frozen`) and the matrix-free
solve (`cfg.matrix_free`, `matfree.py`).  Torch runs eagerly on
the problem's device (the CUDA card unless the caller passes
`device="cpu"`), in the dtype of `ProblemConfig.dtype`; the JAX package's
jitted single-dispatch fusions and its split-precision f64 GEMV
(`la/mixed.py`) have no counterpart here (every [dn, dn] product is
`A @ v`).  Every other branch raises NotImplementedError and names its
`ROADMAP.md` item.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ProblemConfig
from .fem.geometry import euler_from_mesh, support_points
from .la.direct import LUPreconditioner, lu_factor_dense, lu_solve_dense
from .la.gmres import gmres
from .mesh import SurfaceMesh, build_scalar_space
from .mesh.surface_mesh import MATERIAL_BODY
from .ops.assemble import (
    AssemblyConfig,
    KERNEL_FREE_SPACE,
    KERNEL_FREE_SURFACE,
    KERNEL_NO_SLIP,
    assemble_V_K,
    build_assembly_tables,
)
from .ops.corrections import (
    k_solid_angle_correction,
    tangential_projector,
    v_nullspace_correction,
)
from .ops.monolithic import (
    build_monolithic_system,
    imposed_tail_vector,
    operator_column_mask,
    split_monolithic_solution,
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


def _dtype_of(cfg: ProblemConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


def resolve_device(device) -> torch.device:
    """The device an entry point of the port runs on: the one asked for, or
    the CUDA card when none is.  Without a card it raises; it never carries
    on on the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "bemstokes_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain torch versions on the CPU'
        )
    return torch.device("cuda")


def _resolve_manifold(cfg: ProblemConfig):
    """Body manifold for curved high-order mapping nodes (reference attaches
    SphericalManifold/CylindricalManifold in `read_domain`,
    `source/bem_stokes.cc:609-887`)."""
    kind = getattr(cfg, "body_manifold", "none")
    if kind in (None, "none", ""):
        return None
    from .mesh.refine import (
        CylindricalManifold,
        SphericalManifold,
        SpheroidManifold,
    )

    center = getattr(cfg, "body_manifold_center", (0.0, 0.0, 0.0))
    radius = getattr(cfg, "body_manifold_radius", None)
    if kind == "sphere":
        return SphericalManifold(center[: cfg.dim], radius=radius)
    if kind == "spheroid":
        return SpheroidManifold(
            radii=getattr(cfg, "body_manifold_radii", (2.0, 1.0, 1.0)),
            center=center[: cfg.dim],
        )
    if kind == "cylinder":
        return CylindricalManifold(
            direction=cfg.cylinder.direction,
            point_on_axis=cfg.cylinder.point_on_axis,
            radius=radius,
        )
    raise ValueError(f"unknown body_manifold {kind!r}")


class StokesBEMProblem:
    """Host-side orchestration for one mesh topology on one torch device
    (`device=None`: the CUDA card; it raises where there is none).

    The mesh topology (connectivity, spaces, quadrature tables) is fixed at
    construction; geometry (the euler node-position array) changes per
    frame.  The stale LU factors of the Direct preconditioner are the state
    carried from frame to frame."""

    def __init__(
        self,
        mesh: SurfaceMesh,
        config: ProblemConfig | None = None,
        manifold=None,
        device: str | torch.device | None = None,
    ):
        self.cfg = config or ProblemConfig()
        self.device = resolve_device(device)
        if self.cfg.force_pole not in ("Origin", "Baricenter", "Point"):
            raise ValueError(
                f"force_pole must be 'Origin', 'Baricenter' or 'Point', "
                f"got {self.cfg.force_pole!r}"
            )
        if mesh.dim != 3:
            raise _not_ported("the 2D problem", "ops/resistance.py and 2D")
        if self.cfg.mixed_precision_bulk:
            raise NotImplementedError(
                "mixed_precision_bulk (f32 bulk under f64) is a TPU workaround "
                "the port does not carry over (ROADMAP.md: TPU workarounds); "
                "the port runs the bulk in the problem dtype"
            )
        self.mesh = mesh
        self.manifold = (
            manifold if manifold is not None else _resolve_manifold(self.cfg)
        )
        self.dim = mesh.dim
        self.fe_space = build_scalar_space(mesh, self.cfg.fe_degree)
        self.map_space = build_scalar_space(mesh, self.cfg.map_degree)
        self.n = self.fe_space.n_nodes
        self.num_rigid = 2 * self.dim if self.dim == 3 else self.dim + 1
        dt = _dtype_of(self.cfg)

        kernel = KERNEL_FREE_SPACE
        wall_axis, wall_position = 1, 0.0
        if self.cfg.reflect_kernel or self.cfg.no_slip_kernel:
            kernel = (
                KERNEL_FREE_SURFACE if self.cfg.reflect_kernel else KERNEL_NO_SLIP
            )
            # wall 0 defines the image plane (reference `:2861-2870`)
            if self.cfg.walls:
                w0 = self.cfg.walls[0]
                wall_axis = int(np.argmin(np.abs(np.asarray(w0.span))))
                wall_position = float(w0.position[wall_axis])

        # near-contact quadrature auto-promotion: gap below the local panel
        # diameter (distinct components, or the surface vs its wall image)
        # switches to the adaptive two-level scheme with a raised near-pair
        # order (mesh/proximity.py)
        quad = self.cfg.quadrature
        q_order, q_far = quad.order, quad.order_far
        self.quadrature_promoted = False
        if quad.auto_promote and q_far is None:
            from .mesh.proximity import min_intercomponent_gap, wall_image_gap

            cands = []
            g = min_intercomponent_gap(mesh)
            if g is not None:
                cands.append(g)
            if kernel != KERNEL_FREE_SPACE:
                cands.append(wall_image_gap(mesh, wall_axis, wall_position))
            if any(gap < diam for gap, diam in cands):
                q_far = q_order
                q_order = q_order + quad.promote_boost
                self.quadrature_promoted = True

        self.asm_cfg = AssemblyConfig(
            dim=self.dim,
            kernel=kernel,
            wall_axis=wall_axis,
            wall_position=wall_position,
            quad_order=q_order,
            quad_order_far=q_far,
            near_panels=quad.near_panels,
            singular_quadrature_order=quad.singular_order,
            singular_quadrature_type=quad.singular_type,
            dtype=dt,
        )
        self.tables = build_assembly_tables(self.fe_space, self.map_space, self.asm_cfg)

        # per-node material: a node takes the body material if any adjacent
        # cell is body, else the (first) wall material of its cells
        node_mat = np.full(self.n, np.iinfo(np.int32).max, dtype=np.int64)
        np.minimum.at(
            node_mat,
            self.fe_space.cells_nodes.ravel(),
            np.repeat(self.mesh.material_id, self.fe_space.nl),
        )
        self.node_material = node_mat.astype(np.int32)
        self.body_node_mask = (self.node_material == MATERIAL_BODY).astype(np.float64)
        self.body_cell_mask = (self.mesh.material_id == MATERIAL_BODY).astype(np.float64)
        # flagellum / head split of the body nodes at x > -0.1 on the initial
        # geometry (reference `create_wall_body_index_sets`,
        # `source/bem_stokes.cc:1967-1971`)
        init_euler = euler_from_mesh(mesh.vertices, self.map_space)
        init_sp = support_points(
            torch.as_tensor(init_euler), self.map_space, self.fe_space
        ).numpy()
        self.flagellum_node_mask = (
            (self.body_node_mask > 0) & (init_sp[:, 0] > -0.1)
        ).astype(np.float64)
        self.head_node_mask = (
            (self.body_node_mask > 0) & ~(init_sp[:, 0] > -0.1)
        ).astype(np.float64)
        # per-node component labels / alpha targets for the per-component
        # solid-angle correction (alpha_row_sum == "component")
        self.node_component_label = None
        self.node_component_alpha = None
        if getattr(self.cfg, "alpha_row_sum", "full") == "component":
            from .mesh.surface_mesh import cell_components_and_closedness

            cell_lab, closed = cell_components_and_closedness(mesh)
            lab = np.zeros(self.n, dtype=np.int32)
            lab[self.fe_space.cells_nodes.ravel()] = np.repeat(
                cell_lab, self.fe_space.nl
            )
            self.node_component_label = lab
            self.node_component_alpha = np.where(closed[lab], 1.0, 0.5).astype(
                np.float64
            )

        from .mesh.constraints import hanging_node_constraints_for_space

        self.hanging = hanging_node_constraints_for_space(mesh, self.fe_space)
        if self.cfg.apply_iges_to_frame or self.cfg.apply_iges_to_reference:
            # the reference gates these behind an OpenCASCADE build
            # (`BEM_STOKES_WITH_OCE`); there is no CAD kernel here
            raise NotImplementedError(
                "iges CAD manifolds need an OpenCASCADE-class kernel (the "
                "reference compile-gates them behind BEM_STOKES_WITH_OCE); "
                "use body_manifold sphere/spheroid/cylinder instead"
            )
        if self.cfg.galerkin:
            raise NotImplementedError(
                "the Galerkin resolution strategy is dead experimental code "
                "in the reference; use the (default) collocation assembly"
            )
        if (
            self.cfg.solver.preconditioner_type == "Direct"
            and self.cfg.solver.bandwith_preconditioner
        ):
            # the reference AssertThrows here too (`source/bem_stokes.cc:4311`)
            raise ValueError(
                "Direct preconditioner cannot be band-limited; disable "
                "bandwith_preconditioner or pick a banded type (Jacobi/SOR/"
                "SSOR/ILU)"
            )

        self.preconditioner = LUPreconditioner(
            self.cfg.solver.refactor_iteration_trigger,
            factor_dtype=(
                torch.float32
                if self.cfg.solver.preconditioner_dtype == "float32"
                else None
            ),
        )
        # stale-LU bookkeeping (reference `reassemble_preconditoner`,
        # `source/bem_stokes.cc:5679, 4336-4339`): the factorization from an
        # earlier frame is reused until a solve blows past the trigger, and
        # only then is the NEXT frame's matrix refactored
        self._last_direct_iterations = 0
        self._matfree = None  # lazy MatfreeSolver (cfg.matrix_free)

        dev = self.device
        self._node_material_t = torch.as_tensor(self.node_material, device=dev)
        self._body_node_mask_t = torch.as_tensor(self.body_node_mask, dtype=dt, device=dev)
        self._body_cell_mask_t = torch.as_tensor(self.body_cell_mask, dtype=dt, device=dev)
        self._flagellum_node_mask_t = torch.as_tensor(
            self.flagellum_node_mask, dtype=dt, device=dev
        )

    def _gmres_solver_params(self):
        restart = self.cfg.solver.gmres_restart
        max_restarts = max(1, -(-self.cfg.solver.max_steps // max(restart, 1)))
        return restart, max_restarts

    def _gmres_direct(self, A, rhs):
        restart, max_restarts = self._gmres_solver_params()
        return gmres(
            lambda v: A @ v,
            rhs,
            precond=self.preconditioner.apply,
            restart=restart,
            tol=self.cfg.solver.tolerance,
            max_restarts=max_restarts,
        )

    def _finish(self, A, rhs, ops, diag, x, solver_iters, solver_res):
        """Post-solve bookkeeping (the JAX `_finish_impl`) with ONE packed
        scalar vector to read back to the host.  `A` is the dense matrix or,
        on the matrix-free path, the matvec closure.

        Packed layout: [residual, |rhs|, rigid (R), mass, com (d),
        v_null_pre, k_check (d), F (R), F_complete (R), iters, gmres_res]
        (+ [omega] with the torque unknown, + [motor_torque] whenever the
        flagellum torque dual exists: imposed-rotation runs report the
        transmitted torque too, reference `:4374-4384`)."""
        cfg = self.cfg
        x_main = x[:-1] if cfg.solve_with_torque else x
        forces, wall_vel, rigid_vel = split_monolithic_solution(
            x_main, ops["sel_V"], self.num_rigid, cfg.assemble_scaling
        )
        # rigid forces at the pole (`:4466-4476`)
        F = flatten(ops["N_dual"]) @ forces
        F_c = flatten(ops["N_dual_complete"]) @ forces
        Ax = A(x) if callable(A) else A @ x
        parts = [
            torch.linalg.vector_norm(Ax - rhs)[None],
            torch.linalg.vector_norm(rhs)[None],
            rigid_vel,
            diag["mass_body"][None],
            diag["com_body"],
            diag["v_null_residual_pre"][None],
            diag["k_solid_angle_check"],
            F,
            F_c,
            torch.as_tensor(float(solver_iters), dtype=x.dtype, device=x.device)[None],
            torch.as_tensor(solver_res, dtype=x.dtype, device=x.device).reshape(1),
        ]
        if cfg.solve_with_torque:
            parts.append((x[-1] * cfg.assemble_scaling)[None])
        torque_dual = ops.get("N_flagellum_torque_dual")
        if torque_dual is not None:
            parts.append(torch.dot(torque_dual, forces)[None])
        return forces, wall_vel, torch.cat([p.to(x.dtype) for p in parts])

    # ------------------------------------------------------------------
    def initial_euler(self) -> torch.Tensor:
        """Initial node positions [n_map_nodes, d] (float64, on the
        problem's device)."""
        return torch.as_tensor(
            euler_from_mesh(self.mesh.vertices, self.map_space, self.manifold),
            dtype=torch.float64,
            device=self.device,
        )

    def force_pole_point(self, com_body):
        if self.cfg.force_pole == "Baricenter":
            return com_body
        if self.cfg.force_pole == "Point":
            return torch.as_tensor(
                self.cfg.force_arbitrary_point, dtype=com_body.dtype, device=com_body.device
            )
        return torch.zeros_like(com_body)

    def _as_device(self, a) -> torch.Tensor:
        """A numpy array (copied: it may be read-only) or tensor as a tensor
        of the problem's dtype on its device."""
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        return a.to(device=self.device, dtype=self.asm_cfg.dtype)

    # ------------------------------------------------------------------
    def flagellum_torque_mode(self, euler, rotation=None):
        """N_flagellum_torque [n, d]: rotation of the flagellum about the
        body-frame x-axis, expressed in world coordinates —
        N(x) = R . (e_x x (R^T x - pole)) on flagellum nodes, 0 elsewhere
        (reference `source/bem_stokes.cc:2657-2670` builds the body-frame
        mode, then `rotate_vector` applies R at `:2770`)."""
        dt, dev = self.asm_cfg.dtype, self.device
        R = (
            torch.eye(3, dtype=dt, device=dev)
            if rotation is None
            else self._as_device(rotation)
        )
        sp = support_points(self._as_device(euler), self.map_space, self.fe_space).to(dt)
        pole = self.force_pole_point(torch.zeros((3,), dtype=dt, device=dev))
        body = sp @ R - pole[None, :]  # R^T x (row-vector convention)
        ex = torch.zeros((3,), dtype=dt, device=dev)
        ex[0] = 1.0
        mode_body = torch.linalg.cross(ex.expand(body.shape), body, dim=-1)
        mode = mode_body @ R.T
        return mode * self._flagellum_node_mask_t[:, None]

    def flagellum_translation_mode(self):
        """N_flagellum_translation [n, d]: unit x-velocity of the flagellum
        nodes (reference `:2670`, not rotated)."""
        mode = torch.zeros((self.n, self.dim), dtype=self.asm_cfg.dtype, device=self.device)
        mode[:, 0] = self._flagellum_node_mask_t
        return mode

    # ------------------------------------------------------------------
    def _pipeline(self, euler, shape_velocities_flat, rotation=None):
        """Geometry -> operators -> monolithic system.  Returns the system
        plus diagnostics.  shape_velocities_flat is the component-blocked
        [d*n] projected gait velocity; `rotation` is the accumulated body
        rotation matrix (only consulted by the flagellum torque mode)."""
        cfg = self.cfg
        d = self.dim
        n = self.n
        dt = self.asm_cfg.dtype
        euler = self._as_device(euler)

        mass_op, (xq, normals_q, jxw) = build_mass_operator(euler, self.tables)
        body_mask_nodes = self._body_node_mask_t

        mass_body, com_body = surface_mass_and_com(xq, jxw, self._body_cell_mask_t)
        pole = self.force_pole_point(com_body)

        sp = support_points(euler, self.map_space, self.fe_space).to(dt)
        N = rigid_modes(sp, pole, node_mask=body_mask_nodes)  # [R, n, d]
        N_complete = rigid_modes(sp, pole)
        N_dual = mass_op.matvec(N)
        N_dual_complete = mass_op.matvec(N_complete)

        nv = normal_vector_l2(mass_op, normals_q, jxw, body_mask_nodes)
        n_pure_f = flatten(nv["normal_pure"])
        Mn_pure_f = flatten(nv["M_normal_pure"])
        l2g_pure = nv["l2_gamma_pure"]

        V, K = assemble_V_K(euler, sp, self.tables)
        V, Vn_pre = v_nullspace_correction(V, n_pure_f, Mn_pure_f, l2g_pure)
        K, k_check = k_solid_angle_correction(
            K,
            n,
            d,
            use_internal_alpha=cfg.use_internal_alpha,
            component_labels=self.node_component_label,
            component_alpha=self.node_component_alpha,
        )

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        def PKP(v):  # v [d*n] or rows [B, d*n]
            return P_t((P_t(v) @ K.T))

        tmp_N = PKP(flatten(N))  # [R, d*n]
        rhs_surface = PKP(self._as_device(shape_velocities_flat))

        sel_V = operator_column_mask(
            self._node_material_t, flatten(nv["normal"]), n, d
        )
        torque_mode_flat = None
        torque_dual_flat = None
        tmp_torque = None
        if cfg.solve_with_torque or cfg.imposed_rotation_as_flagellum_shape:
            torque_mode_flat = flatten(self.flagellum_torque_mode(euler, rotation))
            torque_dual_flat = flatten(mass_op.matvec(unflatten(torque_mode_flat, d)))
            tmp_torque = PKP(torque_mode_flat)
        A, rhs = build_monolithic_system(
            V,
            K,
            sel_V,
            tmp_N,
            flatten(N_dual),
            rhs_surface,
            grid_type=cfg.grid_type,
            imposed_component=cfg.imposed_component,
            assemble_scaling=cfg.assemble_scaling,
            tmp_torque=tmp_torque if cfg.solve_with_torque else None,
            torque_dual=torque_dual_flat if cfg.solve_with_torque else None,
            imposed_motor_torque=cfg.imposed_motor_torque,
            imposed_tail=imposed_tail_vector(
                self.num_rigid,
                d,
                cfg.imposed_component,
                angle=cfg.angle_for_imposed_stuff,
                rotate=cfg.extra_debug_info,
                dtype=dt,
                device=self.device,
            ),
        )
        if self.hanging.n:
            from .mesh.constraints import apply_hanging_constraints_monolithic

            A, rhs = apply_hanging_constraints_monolithic(A, rhs, self.hanging, n, d)
        diagnostics = dict(
            mass_body=mass_body,
            com_body=com_body,
            v_null_residual_pre=torch.max(torch.abs(Vn_pre)),
            k_solid_angle_check=k_check,
        )
        operators = dict(
            # cfg.keep_operators=False drops the dense pair (5.4 GB at f64
            # on the 6,146-node sphere); the frozen path needs them and
            # checks for None
            V=V if cfg.keep_operators else None,
            K=K if cfg.keep_operators else None,
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
            operators["N_flagellum_torque_dual"] = torque_dual_flat
        return A, rhs, operators, diagnostics

    # ------------------------------------------------------------------
    def _check_solve_path(self):
        cfg = self.cfg
        if not cfg.monolithic:
            raise _not_ported(
                "the grand-resistance strategy (monolithic=False)",
                "ops/resistance.py and 2D",
            )
        if cfg.matrix_free:
            # matrix_free overrides solve_directly and print_matrices, as in
            # the JAX package (`bemstokes_tpu/problem.py:642`)
            return
        if cfg.print_matrices:
            raise _not_ported("print_matrices", "postprocess.py, cli.py and config_io.py")
        if (
            not cfg.solver.solve_directly
            and cfg.solver.preconditioner_type != "Direct"
        ):
            raise _not_ported(
                f"the {cfg.solver.preconditioner_type!r} preconditioner",
                "la/preconditioners.py",
            )

    def solve_frame(self, euler, shape_velocities_flat, rotation=None):
        """Assemble + solve one frame.  `euler` [n_map_nodes, d] and
        `shape_velocities_flat` [d*n] may be numpy arrays or tensors.
        Returns a dict of results: tensors on the problem's device, host
        scalars and numpy arrays for the packed diagnostics
        (`result_to_numpy` converts the rest).  `rotation` is the
        accumulated body rotation (flagellum torque mode only; identity when
        omitted)."""
        self._check_solve_path()
        if self.cfg.matrix_free:
            if self._matfree is None:
                from .matfree import MatfreeSolver

                self._matfree = MatfreeSolver(self)
            return self._matfree.solve_frame(euler, shape_velocities_flat, rotation)
        with timers.scope("Assemble"):
            A, rhs, ops, diag = self._pipeline(euler, shape_velocities_flat, rotation)
        return self._solve_monolithic_system(A, rhs, ops, diag)

    # ------------------------------------------------------------------
    def solve_frame_frozen(self, prev_result, shape_velocities_flat):
        """Frozen-geometry fast path: reuse the previous frame's operators
        and monolithic matrix, recompute only the surface rhs from the new
        gait velocity, and re-solve (the reference's squirmer branch that
        skips `assemble_stokes_system` when `squirmer_change_geometry` is
        false, `source/bem_stokes.cc:5734-5759`).  Only meaningful for
        grid_type == "Real" (the rhs is sdot-independent otherwise)."""
        self._check_solve_path()
        A = prev_result["A"]
        ops = prev_result["operators"]
        if ops.get("K") is None:
            raise ValueError(
                "solve_frame_frozen needs the previous frame's K operator; "
                "run with cfg.keep_operators=True"
            )
        diag = {k: self._as_device(v) for k, v in prev_result["diagnostics"].items()}
        nv = ops["normal"]
        rhs = self._frozen_rhs(
            ops["K"],
            flatten(nv["normal_pure"]),
            flatten(nv["M_normal_pure"]),
            nv["l2_gamma_pure"],
            self._as_device(shape_velocities_flat),
        )
        return self._solve_monolithic_system(A, rhs, ops, diag)

    def _frozen_rhs(self, K, n_pure_f, Mn_pure_f, l2g_pure, sdot_flat):
        dt = self.asm_cfg.dtype
        d, n = self.dim, self.n

        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        rhs_surface = P_t(K @ P_t(sdot_flat.to(dt)))
        tail_len = self.num_rigid + (1 if self.cfg.solve_with_torque else 0)
        rhs = torch.cat([rhs_surface, torch.zeros((tail_len,), dtype=dt, device=K.device)])
        if self.hanging.n:
            comp = np.arange(d)[:, None] * n
            rows = (self.hanging.slaves[None, :] + comp).reshape(-1)
            rhs[torch.as_tensor(rows, dtype=torch.long, device=K.device)] = 0.0
        return rhs

    # ------------------------------------------------------------------
    def _solve_monolithic_system(self, A, rhs, ops, diag):
        """Solve the assembled system: one dense LU solve (`solve_directly`)
        or GMRES preconditioned by a fresh or stale LU, with the true
        residual reported either way."""
        refactored = False
        with timers.scope("LAC Solve"):
            if self.cfg.solver.solve_directly:
                x = lu_solve_dense(lu_factor_dense(A), rhs)
                iters, res = 1, torch.linalg.vector_norm(A @ x - rhs)
            else:
                # Direct: fresh LU, or the stale LU of an earlier frame while
                # the previous solve stayed within the trigger (reference
                # refactor-on-trigger `source/bem_stokes.cc:4336-4339,
                # 5768-5779`)
                with timers.scope("DirectPreconditioner Refactorisation"):
                    refactored = self.preconditioner.maybe_refactor(
                        A, self._last_direct_iterations
                    )
                x, info = self._gmres_direct(A, rhs)
                iters, res = info["iterations"], info["residual"]
            forces, wall_vel, packed_dev = self._finish(
                A, rhs, ops, diag, x, iters, res
            )
            packed = packed_dev.cpu().numpy()
        return self._unpack_result(A, rhs, ops, forces, wall_vel, packed, refactored)

    def _unpack_result(self, A, rhs, ops, forces, wall_vel, packed, refactored):
        """Unpack the packed scalar vector (layout documented on
        _finish) into the result dict; host-side bookkeeping for the
        stale-LU refactor trigger and the convergence warning."""
        cfg = self.cfg
        d = self.dim
        R = self.num_rigid
        o = 0

        def take(k):
            nonlocal o
            out = packed[o : o + k]
            o += k
            return out

        residual = float(take(1)[0])
        b_norm = float(take(1)[0])
        rigid_vel = take(R)
        host_diag = dict(
            mass_body=take(1)[0],
            com_body=take(d),
            v_null_residual_pre=take(1)[0],
            k_solid_angle_check=take(d),
        )
        F_pole = take(R)
        F_complete = take(R)
        iters = int(take(1)[0])
        gmres_res = float(take(1)[0])

        converged = True
        if not cfg.solver.solve_directly:
            self._last_direct_iterations = iters
            converged = gmres_res <= cfg.solver.tolerance * (
                b_norm if b_norm > 0 else 1.0
            ) * 1.0001
            if not converged:
                import warnings

                warnings.warn(
                    f"GMRES did not converge in {iters} iterations "
                    f"(residual {gmres_res:.3e}, "
                    f"max_steps {cfg.solver.max_steps})",
                    stacklevel=2,
                )
        extra = {}
        if cfg.solve_with_torque:
            # the motor-balance unknown: flagellum rotation rate omega
            # (reference `:4398-4410`); the effective gait velocity is
            # omega * N_flagellum_torque
            flagellum_omega = float(take(1)[0])
            extra["flagellum_omega"] = flagellum_omega
            extra["shape_velocities"] = flagellum_omega * ops["N_flagellum_torque"]
        if "N_flagellum_torque_dual" in ops:
            # motor torque actually transmitted (reference `:4374`)
            extra["motor_torque"] = float(take(1)[0])
        return dict(
            stokes_forces=forces,
            wall_velocities=wall_vel,
            rigid_velocities=rigid_vel,
            rigid_forces_pole=F_pole,
            rigid_forces_complete=F_complete,
            iterations=iters,
            converged=converged,
            refactored=refactored,
            residual=residual,
            gmres_residual=gmres_res,
            diagnostics=host_diag,
            operators=ops,
            A=A,
            rhs=rhs,
            **extra,
        )

    # ------------------------------------------------------------------
    def shape_velocities_fd(self, euler_now, euler_next, time_step=None):
        """Finite-difference gait velocity projected onto the FE space
        (reference `project_shape_velocities`, `source/bem_stokes.cc:2120`).
        With equal FE and mapping spaces the projection is the identity."""
        dt_step = time_step or self.cfg.time_step
        euler_now = self._as_device(euler_now)
        euler_next = self._as_device(euler_next)
        vel_map = (euler_next - euler_now) / dt_step  # [n_map, d]
        if self.cfg.fe_degree == self.cfg.map_degree:
            return flatten(vel_map)
        # degree mismatch: evaluate the map-space velocity field at the FE
        # support points (nodal interpolation)
        return flatten(support_points(vel_map, self.map_space, self.fe_space))


def result_to_numpy(res):
    """A `solve_frame` result with every tensor (nested dicts included)
    turned into a numpy array, so results of the two packages compare like
    with like."""
    if isinstance(res, torch.Tensor):
        return res.detach().cpu().numpy()
    if isinstance(res, dict):
        return {k: result_to_numpy(v) for k, v in res.items()}
    return res
