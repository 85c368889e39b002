"""StokesBEMProblem: the orchestrator (port of `bemstokes_tpu/problem.py`;
the reference's `BEMProblem<dim>`, `include/bem_stokes.h:107-660`).

The per-frame pipeline (reference `run`, `source/bem_stokes.cc:5636-5884`):

  euler(frame)
    -> rigid modes + center of mass        (physics.rigid)
    -> L2 normal vector                    (physics.rigid.normal_vector_l2)
    -> assemble V, K + corrections         (ops.assemble / ops.corrections)
    -> monolithic system                   (ops.monolithic)
    -> LU factor (fresh or stale) + GMRES  (la.direct / la.gmres)

Ported: the Direct frame solve (fresh and stale LU), the `solve_directly`
branch and GMRES under the other preconditioners (`la/preconditioners.py`)
for the free-space kernel and, in 3D, the two image kernels of a plane wall
(`reflect_kernel`, `no_slip_kernel`), the flagellum torque mode
(`solve_with_torque`, `imposed_rotation_as_flagellum_shape`), the
frozen-geometry re-solve (`solve_frame_frozen`), the matrix-free solve
(`cfg.matrix_free`, `matfree.py`), the grand-resistance strategy
(`monolithic=False`, `ops/resistance.py`) and the `print_matrices` dumps;
and every one of these in 2D (a line-cell boundary in the plane, 3 rigid
modes), free space only, whose bulk is plain torch (`ops/bulk_2d.py`).
Torch runs eagerly on the problem's device (the CUDA card unless the caller
passes `device="cpu"`), in the dtype of `ProblemConfig.dtype`; the JAX
package's jitted single-dispatch fusions and its split-precision f64 GEMV
(`la/mixed.py`) have no counterpart here (every [dn, dn] product is
`A @ v`).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ProblemConfig
from .fem.geometry import euler_from_mesh, support_points
from .la.direct import LUPreconditioner, lu_factor_dense, lu_solve_dense
from .la.gmres import gmres, restart_params, solve_converged
from .la.preconditioners import build_preconditioner
from .mesh import SurfaceMesh, build_scalar_space, read_mesh
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
from .ops.monolithic import SaddleTail, operator_column_mask, split_monolithic_solution
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


#: `ProblemConfig.assembly_backend` -> (column_mode, node_layout) of the
#: port's AssemblyConfig.  The JAX package's backend names keep the port on
#: its node mode (K1, K2, K3), as before; "gather" (K6 in free space),
#: "scatter" (the plain oracle) and "node_planes" (K4) name the port's other
#: bulks.  The JAX package reads "gather" and "scatter" as its XLA gather
#: path, so a config that names them loads there too.
ASSEMBLY_BACKENDS = {
    "jax": ("node", "dense"),
    "auto": ("node", "dense"),
    "pallas": ("node", "dense"),
    "pallas_interpret": ("node", "dense"),
    "node": ("node", "dense"),
    "node_planes": ("node", "planes"),
    "gather": ("gather", "dense"),
    "scatter": ("scatter", "dense"),
}


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
        if mesh.dim == 2 and (self.cfg.reflect_kernel or self.cfg.no_slip_kernel):
            # the JAX package asserts dim == 3 in every image kernel
            # (`bemstokes_tpu/kernels/images.py:72`)
            raise ValueError(
                "the image kernels (reflect_kernel, no_slip_kernel) are 3D "
                "only, as in the reference; a 2D problem takes the free-space kernel"
            )
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
        # order (mesh/proximity.py).  The decision, with the tightest gap (the
        # smallest against its panel diameter) and that diameter, is the scope
        # "Quadrature promotion" and `self.quadrature_promotion`.
        quad = self.cfg.quadrature
        q_order, q_far = quad.order, quad.order_far
        self.quadrature_promoted = False
        self.quadrature_promotion = None
        if quad.auto_promote and q_far is None:
            from .mesh.proximity import min_intercomponent_gap, wall_image_gap

            with timers.scope("Quadrature promotion") as scope:
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
                gap, diam = min(cands, key=lambda c: c[0] / c[1]) if cands else (None, None)
                self.quadrature_promotion = dict(
                    promoted=self.quadrature_promoted,
                    gap=gap,
                    diameter=diam,
                    order_far=q_far if self.quadrature_promoted else q_order,
                    order_near=q_order,
                )
                scope.set(**self.quadrature_promotion)

        if self.cfg.assembly_backend not in ASSEMBLY_BACKENDS:
            raise ValueError(
                f"assembly_backend must be one of {sorted(ASSEMBLY_BACKENDS)}, "
                f"got {self.cfg.assembly_backend!r}"
            )
        column_mode, node_layout = ASSEMBLY_BACKENDS[self.cfg.assembly_backend]
        if self.cfg.matrix_free:
            # the matrix-free block factors (`assemble_rows`) stay on node mode
            column_mode, node_layout = "node", "dense"
        if node_layout == "planes" and kernel != KERNEL_FREE_SPACE:
            raise ValueError(
                'assembly_backend="node_planes" is free space only (like the '
                "JAX package's rows_sublane layout); the image kernels write "
                "the dense layout"
            )
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
            row_tile=self.cfg.row_tile,
            cell_chunk=self.cfg.cell_chunk,
            dtype=dt,
            column_mode=column_mode,
            node_layout=node_layout,
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
        # the monolithic system's hanging-node rows (None without any)
        self._constrained_t = (
            torch.as_tensor(self.hanging.flat_rows(self.n, self.dim), device=dev)
            if self.hanging.n
            else None
        )

    def _gmres_direct(self, A, rhs):
        restart, max_restarts = restart_params(self.cfg.solver)
        return gmres(
            lambda v: A @ v,
            rhs,
            precond=self.preconditioner.apply,
            restart=restart,
            tol=self.cfg.solver.tolerance,
            max_restarts=max_restarts,
        )

    def _gmres_generic(self, A, rhs):
        """GMRES preconditioned by `preconditioner_type` (not Direct), the
        preconditioner built afresh from this frame's matrix (the JAX
        `_gmres_generic_impl`)."""
        cfg = self.cfg
        restart, max_restarts = restart_params(cfg.solver)
        bw = cfg.solver.bandwith if cfg.solver.bandwith_preconditioner else None
        with timers.scope("Preconditioner Set Up"):
            precond = build_preconditioner(A, cfg.solver.preconditioner_type, bandwith=bw)
        return gmres(
            lambda v: A @ v,
            rhs,
            precond=precond.apply,
            restart=restart,
            tol=cfg.solver.tolerance,
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
        with timers.host_sync():
            iters = torch.as_tensor(float(solver_iters), dtype=x.dtype, device=x.device)
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
            iters[None],
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
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            return a.to(device=self.device, dtype=self.asm_cfg.dtype)
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a))
        with timers.host_sync():  # a copy from host memory
            return a.to(device=self.device, dtype=self.asm_cfg.dtype)

    # ------------------------------------------------------------------
    def flagellum_torque_mode(self, euler, rotation=None):
        """N_flagellum_torque [n, d]: rotation of the flagellum about the
        body-frame x-axis, expressed in world coordinates —
        N(x) = R . (e_x x (R^T x - pole)) on flagellum nodes, 0 elsewhere
        (reference `source/bem_stokes.cc:2657-2670` builds the body-frame
        mode, then `rotate_vector` applies R at `:2770`)."""
        dt, dev = self.asm_cfg.dtype, self.device
        if self.dim != 3:
            # no flagellum axis in the plane (the JAX package returns zeros)
            return torch.zeros((self.n, self.dim), dtype=dt, device=dev)
        R = (
            torch.eye(3, dtype=dt, device=dev)
            if rotation is None
            else self._as_device(rotation)
        )
        sp = support_points(self._as_device(euler), self.map_space, self.fe_space).to(dt)
        pole = self.force_pole_point(torch.zeros((3,), dtype=dt, device=dev))
        body = sp @ R - pole[None, :]  # R^T x (row-vector convention)
        ex = torch.zeros((3,), dtype=dt, device=dev)
        with timers.host_sync():  # a scalar copied in from the host
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
        tail = SaddleTail.from_config(
            cfg, tmp_N, flatten(N_dual), tmp_torque, torque_dual_flat, self._constrained_t
        )
        A, rhs = tail.system(V, K, sel_V, rhs_surface)
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
            tail=tail,
        )
        if torque_mode_flat is not None:
            operators["N_flagellum_torque"] = torque_mode_flat
            operators["N_flagellum_torque_dual"] = torque_dual_flat
        return A, rhs, operators, diagnostics

    # ------------------------------------------------------------------
    def solve_frame(self, euler, shape_velocities_flat, rotation=None):
        """Assemble + solve one frame.  `euler` [n_map_nodes, d] and
        `shape_velocities_flat` [d*n] may be numpy arrays or tensors.
        Returns a dict of results: tensors on the problem's device, host
        scalars and numpy arrays for the packed diagnostics
        (`result_to_numpy` converts the rest).  `rotation` is the
        accumulated body rotation (flagellum torque mode only; identity when
        omitted).

        `monolithic=False` takes the grand-resistance strategy before
        `matrix_free` is looked at, and `matrix_free` overrides
        `solve_directly` and `print_matrices`, as in the JAX package
        (`bemstokes_tpu/problem.py:640-642`)."""
        if not self.cfg.monolithic:
            return self._solve_frame_resistance(euler, shape_velocities_flat)
        if self.cfg.matrix_free:
            if self._matfree is None:
                from .matfree import MatfreeSolver

                self._matfree = MatfreeSolver(self)
            return self._matfree.solve_frame(euler, shape_velocities_flat, rotation)
        with timers.scope("Assemble"):
            A, rhs, ops, diag = self._pipeline(euler, shape_velocities_flat, rotation)
        if self.cfg.print_matrices:
            self._dump_matrices(A, ops)
        return self._solve_monolithic_system(A, rhs, ops, diag)

    def _dump_matrices(self, A, ops, out_dir="."):
        """Txt dumps of the assembled operators (reference `print_matrices`,
        `source/bem_stokes.cc:3362-3430`: monolithic_matrix.txt,
        V_matrix.txt, K_matrix.txt, Mass_matrix.txt, normals_matrix.txt
        written into the working directory)."""
        import os

        from .physics.rigid import MassOperator

        if ops.get("V") is None:
            raise ValueError(
                "print_matrices needs the assembled V/K operators; run "
                "with cfg.keep_operators=True"
            )

        def save(name, M):
            np.savetxt(os.path.join(out_dir, name), M.detach().cpu().numpy())

        save("monolithic_matrix.txt", A)
        save("V_matrix.txt", ops["V"])
        save("K_matrix.txt", ops["K"])
        save("normals_matrix.txt", ops["normal"]["normal"])
        # dense consistent mass (operator-form internally; materialized only
        # under this debug flag): the operator applied to identity columns
        mop = MassOperator(self.n, self.tables.cells_nodes_fe, self.tables.phi_fe, ops["mass_jxw"])
        save("Mass_matrix.txt", mop.matvec(torch.eye(self.n, dtype=self.asm_cfg.dtype, device=self.device)))

    # ------------------------------------------------------------------
    def solve_frame_frozen(self, prev_result, shape_velocities_flat):
        """Frozen-geometry fast path: reuse the previous frame's operators
        and monolithic matrix, recompute only the surface rhs from the new
        gait velocity, and re-solve (the reference's squirmer branch that
        skips `assemble_stokes_system` when `squirmer_change_geometry` is
        false, `source/bem_stokes.cc:5734-5759`).  Only meaningful for
        grid_type == "Real" (the rhs is sdot-independent otherwise)."""
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
            ops["tail"],
        )
        return self._solve_monolithic_system(A, rhs, ops, diag)

    def _frozen_rhs(self, K, n_pure_f, Mn_pure_f, l2g_pure, sdot_flat, tail):
        def P_t(v):
            return tangential_projector(v, n_pure_f, Mn_pure_f, l2g_pure)

        return tail.frozen_rhs(P_t(K @ P_t(sdot_flat.to(self.asm_cfg.dtype))))

    # ------------------------------------------------------------------
    def _solve_monolithic_system(self, A, rhs, ops, diag):
        """Solve the assembled system: one dense LU solve (`solve_directly`),
        GMRES preconditioned by a fresh or stale LU (Direct), or GMRES
        under another preconditioner built from this frame's matrix, with
        the true residual reported either way."""
        refactored = False
        with timers.scope("LAC Solve"):
            if self.cfg.solver.solve_directly:
                x = lu_solve_dense(lu_factor_dense(A), rhs)
                iters, res = 1, torch.linalg.vector_norm(A @ x - rhs)
            elif self.cfg.solver.preconditioner_type != "Direct":
                x, info = self._gmres_generic(A, rhs)
                iters, res = info["iterations"], info["residual"]
            else:
                # Direct: fresh LU, or the stale LU of an earlier frame while
                # the previous solve stayed within the trigger (reference
                # refactor-on-trigger `source/bem_stokes.cc:4336-4339,
                # 5768-5779`)
                with timers.scope("DirectPreconditioner Refactorisation") as span:
                    refactored = self.preconditioner.maybe_refactor(
                        A, self._last_direct_iterations
                    )
                    span.set(refactored=refactored)
                x, info = self._gmres_direct(A, rhs)
                iters, res = info["iterations"], info["residual"]
            forces, wall_vel, packed_dev = self._finish(
                A, rhs, ops, diag, x, iters, res
            )
            with timers.host_sync():
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
            converged = solve_converged(gmres_res, b_norm, cfg.solver.tolerance)
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
    def _solve_frame_resistance(self, euler, shape_velocities_flat):
        """Non-monolithic grand-resistance-matrix strategy (reference
        `solve_system(monolithic=false)`, `source/bem_stokes.cc:4163-4261`):
        an LU of V and the Dirichlet-to-Neumann map of the shape velocity
        and the rigid modes (`ops/resistance.py`)."""
        from .ops.resistance import solve_resistance_system

        cfg = self.cfg
        if not cfg.keep_operators:
            raise ValueError(
                "the resistance strategy applies V/K directly; run with "
                "cfg.keep_operators=True"
            )
        with timers.scope("Assemble"):
            A, rhs, ops, diag = self._pipeline(euler, shape_velocities_flat)
        nv = ops["normal"]
        with timers.scope("LAC Solve"):
            U, forces, res_matrix = solve_resistance_system(
                ops["V"],
                ops["K"],
                self._as_device(shape_velocities_flat),
                flatten(ops["N"]),
                flatten(ops["N_dual"]),
                flatten(nv["normal_pure"]),
                flatten(nv["M_normal_pure"]),
                nv["l2_gamma_pure"],
                grid_type=cfg.grid_type,
                imposed_component=cfg.imposed_component,
            )
        return dict(
            stokes_forces=forces,
            wall_velocities=torch.zeros_like(forces),
            rigid_velocities=U.cpu().numpy(),
            resistance_matrix=res_matrix.cpu().numpy(),
            iterations=1,
            residual=0.0,
            diagnostics={k: v.cpu().numpy() for k, v in diag.items()},
            operators=ops,
            A=A,
            rhs=rhs,
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


def frame_mesh_path(cfg: ProblemConfig, frame: int) -> str:
    """The file of a gait's frame: `<input_grid_path><input_grid_base_name>
    <frame>.<input_grid_format>`."""
    return (
        f"{cfg.input_grid_path}{cfg.input_grid_base_name}{frame}."
        f"{cfg.input_grid_format}"
    )


def load_frame_mesh(cfg: ProblemConfig, frame: int) -> SurfaceMesh:
    return read_mesh(frame_mesh_path(cfg, frame), dim=cfg.dim)


def result_to_numpy(res):
    """A `solve_frame` result with every tensor (nested dicts included)
    turned into a numpy array, so results of the two packages compare like
    with like.  Each tensor's copy is a host sync."""
    if isinstance(res, torch.Tensor):
        with timers.host_sync():
            return res.detach().cpu().numpy()
    if isinstance(res, dict):
        return {k: result_to_numpy(v) for k, v in res.items()}
    return res
