"""Frame-loop orchestration (port of `bemstokes_tpu/swimmer.py`): the
reference's `run()` simulation loop (`source/bem_stokes.cc:5636-5884`),
restart machinery (`:5658-5674`), per-frame output
(`output_save_stokes_results` `:5135-5329`) and the offline `composer`
(`:5951-6046`).

The per-frame geometry pipeline is

    euler(frame) = R_body . frame_node_positions + rigid_displacements

(reference `compute_euler_vector`, `:2247-2440`).  The simulation advances
the swimmer's rigid state (rotation matrix via quaternions, displacement
integral) frame by frame with Forward-Euler or Heun predictor-corrector time
integration.  The state math runs on the host in numpy, as in the JAX
package; the frame solves run on the problem's device (the CUDA card unless
the caller passes `device="cpu"`).

Geometry sources: the analytic flagellum handler, the sphere(s) built in
code and gaits read from frame mesh files (`mesh/io.py`), in 3D or in 2D
(line-cell frames; a 2x2 body rotation advanced by the rate U[2]).
`cfg.distributed` solves each frame with the distributed frame step
(`parallel/solve.py`) over every rank of the process group, one process per
device (`torchrun`; a single process forms a group of one), and only rank 0
writes the output files: the JAX package runs one process per host and
writes from each.  `SwimmerState` files have the JAX package's fields, so a
state saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .config import ProblemConfig
from .fem.geometry import euler_from_mesh, support_points
from .la.gmres import solve_converged
from .mesh.factories import add_walls_to_mesh
from .mesh.io import read_mesh
from .mesh.io_vtu import write_vtu
from .physics.kinematics import (
    rotation_matrix_from_quaternion,
    update_rotation_matrix_np,
)
from .parallel.multihost import is_coordinator
from .physics.rigid import flatten
from .problem import (
    StokesBEMProblem,
    _resolve_manifold,
    frame_mesh_path,
    resolve_device,
    result_to_numpy,
)
from .utils import timers


@dataclasses.dataclass
class SwimmerState:
    """Restartable rigid state (reference rotation_matrix +
    rigid_displacements_for_sim + frame counter)."""

    rotation: np.ndarray  # [d, d]
    displacements: np.ndarray  # [n_map, d] accumulated rigid displacement
    frame: int

    def save(self, path: str):
        np.savez(
            path,
            rotation=self.rotation,
            displacements=self.displacements,
            frame=self.frame,
        )

    @classmethod
    def load(cls, path: str) -> "SwimmerState":
        z = np.load(path)
        return cls(z["rotation"], z["displacements"], int(z["frame"]))


def _spherical_head_remap(euler: np.ndarray, body_mask: np.ndarray) -> np.ndarray:
    """Remap body nodes with x <= 0 onto the ellipsoidal head with semi-axes
    (1.6, 0.8, 0.8) centered at (-1.6, 0, 0) — the reference `spherical_head`
    branch of `compute_euler_vector` (`source/bem_stokes.cc:2390-2410`)."""
    center = np.array([-1.6, 0.0, 0.0])
    rel = euler - center
    nrm = np.linalg.norm(rel, axis=1, keepdims=True)
    pp = rel / np.where(nrm == 0, 1.0, nrm)
    mapped = pp * np.array([1.6, 0.8, 0.8]) + center
    apply = body_mask & (euler[:, 0] <= 0.0)
    return np.where(apply[:, None], mapped, euler)


class SwimmerSimulation:
    # per-pass anisotropy-cut plan: decided on the first mesh read, replayed
    # on every later frame so the gait keeps one topology
    _aniso_plan = None

    def __init__(
        self,
        cfg: ProblemConfig,
        output_dir: str = ".",
        device: str | torch.device | None = None,
    ):
        self.cfg = cfg
        self.out = output_dir
        self.device = resolve_device(device)
        os.makedirs(output_dir, exist_ok=True)
        self._static_base_mesh = None
        self.flagellum_cfg = None
        if cfg.use_flagellum_handler:
            # analytic helical-flagellum geometry built in code (reference
            # `read_domain` flagellum branch, `source/bem_stokes.cc:756`,
            # reference euler at `:5656-5657`)
            from .flagella import FlagellumConfig, create_initial_flagellum_mesh

            params = dict(cfg.flagellum_params)
            n_length = params.pop("n_length", 24)
            n_around = params.pop("n_around", 8)
            self.flagellum_cfg = FlagellumConfig(**params)
            base_mesh = create_initial_flagellum_mesh(
                self.flagellum_cfg, n_length=n_length, n_around=n_around
            )
        elif cfg.build_sphere_in_code and cfg.grid_type in (
            "ImposedForce",
            "ImposedVelocity",
            "Convergence",
        ):
            # sphere (or two spheres) built in code instead of frame files
            # (reference `build_sphere_in_deal`, `source/bem_stokes.cc:670-711`)
            from .mesh.factories import create_body_in_code

            base_mesh = create_body_in_code(cfg)
            self._static_base_mesh = base_mesh
        else:
            base_mesh = self._read_frame_mesh(0)
        self.mesh = add_walls_to_mesh(base_mesh, cfg)
        self.problem = StokesBEMProblem(self.mesh, cfg, device=self.device)
        map_sp = self.problem.map_space
        body_nodes = np.unique(map_sp.cells_nodes[self.mesh.material_id == 0])
        if cfg.use_flagellum_handler:
            from .flagella import reference_constant_spiral_euler

            euler0 = euler_from_mesh(self.mesh.vertices, map_sp)
            flag_mask = np.zeros(map_sp.n_nodes)
            flag_mask[body_nodes] = (euler0[body_nodes, 0] > -0.1).astype(float)
            # the gait geometry is evaluated on the host (float64, CPU): it
            # feeds the numpy state math of `euler_for_frame`
            self.map_flagellum_mask = torch.as_tensor(flag_mask)
            self.reference_euler = reference_constant_spiral_euler(
                torch.as_tensor(euler0), self.flagellum_cfg, self.map_flagellum_mask
            )
        if self.problem.dim == 3:
            q = np.asarray(cfg.initial_quaternion, dtype=np.float64)
            rot0 = rotation_matrix_from_quaternion(torch.as_tensor(q / np.linalg.norm(q))).numpy()
        else:
            # 2D: a 2x2 rotation advanced by the scalar rate U[2] (the
            # reference's quaternion machinery is 3D only)
            rot0 = np.eye(2)
        self.state = SwimmerState(
            rotation=rot0,
            displacements=np.zeros((map_sp.n_nodes, self.problem.dim)),
            frame=0,
        )
        # body-node mask in MAP space (walls are never rotated/displaced);
        # distinct from the FE-space mask when fe_degree != map_degree
        mask = np.zeros(map_sp.n_nodes)
        mask[body_nodes] = 1.0
        self.map_body_mask = mask[:, None]
        self.history: list[dict] = []
        self._dist_step = None
        if cfg.distributed:
            self._ensure_dist_step()

    # ------------------------------------------------------------------
    def _read_frame_mesh(self, frame: int):
        cfg = self.cfg
        mesh = read_mesh(frame_mesh_path(cfg, frame), dim=cfg.dim, force_material=0)
        if cfg.remove_tria_anisotropies:
            # reference GridTools::remove_anisotropy on the reference tria
            # (`source/bem_stokes.cc:662-664`) and each frame tria
            # (`:2305-2307`); the frame-0 cut decisions are replayed on later
            # frames so every frame shares the base mesh's topology
            from .mesh.refine import remove_anisotropy

            mesh, plan = remove_anisotropy(
                mesh,
                manifold=_resolve_manifold(cfg),
                plan=self._aniso_plan,
            )
            if self._aniso_plan is None:
                self._aniso_plan = plan
        return mesh

    def euler_for_frame(self, frame: int) -> np.ndarray:
        """Frame geometry under the current rigid state (reference
        `compute_euler_vector` `:2247-2440`: gait geometry from the flagellum
        handler, the mesh built in code or a frame mesh file, optional
        spherical-head remap,
        then rotate body nodes by the accumulated rotation and add
        accumulated displacements).  A host array."""
        if self.cfg.use_flagellum_handler:
            from .flagella import euler_at_theta

            # NOTE: the reference passes theta = frame/n_frames (radians) to
            # compute_euler_at_theta (`source/bem_stokes.cc:2251-2254`), i.e.
            # one radian per gait cycle; we use the physically intended
            # 2*pi*frame/n_frames — one full flagellum revolution per cycle,
            # consistent with the imposed-rotation rate
            # omega = -2*pi/(time_step*n_frames) at `:2084`
            theta = 2.0 * np.pi * (frame % self.cfg.n_frames) / self.cfg.n_frames
            euler = euler_at_theta(
                self.reference_euler, theta, self.map_flagellum_mask
            ).numpy()
        elif self._static_base_mesh is not None:
            # in-code body: the gait geometry is the built mesh every frame
            euler = euler_from_mesh(
                self.mesh.vertices, self.problem.map_space, self.problem.manifold
            )
        else:
            frame_mesh = add_walls_to_mesh(
                self._read_frame_mesh(frame % self.cfg.n_frames), self.cfg
            )
            euler = euler_from_mesh(
                frame_mesh.vertices, self.problem.map_space, self.problem.manifold
            )
        if self.cfg.spherical_head:
            euler = _spherical_head_remap(euler, self.map_body_mask[:, 0] > 0)
        Rm = self.state.rotation
        rotated = euler @ Rm.T
        euler = np.where(self.map_body_mask > 0, rotated, euler)
        if self.cfg.consider_rigid_displacements:
            euler = euler + self.state.displacements * (self.map_body_mask > 0)
        return euler

    # ------------------------------------------------------------------
    def shape_velocities(self, frame: int, euler_now) -> torch.Tensor:
        """The component-blocked gait velocity [d*n] of this frame, on the
        problem's device."""
        cfg = self.cfg
        prob = self.problem
        if cfg.imposed_rotation_as_flagellum_shape:
            # exact gait rate instead of the FD of two frames (reference
            # `compute_rotational_shape_velocities`, `:2080-2097`):
            # sdot = omega * N_flagellum_torque, omega = -2 pi / (dt n_frames)
            omega = -2.0 * np.pi / (cfg.time_step * cfg.n_frames)
            mode = prob.flagellum_torque_mode(euler_now, self.state.rotation)
            return flatten(omega * mode)
        if cfg.imposed_translation_as_flagellum_shape:
            # unit x-velocity of the flagellum nodes (reference `:5705-5713`)
            return flatten(prob.flagellum_translation_mode())
        if cfg.solve_with_torque:
            # the gait rate is an unknown of the motor-torque solve; the
            # surface rhs is zeroed in the monolithic build
            return torch.zeros(
                (prob.dim * prob.n,), dtype=prob.asm_cfg.dtype, device=prob.device
            )
        if cfg.velocity_type == "Squirmer":
            return prob._as_device(self._read_squirming_velocities(frame))
        euler_next = self.euler_for_frame(frame + cfg.delta_frame)
        return prob.shape_velocities_fd(euler_now, euler_next)

    def _read_squirming_velocities(self, frame: int) -> np.ndarray:
        """Squirmer gait velocities from disk: the reference reads
        `<input_velocity_path><basename><dim>d_frame_<frame>.bin` in deal.II
        block_write binary (`source/bem_stokes.cc:2124-2133`); `.npy`
        variants of the same stem are accepted for numpy workflows.  The
        payload is the component-blocked flat [d*n] vector."""
        cfg = self.cfg
        d = self.problem.dim
        base = os.path.join(cfg.input_velocity_path, cfg.squirming_velocity_basename)
        candidates = [
            (f"{base}{d}d_frame_{frame}.bin", "bin"),
            (f"{base}{frame}.bin", "bin"),
            (f"{base}{d}d_frame_{frame}.npy", "npy"),
            (f"{base}{frame}.npy", "npy"),
        ]
        for path, kind in candidates:
            if os.path.exists(path):
                if kind == "bin":
                    from .utils.dealii_io import block_read

                    return block_read(path)
                return np.load(path).reshape(-1)
        raise FileNotFoundError(
            f"no squirming velocity file for frame {frame} under "
            f"{base}* (tried {[p for p, _ in candidates]})"
        )

    def _solve(self, euler, sdot):
        """One frame solve: `StokesBEMProblem.solve_frame` on the problem's
        device, or the distributed frame step (cfg.distributed) with its
        fields repackaged into the same result schema."""
        if not self.cfg.distributed:
            return self.problem.solve_frame(euler, sdot, self.state.rotation)
        rigid_vel, _, info, fields = self._dist_step(euler, sdot, self.state.rotation)
        return self._package_dist_result(rigid_vel, info, fields)

    def _ensure_dist_step(self):
        from .parallel import row_mesh
        from .parallel.solve import make_sharded_frame_step

        cfg = self.cfg
        if self._dist_step is None:
            # frozen-geometry squirmer runs keep the operators and LU factors
            # on the device so that later frames only rebuild the rhs
            frozen_capable = (
                cfg.velocity_type == "Squirmer"
                and not cfg.squirmer_change_geometry
                and cfg.monolithic
                and cfg.grid_type == "Real"
                and not cfg.solve_with_torque
                and cfg.solver.preconditioner_type == "Direct"
            )
            self._dist_step = make_sharded_frame_step(
                self.problem,
                row_mesh(cfg.distributed_devices, device=self.device),
                return_fields=True,
                keep_frozen_pieces=frozen_capable,
            )

    def _solve_frozen_distributed(self, sdot):
        """Distributed frozen-geometry fast path: reuse the device-resident
        operators and factors of the previous full step, rebuild only the
        rhs (reference squirmer branch `source/bem_stokes.cc:5734-5759`)."""
        rigid_vel, _, info, fields = self._dist_step.frozen(sdot)
        return self._package_dist_result(rigid_vel, info, fields)

    def _package_dist_result(self, rigid_vel, info, fields):
        cfg = self.cfg
        # the per-frame scalars to the host; the large fields (forces,
        # modes, normals) stay on the device until the output writers read
        # them
        scalar_keys = [
            "F",
            "F_complete",
            "mass_body",
            "com_body",
            "rhs_norm",
            "v_null_residual_pre",
            "k_solid_angle_check",
        ]
        scalar_keys += [k for k in ("flagellum_omega", "motor_torque") if k in fields]
        f = {k: result_to_numpy(fields[k]) for k in scalar_keys}
        iters = int(info["iterations"])
        residual = float(info["residual"])
        b_norm = float(f["rhs_norm"])
        converged = solve_converged(residual, b_norm, cfg.solver.tolerance)
        if not converged:
            import warnings

            warnings.warn(
                f"distributed GMRES did not converge in {iters} iterations "
                f"(residual {residual:.3e}, max_steps {cfg.solver.max_steps})",
                stacklevel=2,
            )
        stale = getattr(self._dist_step, "stale_state", {})
        ops = dict(N=fields["N"], normal=dict(normal=fields["normal"]))
        extra = {}
        if "torque_mode_flat" in fields:
            # the single-card result schema (motor_torque.txt, the
            # rigid_flagellum VTU field, torque-driven gait velocities)
            ops["N_flagellum_torque"] = fields["torque_mode_flat"]
            extra["motor_torque"] = float(f["motor_torque"])
        if "flagellum_omega" in f:
            extra["flagellum_omega"] = float(f["flagellum_omega"])
            extra["shape_velocities"] = fields["shape_velocities_flat"]
        if "resistance_matrix" in fields:
            extra["resistance_matrix"] = result_to_numpy(fields["resistance_matrix"])
        return dict(
            stokes_forces=fields["forces"],
            wall_velocities=fields["wall_velocities"],
            rigid_velocities=result_to_numpy(rigid_vel),
            rigid_forces_pole=f["F"],
            rigid_forces_complete=f["F_complete"],
            iterations=iters,
            converged=converged,
            refactored=stale.get("refactored", False),
            residual=residual,
            diagnostics=dict(
                mass_body=f["mass_body"],
                com_body=f["com_body"],
                v_null_residual_pre=f["v_null_residual_pre"],
                k_solid_angle_check=f["k_solid_angle_check"],
            ),
            operators=ops,
            **extra,
        )

    def _advance_state(self, rigid_velocities: np.ndarray, N):
        """Advance the rigid state.  All host numpy: the per-frame state
        math is a 3x3 (2x2) rotation + two [n, d] einsums."""
        cfg = self.cfg
        d = self.problem.dim
        U = np.asarray(rigid_velocities)
        N = np.asarray(N)  # [R, n, d]
        v_full = np.einsum("r,rnd->nd", U, N)
        # the translation of the body's MAP nodes, which the displacements
        # move (N lives on the FE nodes; the JAX package adds it as it is and
        # fails whenever fe_degree != map_degree)
        v_tr = U[None, :d] * self.map_body_mask
        if cfg.consider_rigid_rotations:
            # 3D: quaternion forward-Euler on omega = U[3:6]; 2D: the scalar
            # rate U[2] advances the 2x2 rotation exactly
            omega = U[d : 2 * d] if d == 3 else U[d]
            self.state.rotation = update_rotation_matrix_np(self.state.rotation, omega, cfg.time_step)
        if cfg.consider_rigid_displacements:
            mask = np.array([1.0 if e else 0.0 for e in cfg.rigid_displacement_axes])
            self.state.displacements = (
                self.state.displacements + cfg.time_step * v_tr * mask[None, :]
            )
        return v_full

    # ------------------------------------------------------------------
    def run(self, start_frame: int = 0, end_frame: int | None = None):
        """The main simulation loop (reference `run` `:5681-5875`)."""
        cfg = self.cfg
        if end_frame is None:
            end_frame = cfg.n_frames
        if cfg.use_previous_state and start_frame > 0:
            self.state = SwimmerState.load(
                os.path.join(self.out, f"state_{start_frame - 1}.npz")
            )
        self.state.frame = start_frame

        with timers.scope("Run"):
            prev_res = None
            for frame in range(start_frame, end_frame, cfg.delta_frame):
                with timers.scope("Frame", frame=frame):
                    prev_res = self._frame(frame, prev_res)
        # end-of-run timer summary (reference TimeMonitor::summarize `:5882`)
        print(timers.summary())
        return self.history

    def _frame(self, frame, prev_res):
        """One frame of the loop: geometry, solve, state update, files.
        Returns the frame's solve result."""
        cfg = self.cfg
        with timers.scope("BEM Reinitialisation"):
            euler = self.euler_for_frame(frame)
            sdot = self.shape_velocities(frame, euler)
        # squirmer frozen-geometry fast path: reuse the operators, only
        # rebuild the rhs (reference `source/bem_stokes.cc:5734-5759`); on the
        # distributed path the operators and LU factors stay in the step's
        # state
        frozen = (
            cfg.velocity_type == "Squirmer"
            and not cfg.squirmer_change_geometry
            and cfg.monolithic
            and prev_res is not None
        )
        if frozen and cfg.distributed:
            frozen = getattr(self._dist_step, "frozen", None) is not None
        with timers.scope("Assemble + LAC Solve"):
            if frozen and cfg.distributed:
                res = self._solve_frozen_distributed(sdot)
            elif frozen:
                res = self.problem.solve_frame_frozen(prev_res, sdot)
            else:
                res = self._solve(euler, sdot)
        # the per-frame output fields, pulled to the host once
        ops_r = res["operators"]
        N_host = result_to_numpy(ops_r["N"])
        U = res["rigid_velocities"]
        if cfg.solve_with_torque:
            # the solved motor balance defines the gait velocity
            # (reference `:4407-4410`)
            sdot = res["shape_velocities"]

        if cfg.time_integration == "Heun":
            # predictor: advance a copy of the state, re-solve at the midpoint
            # geometry, average velocities (reference `:5787-5835` +
            # update_system_state Heun branch)
            saved = SwimmerState(
                self.state.rotation.copy(),
                self.state.displacements.copy(),
                frame,
            )
            self._advance_state(U, N_host)
            euler_pred = self.euler_for_frame(frame + cfg.delta_frame)
            sdot_pred = self.shape_velocities(frame + cfg.delta_frame, euler_pred)
            res_pred = self._solve(euler_pred, sdot_pred)
            self.state = saved
            U = 0.5 * (U + res_pred["rigid_velocities"])

        v_full = self._advance_state(U, N_host)
        d = self.problem.dim
        sdot_host = result_to_numpy(sdot)
        total_vel = sdot_host.reshape(d, -1).T + v_full
        self._print_frame_checks(frame, res)
        if is_coordinator():
            # rank 0 alone writes (the reference's `this_mpi_process == 0`
            # guards); the port runs one process per device
            self._save_frame(frame, euler, res, total_vel, U, sdot_host, N_host)
        entry = dict(
            frame=frame,
            rigid_velocities=U.tolist(),
            iterations=res["iterations"],
            refactored=bool(res.get("refactored", False)),
        )
        if "flagellum_omega" in res:
            entry["flagellum_omega"] = res["flagellum_omega"]
            entry["motor_torque"] = res["motor_torque"]
        self.history.append(entry)
        return res

    # ------------------------------------------------------------------
    def _print_frame_checks(self, frame, res):
        """Per-frame invariant diagnostics, printed like the reference does
        every frame (`source/bem_stokes.cc:3012-3014, 3093-3097, 5852-5870`,
        `:4343-4346`)."""
        diag = res["diagnostics"]
        print(
            f"frame {frame}: ||V.n||_inf pre-correction = "
            f"{float(diag['v_null_residual_pre']):.3e}, "
            f"||K.e||_inf = {float(np.max(np.asarray(diag['k_solid_angle_check']))):.6f}, "
            f"FINAL CHECK residual = {res['residual']:.3e}, "
            f"iterations = {res['iterations']}"
        )
        if not res.get("converged", True):
            print(f"frame {frame}: WARNING solver did not converge")
        if self.cfg.extra_debug_info:
            # the reference's dpcout channel (rank-0 + extra_debug_info,
            # `include/bem_stokes.h:659`): per-frame state detail
            U = np.asarray(res["rigid_velocities"])
            print(
                f"frame {frame} [debug]: rigid velocities {U}, "
                f"body mass {float(diag['mass_body']):.12e}, "
                f"com {np.asarray(diag['com_body'])}, "
                f"refactored={res.get('refactored', False)}"
            )

    def _origin_velocities(self, U, res):
        """Transform rigid velocities from the force pole to the origin
        (reference `source/bem_stokes.cc:4479-4493`)."""
        U_origin = np.asarray(U, dtype=np.float64).copy()
        if self.cfg.force_pole == "Origin":
            return U_origin
        if self.cfg.force_pole == "Baricenter":
            pole = np.asarray(res["diagnostics"]["com_body"])
        else:  # "Point"
            pole = np.asarray(self.cfg.force_arbitrary_point, dtype=np.float64)[
                : self.problem.dim
            ]
        if self.problem.dim == 3:
            om = U_origin[3:6]
            U_origin[0] += om[1] * (0.0 - pole[2]) - om[2] * (0.0 - pole[1])
            U_origin[1] += om[2] * (0.0 - pole[0]) - om[0] * (0.0 - pole[2])
            U_origin[2] += om[0] * (0.0 - pole[1]) - om[1] * (0.0 - pole[0])
        else:
            U_origin[0] += -U_origin[2] * (0.0 - pole[1])
            U_origin[1] += U_origin[2] * (0.0 - pole[0])
        return U_origin

    def _save_frame(self, frame, euler, res, total_vel, U, sdot, N_modes):
        """Write the frame's result and state files, the txt time series and
        the VTU.  `sdot` [d*n] and `N_modes` [R, n, d] are host arrays.  The
        call is the scope "Frame output", each of the four its child; the
        counter "output bytes" adds what each wrote."""
        with timers.scope("Frame output"):
            with timers.scope("Result file"):
                forces = self._write_result(frame, euler, res, total_vel, U)
            with timers.scope("State file"):
                self.state.frame = frame
                path = os.path.join(self.out, f"state_{frame}.npz")
                self.state.save(path)
                timers.count("output bytes", os.path.getsize(path))
            with timers.scope("Time series"):
                self._append_series(frame, res, U, forces)
            if frame % max(1, self.cfg.delta_frame) == 0:
                with timers.scope("VTU"):
                    self._write_frame_vtu(frame, euler, res, total_vel, sdot, N_modes, forces)

    def _write_result(self, frame, euler, res, total_vel, U):
        """result_<frame>.npz; returns the forces [n, d] on the host."""
        d = self.problem.dim
        forces_flat = result_to_numpy(res["stokes_forces"])  # one device pull
        forces = forces_flat.reshape(d, -1).T
        path = os.path.join(self.out, f"result_{frame}.npz")
        np.savez(
            path,
            stokes_forces=forces,
            rigid_velocities=np.asarray(U),
            total_velocities=total_vel,
            euler=np.asarray(euler),
        )
        timers.count("output bytes", os.path.getsize(path))
        return forces

    def _append(self, name, text):
        """Append `text` (ASCII: a byte a character) to the series `name`."""
        with open(os.path.join(self.out, name), "a") as f:
            f.write(text)
        timers.count("output bytes", len(text))

    def _append_series(self, frame, res, U, forces):
        """The txt time series, matching the reference's appenders:
        point_velocities.txt rows "F_r U_r F_complete_r" (`:4466-4476`),
        origin_velocities.txt rows "F_r U_origin_r" (`:4496-4506`),
        center_of_mass_position.txt "frame com" (`:2777-2784`),
        motor_torque.txt (`:4375-4384`)."""
        if "rigid_forces_pole" in res:
            F = np.asarray(res["rigid_forces_pole"])
            F_c = np.asarray(res["rigid_forces_complete"])
        else:  # resistance-strategy results: the force sums on the host
            ops_ = res["operators"]
            N_dual = result_to_numpy(ops_["N_dual"])  # [R, n, d]
            N_dual_c = result_to_numpy(ops_["N_dual_complete"])
            F = np.einsum("rnd,nd->r", N_dual, forces)
            F_c = np.einsum("rnd,nd->r", N_dual_c, forces)
        U_origin = self._origin_velocities(U, res)
        R = range(self.problem.num_rigid)
        self._append("point_velocities.txt", "".join(f"{F[r]:.16e} {U[r]:.16e} {F_c[r]:.16e}\n" for r in R))
        self._append("origin_velocities.txt", "".join(f"{F[r]:.16e} {U_origin[r]:.16e}\n" for r in R))
        com = np.asarray(res["diagnostics"]["com_body"])
        self._append("center_of_mass_position.txt", f"{frame} " + " ".join(f"{c:.16e}" for c in com) + "\n")
        if "motor_torque" in res:
            self._append("motor_torque.txt", f"{res['motor_torque']:.16e}\n")

    def _write_frame_vtu(self, frame, euler, res, total_vel, sdot, N_modes, forces):
        """stokes_<frame>.vtu: degree-correct sub-celled output with the
        reference's field set: forces, shape/total velocities, normals, rigid
        modes (`source/bem_stokes.cc:5164-5262`)."""
        from .mesh.dofs import subcell_connectivity

        d = self.problem.dim
        if self.cfg.fe_degree == self.cfg.map_degree:
            # equal spaces: the FE support points ARE the euler nodes
            sp = np.asarray(euler)
        else:
            sp = support_points(
                torch.as_tensor(np.asarray(euler)),
                self.problem.map_space,
                self.problem.fe_space,
            ).numpy()
        cells, parent = subcell_connectivity(self.problem.fe_space)
        ops = res["operators"]
        point_data = dict(
            forces=forces,
            total_velocities=total_vel,
            shape_velocities=sdot.reshape(d, -1).T,
            normals=result_to_numpy(ops["normal"]["normal"]),
        )
        for r in range(N_modes.shape[0]):
            point_data[f"rigid_mode_{r}"] = N_modes[r]
        if "N_flagellum_torque" in ops:
            point_data["rigid_flagellum"] = (
                result_to_numpy(ops["N_flagellum_torque"]).reshape(d, -1).T
            )
        path = os.path.join(self.out, f"stokes_{frame}.vtu")
        write_vtu(
            path,
            sp,
            cells,
            point_data=point_data,
            cell_data=dict(material=self.mesh.material_id.astype(np.float64)[parent]),
        )
        timers.count("output bytes", os.path.getsize(path))

    # ------------------------------------------------------------------
    def compose(self, start_frame: int, end_frame: int):
        """Offline re-aggregation of per-frame dumps: accumulate rigid
        displacements and write composed VTUs + mean stroke velocity
        (reference `composer` `:5951-6046`)."""
        cfg = self.cfg
        d = self.problem.dim
        total_disp = np.zeros(d)
        mean_U = np.zeros(self.problem.num_rigid)
        count = 0
        for frame in range(start_frame, end_frame, cfg.delta_frame):
            z = np.load(os.path.join(self.out, f"result_{frame}.npz"))
            U = z["rigid_velocities"]
            mean_U += U
            count += 1
            total_disp += cfg.time_step * U[:d]
            euler = z["euler"] + total_disp[None, :] * (self.map_body_mask > 0)
            write_vtu(
                os.path.join(self.out, f"composed_{frame}.vtu"),
                euler,
                self.problem.map_space.cells_nodes[:, : 4 if d == 3 else 2],
                point_data=dict(forces=z["stokes_forces"]),
            )
        mean_U /= max(count, 1)
        with open(os.path.join(self.out, "mean_velocities_stroke.txt"), "w") as f:
            f.write(" ".join(f"{v:.16e}" for v in mean_U) + "\n")
        return mean_U
