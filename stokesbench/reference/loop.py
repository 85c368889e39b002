"""The reference's frame of a frame loop, and the numbers that judge a
candidate's frame against it.

A candidate is what computed a frame: the program (its output files and
its loop history) or the control (this reference in the precision below
the one the configuration states).  For frame k it is judged from the
state the candidate carried into that frame (the loop's state after frame
k - 1, or the initial state), so the reference follows the candidate's
loop frame by frame and checks each stage of a frame by itself:

- geometry: the frame's node positions, from the gait file, the head remap
  or the sphere manifold, the body rotation and the displacements;
- solve: the rigid velocities, the tractions and, for a swimmer, the gait
  rate, from the reference's own assembly and dense solve at its own
  geometry (the transmitted motor torque is not compared: the torque row
  holds it at its imposed value in any precision, so no control reads
  apart from the program there);
- state: the rotation and displacements after the frame, from the state
  before it advanced by the candidate's own velocities.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import bem


def frame_file(problem, k):
    return os.path.join(
        problem["input_grid_path"], f"{problem['input_grid_base_name']}{k % problem['n_frames']}.msh"
    )


class Reference:
    """The reference of one configuration's frame loop in `dtype`."""

    def __init__(self, problem, dtype=torch.float64, device="cpu"):
        if problem.get("force_pole", "Origin") not in ("Origin", "Baricenter"):
            raise ValueError("the reference takes the force pole at the origin or the body's centre")
        if problem.get("map_degree", 1) != 1 or problem.get("fe_degree", 1) != 1:
            raise ValueError("the reference is bilinear (Q1) only")
        if any(w.get("enabled", False) for w in problem.get("walls", ())):
            raise ValueError("the reference has no meshed walls")
        self.problem = problem
        self.dtype = dtype
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        verts0, cells = bem.read_msh(frame_file(problem, 0))
        self.cells = cells
        self.wall = None
        if problem.get("no_slip_kernel"):
            w0 = problem["walls"][0]
            axis = int(np.argmin(np.abs(np.asarray(w0["span"]))))
            self.wall = (axis, float(w0["position"][axis]))
        quad = problem.get("quadrature", {})
        order = quad.get("order", 4)
        self.frame = bem.Frame(
            cells,
            len(verts0),
            order=order,
            singular_order=quad.get("singular_order", 5),
            near_panels=quad.get("near_panels", 32),
            promote_boost=quad.get("promote_boost", 4),
            promote=quad.get("auto_promote", True) and bem.promoted(verts0, cells, self.wall),
            wall=self.wall,
            dtype=dtype,
            device=device,
        )
        # the program splits head from flagellum on its first frame's file
        self.flagellum = (verts0[:, 0] > -0.1).astype(np.float64) if problem.get("solve_with_torque") else None

    def euler(self, k, rotation, displacements):
        """Node positions of frame k under the loop's state, in the
        reference's precision."""
        p = self.problem
        f = self.np_dtype
        verts, _ = bem.read_msh(frame_file(p, k))
        verts = verts.astype(f)
        if p.get("body_manifold") == "sphere":
            verts = bem.snap_sphere(verts, np.asarray(p.get("body_manifold_center", (0.0, 0.0, 0.0)), dtype=f),
                                    f(p.get("body_manifold_radius", 1.0)))
        if p.get("spherical_head"):
            verts = bem.spherical_head(verts)
        euler = verts @ np.asarray(rotation, dtype=f).T
        if p.get("consider_rigid_displacements"):
            euler = euler + np.asarray(displacements, dtype=f)
        return euler

    def advance(self, rotation, displacements, U):
        """The state after a frame with rigid velocities U."""
        p = self.problem
        dt = p.get("time_step", 0.1)
        f = self.np_dtype
        R = np.asarray(rotation, dtype=np.float64)
        if p.get("consider_rigid_rotations", True):
            R = bem.advance_rotation(R, np.asarray(U, dtype=np.float64)[3:6], dt)
        disp = np.asarray(displacements, dtype=f)
        if p.get("consider_rigid_displacements"):
            axes = np.array([1.0 if a else 0.0 for a in p.get("rigid_displacement_axes", (False,) * 3)], dtype=f)
            disp = disp + f(dt) * np.asarray(U, dtype=f)[None, :3] * axes[None, :]
        return R.astype(f), disp

    def solve(self, euler, rotation):
        p = self.problem
        return self.frame.solve(
            euler,
            grid=p.get("grid_type", "Real"),
            imposed_component=p.get("imposed_component", 1),
            rotation=rotation,
            flagellum=self.flagellum,
            motor_torque=p.get("imposed_motor_torque", -2.0),
            pole=p.get("force_pole", "Origin"),
        )

    def candidate(self, k, rotation, displacements):
        """This reference put in the program's place: frame k computed from
        the state before it, as the program's outputs of that frame."""
        euler = self.euler(k, rotation, displacements)
        sol = self.solve(euler, np.asarray(rotation, dtype=self.np_dtype))
        R, disp = self.advance(rotation, displacements, sol["velocities"])
        out = dict(euler=euler, forces=sol["forces"], velocities=sol["velocities"], rotation=R, displacements=disp)
        for key in ("omega", "torque"):
            if key in sol:
                out[key] = float(sol[key])
        return out


def _rel(a, b):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / (scale if scale > 0 else 1.0))


def expected(ref, k, rotation, displacements):
    """The reference's frame k from the state the candidate carried into
    it: (node positions, solution)."""
    euler = ref.euler(k, rotation, displacements)
    return euler, ref.solve(euler, rotation)


def judge(ref, exp, rotation, displacements, cand):
    """The numbers that compare a candidate's frame (a dict as
    `Reference.candidate` returns) with the reference's `exp` of that frame
    (`expected`), from the state (rotation, displacements) the candidate
    carried into the frame."""
    euler, sol = exp
    R, disp = ref.advance(rotation, displacements, cand["velocities"])
    gaps = dict(
        geometry=_rel(cand["euler"], euler),
        velocity=_rel(cand["velocities"], sol["velocities"]),
        traction=_rel(cand["forces"], sol["forces"]),
        state=max(_rel(cand["rotation"], R), _rel(cand["displacements"], disp)),
    )
    if "omega" in sol:
        gaps["omega"] = _rel(cand["omega"], sol["omega"])
    return gaps
