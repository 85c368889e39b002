"""The swimmer gaits of the port against the JAX package, on the CPU, f64:
the bacterium under the motor-torque balance (`solve_with_torque`: the
flagellum's rate is an unknown, one bordered row and column of the
monolithic system), Forward and Heun time stepping, in free space and beside
the no-slip wall, materialized and matrix-free, with an f32 LU and with
quadrature auto-promotion; and the frozen-geometry squirmer
(`velocity_type="Squirmer"`, `squirmer_change_geometry=False`), whose
frames after the first reuse the operators, the matrix and the LU.

The meshes are built in code and written as gmsh frames: a spherical head
(remapped each frame onto the ellipsoid of `spherical_head`) and a tube
deformed to the reference spiral, turned by a quarter of a turn a frame.
Both packages read the same files and run the same `ProblemConfig`
(converted by `from_dict`).

Tolerances: rigid velocities, forces, flagellum rates and the saved fields
within 1e-10 relative, with equal GMRES iterations and refactor flags
(`TOL`); the motor torque -2 within 1e-8; the frozen squirmer's swimming
speed within 1e-2 of Blake's (2/3) B1 (`SQUIRMER_TOL`: create_sphere(2)'s
flat panels miss it by 2.7e-3).  The f32-LU frame solves to a GMRES
tolerance of 1e-12, so that the two packages' f32 factors leave the same
f64 answer to TOL.  The port's matrix-free loop is held to its
materialized loop at 1e-8 (`MATFREE_TOL`): the two stop at their GMRES
tolerances, not at the rounding of a direct solve.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.flagella as fl_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.mesh.proximity as prox_j
import bemstokes_tpu.swimmer as sw_j
from bemstokes_tpu.config import ProblemConfig, QuadratureConfig, SolverConfig, WallConfig
from bemstokes_tpu.mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.swimmer import SwimmerSimulation as SimJ
import bemstokes_tpu_torch.flagella as fl_t
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.mesh.proximity as prox_t
import bemstokes_tpu_torch.swimmer as sw_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.mesh import SurfaceMesh as MeshT
from bemstokes_tpu_torch.ops import matfree_node, node_kernel
from bemstokes_tpu_torch.swimmer import SwimmerSimulation as SimT
from bemstokes_tpu_torch.utils.dealii_io import block_write
from test_torch_cli import write_msh

TOL = 1e-10
TORQUE_TOL = 1e-8
MATFREE_TOL = 1e-8
SQUIRMER_TOL = 1e-2
JITTER = 1e-6

#: the bacterium: head sphere (centre, radius, refinements) and the tube's
#: panels along and around; four gait frames over one turn
HEAD = ((-1.0, 0.0, 0.0), 0.8, 1)
TUBE = (16, 6)
GAIT_FRAMES = 4
#: Blake's squirmer: B1 of each frame (the slip B1 ((r.e) r - e), e = e_x)
B1 = (1.0, -0.5, 1.0)


def _wall(y):
    return (WallConfig(enabled=False, position=(0.0, y, 0.0), span=(10.0, 0.0, 10.0)),)


def bacterium_frames(fac, fl, mesh_cls, asarray, tonumpy):
    """The gait's frame meshes built by one package: the head sphere merged
    with the tube on the reference spiral, turned by 2 pi k / GAIT_FRAMES."""
    centre, radius, refinements = HEAD
    head = fac.create_sphere(center=centre, radius=radius, refinements=refinements)
    fc = fl.FlagellumConfig()
    tube = fl.create_initial_flagellum_mesh(fc, *TUBE)
    mask = asarray(np.ones(tube.n_vertices))
    spiral = fl.reference_spiral_euler(asarray(tube.vertices), fc, mask)
    frames = []
    for k in range(GAIT_FRAMES):
        turned = tonumpy(fl.euler_at_theta(spiral, 2.0 * np.pi * k / GAIT_FRAMES, mask))
        frames.append(head.merged_with(mesh_cls(turned, tube.cells, tube.material_id)))
    return frames


def port_frames():
    return bacterium_frames(fac_t, fl_t, MeshT, torch.as_tensor, lambda t: t.numpy())


def write_gait(folder, frames, jitter=0.0):
    """The frames as gmsh files `bacterium_<k>.msh`, every vertex moved by a
    seeded `jitter` (the same offsets in each frame)."""
    offsets = jitter * np.random.default_rng(15).standard_normal(frames[0].vertices.shape)
    for k, mesh in enumerate(frames):
        write_msh(os.path.join(folder, f"bacterium_{k}.msh"), mesh.vertices + offsets, mesh.cells)
    return str(folder) + os.sep


def bacterium_cfg(grids, kernel="free_space", integration="Forward", auto_promote=False, **kw):
    return ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        n_frames=GAIT_FRAMES,
        time_step=0.05,
        input_grid_path=grids,
        input_grid_base_name="bacterium_",
        input_grid_format="msh",
        solve_with_torque=True,
        spherical_head=True,
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_integration=integration,
        no_slip_kernel=kernel == "no_slip",
        walls=_wall(-3.0),
        quadrature=QuadratureConfig(auto_promote=auto_promote),
        **kw,
    )


@pytest.fixture(scope="module")
def gait(tmp_path_factory):
    folder = tmp_path_factory.mktemp("bacterium")
    return write_gait(folder, port_frames())


def _sims(cfg, out):
    sj = SimJ(cfg, str(out / "jax"))
    st = SimT(from_dict(dataclasses.asdict(cfg)), str(out / "torch"), device="cpu")
    return sj, st


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(a))


def _assert_same_run(sj, st, hj, ht, tol=TOL):
    """Histories, saved results and the txt series of the two runs agree."""
    assert [h["frame"] for h in ht] == [h["frame"] for h in hj]
    for a, b in zip(hj, ht):
        assert _rel(a["rigid_velocities"], b["rigid_velocities"]) <= tol
        assert a["iterations"] == b["iterations"]
        assert a["refactored"] == b["refactored"]
        for key in ("flagellum_omega", "motor_torque"):
            assert (key in a) == (key in b)
            if key in a:
                assert abs(a[key] - b[key]) <= tol * abs(a[key]), key
        zj = np.load(os.path.join(sj.out, f"result_{a['frame']}.npz"))
        zt = np.load(os.path.join(st.out, f"result_{a['frame']}.npz"))
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert _rel(zj[key], zt[key]) <= tol, key
    for name in ("point_velocities.txt", "center_of_mass_position.txt"):
        tj = np.loadtxt(os.path.join(sj.out, name))
        tt = np.loadtxt(os.path.join(st.out, name))
        assert tj.shape == tt.shape
        assert np.max(np.abs(tj - tt)) <= tol * max(1.0, np.max(np.abs(tj)))


def _assert_torque_physics(st, ht):
    """The motor balance holds every frame, the body counter-rotates
    against the flagellum and the bacterium swims head first (along -x)."""
    torque = np.atleast_1d(np.loadtxt(os.path.join(st.out, "motor_torque.txt")))
    assert torque.shape == (len(ht),)
    assert np.max(np.abs(torque + 2.0)) <= TORQUE_TOL * 2.0
    for h in ht:
        U, omega = np.asarray(h["rigid_velocities"]), h["flagellum_omega"]
        assert abs(h["motor_torque"] + 2.0) <= TORQUE_TOL * 2.0
        assert np.sign(U[3]) == -np.sign(omega) and abs(U[3]) < abs(omega)
        assert U[0] < 0 and abs(U[0]) > max(abs(U[1]), abs(U[2]))


# ---- the gait's geometry ------------------------------------------------------


def test_bacterium_frames_match_jax(tmp_path):
    """The frames that both packages build (merged_with, the reference
    spiral, euler_at_theta), the head/flagellum split of the problem, the
    ellipsoidal head remap and the frame geometry the loop solves on."""
    ft = port_frames()
    fj = bacterium_frames(fac_j, fl_j, MeshJ, jnp.asarray, np.asarray)
    for a, b in zip(fj, ft):
        assert np.array_equal(a.cells, b.cells)
        assert np.max(np.abs(a.vertices - b.vertices)) <= 1e-14
    # the head (x <= -0.2) and the tube (x >= 0.125) are apart
    head = ft[0].vertices[:, 0] < 0
    assert ft[0].vertices[head, 0].max() < -0.1 < 0 < ft[0].vertices[~head, 0].min()
    sj, st = _sims(bacterium_cfg(write_gait(tmp_path, ft)), tmp_path)
    assert np.array_equal(st.problem.flagellum_node_mask, sj.problem.flagellum_node_mask)
    assert np.array_equal(st.problem.head_node_mask, sj.problem.head_node_mask)
    assert 0 < st.problem.flagellum_node_mask.sum() < st.problem.body_node_mask.sum()
    for k in range(GAIT_FRAMES):
        ej, et = np.asarray(sj.euler_for_frame(k)), st.euler_for_frame(k)
        assert np.max(np.abs(ej - et)) <= 1e-14
    e = st.euler_for_frame(0)
    mask = st.map_body_mask[:, 0] > 0
    assert np.array_equal(sw_t._spherical_head_remap(e, mask), np.asarray(sw_j._spherical_head_remap(e, mask)))
    # the remapped head lies on the ellipsoid (1.6, 0.8, 0.8) about (-1.6, 0, 0)
    h = st.problem.head_node_mask > 0
    q = (e[h] - np.array([-1.6, 0.0, 0.0])) / np.array([1.6, 0.8, 0.8])
    assert np.max(np.abs(np.linalg.norm(q, axis=1) - 1.0)) <= 1e-14


# ---- the bacterium under the motor-torque balance ---------------------------


@pytest.mark.parametrize("integration", ["Forward", "Heun"])
@pytest.mark.parametrize("kernel", ["free_space", "no_slip"])
def test_bacterium_torque_loop_matches_jax(kernel, integration, gait, tmp_path):
    """The solved flagellum rate defines the gait velocity.  Forward: two
    frames, frame 1 turns the flagellum by a quarter turn on the stale LU
    (79 GMRES iterations).  Heun: one frame, whose predictor solves at frame
    1's geometry on that stale LU, and the two velocities averaged."""
    frames = 2 if integration == "Forward" else 1
    sj, st = _sims(bacterium_cfg(gait, kernel, integration), tmp_path)
    hj, ht = sj.run(0, frames), st.run(0, frames)
    _assert_same_run(sj, st, hj, ht)
    _assert_torque_physics(st, ht)
    assert [h["refactored"] for h in ht] == [True, False][:frames]
    assert ht[0]["iterations"] == 1 and (frames == 1 or ht[1]["iterations"] > 50)
    assert not any(node_kernel.launches.values())  # CPU tensors: plain versions
    if integration == "Heun":
        fwd = SimT(from_dict(dataclasses.asdict(bacterium_cfg(gait, kernel))), str(tmp_path / "fwd"), device="cpu")
        assert _rel(fwd.run(0, 1)[0]["rigid_velocities"], ht[0]["rigid_velocities"]) > 1e-3


def test_bacterium_matrix_free_torque_loop_matches_jax(gait, tmp_path):
    """The matrix-free solve carries the torque unknown in its Schur tail
    (R + 1 columns): the JAX package's matrix-free loop, and the port's
    materialized loop to MATFREE_TOL."""
    mf = dict(matrix_free=True, matfree_block_nodes=64, solver=SolverConfig(tolerance=1e-11))
    sj, st = _sims(bacterium_cfg(gait, **mf), tmp_path)
    hj, ht = sj.run(0, 1), st.run(0, 1)
    _assert_same_run(sj, st, hj, ht)
    _assert_torque_physics(st, ht)
    assert not any(matfree_node.launches.values())
    dense = SimT(from_dict(dataclasses.asdict(bacterium_cfg(gait))), str(tmp_path / "dense"), device="cpu")
    hd = dense.run(0, 1)
    assert _rel(hd[0]["rigid_velocities"], ht[0]["rigid_velocities"]) <= MATFREE_TOL
    assert abs(hd[0]["flagellum_omega"] - ht[0]["flagellum_omega"]) <= MATFREE_TOL * abs(hd[0]["flagellum_omega"])


def test_bacterium_f32_lu_frame_matches_jax(gait, tmp_path):
    """Frame 0 under an f32 LU (`preconditioner_dtype="float32"`): the JAX
    package's bench warns that the motor-torque system overflows f32 under
    a plain f32 LU; on this gait neither package overflows, and both take
    the same GMRES iterations to the same f64 answer."""
    cfg = bacterium_cfg(gait, solver=SolverConfig(preconditioner_dtype="float32", tolerance=1e-12))
    sj, st = _sims(cfg, tmp_path)
    hj, ht = sj.run(0, 1), st.run(0, 1)
    _assert_same_run(sj, st, hj, ht)
    assert 1 < ht[0]["iterations"] < 10 and np.isfinite(ht[0]["rigid_velocities"]).all()
    _assert_torque_physics(st, ht)


def test_promoted_bacterium_matches_jax(tmp_path):
    """Auto-promotion fires on the head-tube gap (0.34 against a head panel
    of 0.8), so every frame adds the near-pair delta.  Every vertex is
    jittered by 1e-6: on the symmetric head the near-panel selection meets
    exact distance ties otherwise, which the JAX package's jitted `top_k`
    breaks apart from the port's stable sort."""
    grids = write_gait(tmp_path, port_frames(), jitter=JITTER)
    sj, st = _sims(bacterium_cfg(grids, auto_promote=True), tmp_path)
    assert st.problem.quadrature_promoted and sj.problem.quadrature_promoted
    gap_t, gap_j = prox_t.min_intercomponent_gap(st.mesh), prox_j.min_intercomponent_gap(sj.mesh)
    assert gap_t == gap_j and gap_t[0] < gap_t[1]
    hj, ht = sj.run(0, 2), st.run(0, 2)
    _assert_same_run(sj, st, hj, ht)
    _assert_torque_physics(st, ht)


# ---- the frozen-geometry squirmer -----------------------------------------------


def squirmer_gait(folder, refinements=2):
    """create_sphere(refinements) as the one frame mesh, and each frame's
    slip B1 ((r.e) r - e) as a gait velocity file: frame 1 deal.II
    block_write binary, the others .npy."""
    mesh = fac_t.create_sphere(refinements=refinements)
    write_msh(os.path.join(folder, "squirmer_0.msh"), mesh.vertices, mesh.cells)
    rhat = mesh.vertices / np.linalg.norm(mesh.vertices, axis=1, keepdims=True)
    e = np.array([1.0, 0.0, 0.0])
    for k, b in enumerate(B1):
        slip = (b * ((rhat @ e)[:, None] * rhat - e)).T.reshape(-1)
        stem = os.path.join(folder, f"squirming_velocity_3d_frame_{k}")
        if k == 1:
            block_write(stem + ".bin", slip)
        else:
            np.save(stem + ".npy", slip)
    return str(folder) + os.sep


def squirmer_cfg(folder, kernel="free_space", **kw):
    return ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        n_frames=1,
        input_grid_path=folder,
        input_grid_base_name="squirmer_",
        input_grid_format="msh",
        input_velocity_path=folder,
        velocity_type="Squirmer",
        squirmer_change_geometry=False,
        consider_rigid_displacements=False,
        consider_rigid_rotations=False,
        no_slip_kernel=kernel == "no_slip",
        walls=_wall(-3.0),
        **kw,
    )


@pytest.mark.parametrize("kernel", ["free_space", "no_slip"])
def test_frozen_squirmer_matches_jax(kernel, tmp_path):
    """Frame 0 assembles and factors; frames 1-2 rebuild only the rhs from
    the gait files and solve on the kept LU.  In free space the squirmer
    swims at Blake's U = (2/3) B1 along e_x and nowhere else."""
    sj, st = _sims(squirmer_cfg(squirmer_gait(tmp_path), kernel), tmp_path)
    calls = []
    frozen = st.problem.solve_frame_frozen
    st.problem.solve_frame_frozen = lambda *a: calls.append(1) or frozen(*a)
    hj, ht = sj.run(0, 3), st.run(0, 3)
    _assert_same_run(sj, st, hj, ht)
    assert [h["refactored"] for h in ht] == [True, False, False] and len(calls) == 2
    for h, b in zip(ht, B1):
        U = np.asarray(h["rigid_velocities"])
        if kernel == "free_space":
            assert abs(U[0] - 2.0 / 3.0 * b) <= SQUIRMER_TOL * abs(2.0 / 3.0 * b)
            assert np.max(np.abs(U[1:])) <= 1e-12
        else:
            assert U[0] * b > 0
    # a frozen frame equals a full solve at the same geometry and velocity
    full = st.problem.solve_frame(st.euler_for_frame(1), st.shape_velocities(1, None))
    assert _rel(full["rigid_velocities"], ht[1]["rigid_velocities"]) <= TOL


def test_frozen_squirmer_matrix_free_raises_as_jax(tmp_path):
    """The matrix-free solve keeps no K operator, so frame 1 of a frozen
    squirmer raises the same ValueError in both packages (the reference's
    behaviour, not a fault of either)."""
    cfg = squirmer_cfg(squirmer_gait(tmp_path, refinements=1), matrix_free=True, matfree_block_nodes=32)
    sj, st = _sims(cfg, tmp_path)
    with pytest.raises(ValueError, match="needs the previous frame's K operator") as ej:
        sj.run(0, 2)
    with pytest.raises(ValueError, match="needs the previous frame's K operator") as et:
        st.run(0, 2)
    assert str(ej.value) == str(et.value)
    assert len(sj.history) == len(st.history) == 1  # frame 0 solved
