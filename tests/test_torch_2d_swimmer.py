"""The 2D frame loop of the port (`SwimmerSimulation` with `dim=2`, gaits
read from `.inp` files of line cells) against the JAX package's, f64 on the
CPU: the two loop tests of `tests/test_2d_problem.py` (that file reads the
reference's mesh files) on the 10-cell clockwise circle refined once, written to
`tmp_path`.

- A static gait: the rigid velocities vanish, the outputs are written;
- the spinning gait (the second frame turned by alpha = 0.04), Forward Euler
  and Heun: the counter-rotation U[2] within 2e-2 of -alpha/dt (the JAX
  test's bound), the 2x2 body rotation advanced by dt U[2] to 1e-12, the
  lab-frame geometry of the next frame back in place; the history within
  1e-10 of the JAX package's (absolute on velocities of order 0.4), `compose`
  equal to its;
- the same gait through `python -m bemstokes_tpu_torch run --dim 2 --device
  cpu` as a subprocess: its saved rigid velocities equal the JAX history's."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.mesh.refine import SphericalManifold as CircleJ, refine_uniform as refine_j
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.swimmer import SwimmerSimulation as SimJ
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.config_io import save_config
from bemstokes_tpu_torch.swimmer import SwimmerSimulation as SimT
import torch_threads  # noqa: F401  (one torch thread a test process)

ALPHA = 0.04
TOL = 1e-10
REPO = Path(__file__).resolve().parent.parent


def circle_mesh():
    """The 10-cell unit circle, clockwise, refined once onto the circle."""
    th = -2.0 * np.pi * np.arange(10) / 10
    cells = np.stack([np.arange(10), (np.arange(10) + 1) % 10], axis=1)
    mesh = MeshJ(np.stack([np.cos(th), np.sin(th)], axis=1), cells, np.zeros(10, np.int32))
    return refine_j(mesh, CircleJ((0.0, 0.0)), times=1)


def write_inp(path, verts, cells):
    with open(path, "w") as f:
        f.write(f"{len(verts)} {len(cells)} 0 0 0\n")
        for i, v in enumerate(verts):
            f.write(f"{i + 1} {v[0]:.16e} {v[1]:.16e} 0\n")
        for i, c in enumerate(cells):
            f.write(f"{i + 1} 0 line {c[0] + 1} {c[1] + 1}\n")


def _rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s], [s, c]])


def _gait(folder, name, angle):
    """Two frame files `<name>0.inp`, `<name>1.inp`, the second turned by
    `angle`; returns the base mesh."""
    mesh = circle_mesh()
    write_inp(folder / f"{name}0.inp", mesh.vertices, mesh.cells)
    write_inp(folder / f"{name}1.inp", mesh.vertices @ _rot(angle).T, mesh.cells)
    return mesh


def _cfg(folder, name, **kw):
    return ProblemConfig(
        dim=2,
        input_grid_path=f"{folder}/",
        input_grid_base_name=name,
        input_grid_format="inp",
        n_frames=2,
        time_step=0.1,
        grid_type="Real",
        force_pole="Origin",
        solver=SolverConfig(solve_directly=True),
        **kw,
    )


def _histories(cfg, folder, end):
    sim_j = SimJ(cfg, str(folder / "jax"))
    sim_t = SimT(from_dict(dataclasses.asdict(cfg)), str(folder / "torch"), device="cpu")
    return sim_j, sim_t, sim_j.run(0, end), sim_t.run(0, end)


def _same_history(hj, ht):
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        assert a["frame"] == b["frame"] and int(a["iterations"]) == b["iterations"]
        assert np.abs(np.asarray(a["rigid_velocities"]) - np.asarray(b["rigid_velocities"])).max() <= TOL


def test_circle_static_loop(tmp_path):
    """A static gait: rigid velocities vanish, outputs still emitted."""
    _gait(tmp_path, "circle_", 0.0)
    _, sim, hj, ht = _histories(_cfg(tmp_path, "circle_"), tmp_path, 2)
    for h in ht:
        assert np.max(np.abs(h["rigid_velocities"])) < 1e-8
    _same_history(hj, ht)
    out = tmp_path / "torch"
    assert (out / "stokes_0.vtu").exists() and (out / "point_velocities.txt").exists()
    assert np.loadtxt(out / "point_velocities.txt").shape == (2 * 3, 3)
    assert sim.state.rotation.shape == (2, 2)


@pytest.mark.parametrize("integration", ["ForwardEuler", "Heun"])
def test_circle_spinning_gait(integration, tmp_path):
    """The body cannot follow a rigid-rotation gait: it counter-rotates,
    omega ~ -alpha/dt, and its 2x2 rotation advances by omega dt."""
    mesh = _gait(tmp_path, "spin_", ALPHA)
    cfg = _cfg(tmp_path, "spin_", consider_rigid_rotations=True, time_integration=integration)
    sim_j, sim, hj, ht = _histories(cfg, tmp_path, 2)
    _same_history(hj, ht)
    np.testing.assert_allclose(sim.state.rotation, sim_j.state.rotation, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sim.compose(0, 2), sim_j.compose(0, 2), rtol=0, atol=1e-12)
    if integration == "Heun":
        return
    # frame 0 alone, as tests/test_2d_problem.py checks it
    sim = SimT(from_dict(dataclasses.asdict(cfg)), str(tmp_path / "one"), device="cpu")
    U = np.asarray(sim.run(0, 1)[0]["rigid_velocities"])
    omega = -ALPHA / cfg.time_step
    assert abs(U[2] - omega) / abs(omega) < 2e-2, U
    assert np.max(np.abs(U[:2])) < 1e-6 * abs(omega)
    ang = np.arctan2(sim.state.rotation[1, 0], sim.state.rotation[0, 0])
    assert abs(ang - cfg.time_step * U[2]) < 1e-12
    e1 = np.asarray(sim.euler_for_frame(1))
    expected = (mesh.vertices @ _rot(ALPHA).T) @ sim.state.rotation.T
    assert np.max(np.abs(np.sort(e1, axis=0) - np.sort(expected, axis=0))) < 1e-9
    assert np.max(np.abs(np.sort(e1, axis=0) - np.sort(mesh.vertices, axis=0))) < 2e-3


def test_circle_gait_through_the_command_line(tmp_path):
    """`python -m bemstokes_tpu_torch run --dim 2 --device cpu` on the
    spinning gait: frame 0's saved velocities and state as the JAX loop's."""
    _gait(tmp_path, "spin_", ALPHA)
    cfg = _cfg(tmp_path, "spin_", consider_rigid_rotations=True)
    save_config(from_dict(dataclasses.asdict(cfg)), str(tmp_path / "params.json"))
    out = tmp_path / "cli"
    done = subprocess.run(
        [sys.executable, "-m", "bemstokes_tpu_torch", "run", "--dim", "2", "--device", "cpu",
         "-p", str(tmp_path / "params.json"), "0", "1", "-o", str(out)],
        cwd=str(REPO), capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))},
    )
    assert done.returncode == 0, done.stderr[-2000:]
    hj = SimJ(cfg, str(tmp_path / "jax")).run(0, 1)
    U = np.load(out / "result_0.npz")["rigid_velocities"]
    assert np.abs(U - np.asarray(hj[0]["rigid_velocities"])).max() <= TOL
    rot = np.load(out / "state_0.npz")["rotation"]
    assert rot.shape == (2, 2) and abs(np.arctan2(rot[1, 0], rot[0, 0]) - cfg.time_step * U[2]) < 1e-12
    assert (out / "stokes_0.vtu").exists() and (out / "used_parameters_2d.json").exists()
