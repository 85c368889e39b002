"""The port's distributed path through time: the stale LU, the frozen
geometry, Heun and the 2D circle through the distributed frame step
(`bemstokes_tpu_torch/parallel/solve.py`) in a gloo group of W = 2
processes on the CPU, against the JAX package's on `row_mesh(2)`; and the
distributed frame loop (`SwimmerSimulation` with `distributed`) through the
command line in two processes under torchrun's environment, against the
port's one-process loop.

- stale LU: create_sphere(2), ImposedVelocity along x; frame 0 factors,
  frame 1 (the sphere rotated and moved) reuses the factors: iterations and
  refactor flags equal to the JAX package's, F and forces to 1e-10;
- frozen geometry: the squirmer (grid Real, slip B1 ((e.r) r - e)) with
  `keep_frozen_pieces`: a full step at B1 = 1, then `step.frozen` at
  B1 = -0.5, rigid velocities and forces to 1e-10;
- Heun: `sharded_heun_step` on a seeded smooth gait (grid Real), the
  averaged rigid velocities to 1e-10;
- 2D: the 10-cell clockwise circle refined 3 times (80 nodes), rotating
  (ImposedVelocity, component 2): forces and the torque to 1e-10;
- the BIE field (`postprocess.sharded_evaluate_stokes_bie`) at 37 points,
  each rank evaluating its share: 1e-12 relative;
- the frame loop: `python -m bemstokes_tpu_torch run --device cpu` on two
  frames of the sphere sedimenting beside a no-slip wall
  (create_sphere(2) built in code, `"distributed": true`) as two ranks;
  rank 0 alone writes, so that the output folder holds the same files as
  the one-process run's (`distributed` false) and each time series one row
  per frame and mode; the saved results, states and series equal to that
  run's to 1e-10.
"""

import json

import numpy as np
import pytest
import torch

from torch_dist_group import Group
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-10
WORLD = 2


def _rot(axis, theta):
    c, s = np.cos(theta), np.sin(theta)
    i, j = [k for k in range(3) if k != axis]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def _gait(euler):
    rng = np.random.default_rng(11)
    A, b = rng.standard_normal((3, 3)), rng.standard_normal(3)
    return (0.1 * (euler @ A.T) + 0.05 * b).T.reshape(-1)


def _slip(euler, B1):
    rhat = euler / np.linalg.norm(euler, axis=1, keepdims=True)
    e = np.array([1.0, 0.0, 0.0])
    return (B1 * ((rhat @ e)[:, None] * rhat - e[None, :])).T.reshape(-1)


def _circle(Mesh, Circle, refine):
    th = -2.0 * np.pi * np.arange(10) / 10
    cells = np.stack([np.arange(10), (np.arange(10) + 1) % 10], axis=1)
    mesh = Mesh(np.stack([np.cos(th), np.sin(th)], axis=1), cells, np.zeros(10, np.int32))
    return refine(mesh, Circle((0.0, 0.0)), times=3)


def _sim_cfg(cm, **kw):
    """The unit sphere built in code 2 radii above the no-slip image plane,
    sedimenting under a unit force along y."""
    return cm.ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=2,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=1,
        no_slip_kernel=True,
        walls=(cm.WallConfig(enabled=False, position=(0.0, -2.0, 0.0), span=(10.0, 0.0, 10.0)),),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        n_frames=2,
        **kw,
    )


def run_cases(pkg, mesh_of):
    """The five cases in one package: `pkg` maps names to its modules and
    functions, `mesh_of(world)` is its row mesh, `arr(x)` its array maker
    and `np_(x)` back to numpy."""
    cm, fac, Problem, make, heun, arr, np_ = (
        pkg[k] for k in ("cm", "fac", "Problem", "make", "heun", "arr", "np")
    )
    mesh = mesh_of(WORLD)
    out = {}

    def fields_of(res):
        U, _, info, f = res
        return dict(U=np_(U), F=np_(f["F"]), forces=np_(f["forces"]), iterations=int(info["iterations"]))

    # stale LU
    prob = Problem(fac.create_sphere(refinements=2), cm.ProblemConfig(grid_type="ImposedVelocity", imposed_component=0))
    e0 = np.asarray(np_(prob.initial_euler()))
    step = make(prob, mesh, return_fields=True)
    out["stale"] = []
    for e in (e0, e0 @ _rot(2, 0.3).T + np.array([0.5, -0.2, 0.1])):
        rec = fields_of(step(arr(e), arr(np.zeros(3 * prob.n))))
        rec["refactored"] = bool(step.stale_state["refactored"])
        out["stale"].append(rec)

    # frozen geometry
    cfg = cm.ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        velocity_type="Squirmer",
        squirmer_change_geometry=False,
        consider_rigid_displacements=False,
        consider_rigid_rotations=False,
    )
    prob = Problem(fac.create_sphere(refinements=2), cfg)
    step = make(prob, mesh, return_fields=True, keep_frozen_pieces=True)
    full = fields_of(step(arr(e0), arr(_slip(e0, 1.0))))
    frozen = fields_of(step.frozen(arr(_slip(e0, -0.5))))
    out["frozen"] = [full, dict(frozen, refactored=bool(step.stale_state["refactored"]))]

    # Heun
    prob = Problem(fac.create_sphere(refinements=2), cm.ProblemConfig(grid_type="Real", force_pole="Origin"))
    step = make(prob, mesh)
    U, info, info2 = heun(step, arr(e0), arr(_gait(e0)))
    out["heun"] = dict(U=np_(U), iterations=(int(info["iterations"]), int(info2["iterations"])))

    # 2D circle
    cfg = cm.ProblemConfig(dim=2, force_pole="Origin", grid_type="ImposedVelocity", imposed_component=2)
    prob = Problem(_circle(pkg["Mesh"], pkg["Circle"], pkg["refine"]), cfg)
    step = make(prob, mesh, return_fields=True)
    out["circle"] = fields_of(step(prob.initial_euler(), arr(np.zeros(2 * prob.n))))

    # the BIE field, the points split over the ranks
    prob = Problem(fac.create_sphere(refinements=2), cm.ProblemConfig())
    rng = np.random.default_rng(7)
    u, f = rng.normal(size=3 * prob.n), rng.normal(size=3 * prob.n)
    pts = rng.normal(size=(37, 3))
    pts *= rng.uniform(1.3, 3.0, size=(37, 1)) / np.linalg.norm(pts, axis=1, keepdims=True)
    field = pkg["pp"].sharded_evaluate_stokes_bie(arr(pts), arr(u), arr(f), arr(e0), prob.tables, mesh)
    out["field"] = np_(field)
    return out


# ---- the ranks (child processes) --------------------------------------------


def port_cases(mesh):
    import bemstokes_tpu_torch.config as cm
    import bemstokes_tpu_torch.mesh.factories as fac
    from bemstokes_tpu_torch.mesh.refine import SphericalManifold, refine_uniform
    from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh
    from bemstokes_tpu_torch.parallel.solve import make_sharded_frame_step, sharded_heun_step
    from bemstokes_tpu_torch import postprocess
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    pkg = dict(
        pp=postprocess,
        cm=cm,
        fac=fac,
        Problem=lambda m, c: StokesBEMProblem(m, c, device="cpu"),
        make=make_sharded_frame_step,
        heun=sharded_heun_step,
        arr=lambda x: torch.as_tensor(x, dtype=torch.float64),
        np=lambda t: t.numpy(),
        Mesh=SurfaceMesh,
        Circle=SphericalManifold,
        refine=refine_uniform,
    )
    return run_cases(pkg, lambda world: mesh)


# ---- the JAX package and the one-process loop (this process) ----------------


def jax_cases():
    import jax.numpy as jnp

    import bemstokes_tpu.config as cm
    import bemstokes_tpu.mesh.factories as fac
    from bemstokes_tpu.mesh.refine import SphericalManifold, refine_uniform
    from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh
    from bemstokes_tpu.parallel import row_mesh
    from bemstokes_tpu.parallel.solve import make_sharded_frame_step, sharded_heun_step
    from bemstokes_tpu import postprocess
    from bemstokes_tpu.problem import StokesBEMProblem

    pkg = dict(
        pp=postprocess,
        cm=cm,
        fac=fac,
        Problem=StokesBEMProblem,
        make=make_sharded_frame_step,
        heun=sharded_heun_step,
        arr=jnp.asarray,
        np=np.asarray,
        Mesh=SurfaceMesh,
        Circle=SphericalManifold,
        refine=refine_uniform,
    )
    return run_cases(pkg, row_mesh)


def _one_process_loop(folder):
    import bemstokes_tpu_torch.config as cm
    from bemstokes_tpu_torch.swimmer import SwimmerSimulation

    SwimmerSimulation(_sim_cfg(cm), str(folder), device="cpu").run(0, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks (the steps, and the command line as two torchrun
    ranks) started first; then the JAX package's steps and the port's
    one-process loop in this process."""
    import sys

    import bemstokes_tpu_torch.config as cm
    from bemstokes_tpu_torch.config_io import save_config

    steps = Group(__name__, "port_cases", WORLD, tmp_path_factory.mktemp("steps"))
    folder = tmp_path_factory.mktemp("loop")
    params = folder / "params.json"
    save_config(_sim_cfg(cm, distributed=True), str(params))
    argv = [sys.executable, "-m", "bemstokes_tpu_torch", "run", "-p", str(params), "--device", "cpu"]
    loop = Group.command(argv + ["0", "2", "-o", str(folder / "dist")], WORLD, folder / "ranks")
    jax = jax_cases()
    _one_process_loop(folder / "single")
    return steps.results(), jax, loop.wait(), folder


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _match(pt, rj):
    assert pt["iterations"] == rj["iterations"]
    for key in ("U", "forces"):
        assert _rel(pt[key], rj[key]) <= TOL, key
    scale = max(np.abs(rj["F"]).max(), np.abs(rj["forces"]).max())
    assert np.abs(pt["F"] - rj["F"]).max() <= TOL * scale


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_ranks_agree(runs):
    """Every rank returns the same bits."""
    port = runs[0]
    assert _same(port[0], port[1])


def test_stale_lu_matches_jax(runs):
    pt, rj = runs[0][0]["stale"], runs[1]["stale"]
    assert [r["refactored"] for r in pt] == [r["refactored"] for r in rj] == [True, False]
    for a, b in zip(pt, rj):
        _match(a, b)
    assert pt[1]["iterations"] > 1  # the stale factors are a preconditioner, not the inverse


def test_frozen_step_matches_jax(runs):
    pt, rj = runs[0][0]["frozen"], runs[1]["frozen"]
    for a, b in zip(pt, rj):
        _match(a, b)
    assert pt[1]["refactored"] is False
    # Lighthill/Blake: U = (2/3) B1 e_x
    assert pt[1]["U"][0] == pytest.approx(2.0 / 3.0 * (-0.5), rel=2e-2)


def test_heun_matches_jax(runs):
    pt, rj = runs[0][0]["heun"], runs[1]["heun"]
    assert pt["iterations"] == rj["iterations"]
    assert _rel(pt["U"], rj["U"]) <= TOL


def test_circle_matches_jax(runs):
    pt, rj = runs[0][0]["circle"], runs[1]["circle"]
    _match(pt, rj)
    assert abs(abs(pt["F"][2]) - 4 * np.pi) / (4 * np.pi) < 2e-3


def test_sharded_field_matches_jax(runs):
    pt, rj = runs[0][0]["field"], runs[1]["field"]
    assert pt.shape == (37, 3)
    assert _rel(pt, rj) <= 1e-12


def test_command_line_loop_matches_one_process(runs):
    """Two torchrun ranks of `python -m bemstokes_tpu_torch run`: rank 0
    alone writes, the same files as the one-process loop, equal to them."""
    from bemstokes_tpu_torch.swimmer import SwimmerState

    logs, folder = runs[2], runs[3]
    assert all("multi-process: rank" in log for log in logs)
    dist_dir, single = folder / "dist", folder / "single"
    assert sorted(p.name for p in dist_dir.iterdir()) == sorted(
        [p.name for p in single.iterdir()] + ["used_parameters_3d.json"]
    )
    for k in range(2):
        zd, zs = np.load(dist_dir / f"result_{k}.npz"), np.load(single / f"result_{k}.npz")
        assert sorted(zd.files) == sorted(zs.files)
        for key in zs.files:
            assert _rel(zd[key], zs[key]) <= TOL, key
        sd, ss = SwimmerState.load(dist_dir / f"state_{k}.npz"), SwimmerState.load(single / f"state_{k}.npz")
        assert sd.frame == ss.frame == k
        assert np.abs(sd.displacements - ss.displacements).max() <= TOL * np.abs(ss.displacements).max()
    for name in ("point_velocities.txt", "origin_velocities.txt", "center_of_mass_position.txt"):
        td, ts = np.loadtxt(dist_dir / name), np.loadtxt(single / name)
        assert td.shape == ts.shape and td.shape[0] == (12 if name != "center_of_mass_position.txt" else 2)
        assert np.abs(td - ts).max() <= TOL * max(1.0, np.abs(ts).max())
    assert json.loads((dist_dir / "used_parameters_3d.json").read_text())["distributed"] is True
