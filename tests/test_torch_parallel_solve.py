"""The port's distributed frame steps (`bemstokes_tpu_torch/parallel/solve.py`)
in a gloo group of W = 2 and W = 4 processes on the CPU, against the JAX
package's (`bemstokes_tpu/parallel/solve.py`) on `row_mesh(W)` at the same
W, f64, on the same meshes built in code and the same configuration.

The unit sphere `create_sphere(2)` (98 nodes, 294 + 6 unknowns),
ImposedVelocity along x, one step from the initial geometry with a zero
gait, under each solver of the JAX package's distributed step: Direct (the
slab LU with the bordered Schur tail), the resistance strategy, the f32
factor, Jacobi and block-Jacobi (ILU).  At W = 4 also: the motor-torque
unknown (grid Real, the flagellum the half sphere at x > -0.1), the sphere
beside a no-slip wall through the Blake image kernel (ImposedForce along
y), and a sphere above a resolved, locally refined no-slip wall (hanging
nodes, per-component solid angle).

Held: the forces and the rigid velocities to 1e-10 relative (to their
largest entry), the rigid force sums F to 1e-10 of the larger of their and
the forces' largest entry (F vanishes on the force-free swimmer of the
torque case), and the GMRES iteration counts equal to the JAX package's
(within 2 above 20 iterations).  At W = 4 (two padded nodes) block-Jacobi
differs from the JAX package's by design (tests/test_torch_parallel_slab.py),
so the two GMRES runs take different paths to the tolerance 1e-10 of |rhs|:
the forces to 1e-8 (the operator's condition number, 62, times that
tolerance, with room), and no more iterations than its 196.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_dist_group import Group
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-10
#: two different preconditioners, each GMRES stopped at 1e-10 of |rhs|
TOL_OTHER_PRECONDITIONER = 1e-8
TABLE = ("direct", "resistance", "f32", "jacobi", "ilu")
EXTRA = ("torque", "no_slip", "hanging")
#: the JAX package's GMRES iterations on this sphere (ISSUE: Motivation)
JAX_ITERATIONS = {
    2: dict(direct=1, resistance=1, f32=3, jacobi=22, ilu=43),
    4: dict(direct=1, resistance=1, f32=3, jacobi=22, ilu=196),
}


def case(name, cm, fac):
    """(mesh, ProblemConfig) of a case in one package (`cm` its config
    module, `fac` its mesh factories)."""
    Solver = cm.SolverConfig
    base = dict(grid_type="ImposedVelocity", imposed_component=0)
    if name == "direct":
        kw = base
    elif name == "resistance":
        kw = dict(base, monolithic=False)
    elif name == "f32":
        kw = dict(base, solver=Solver(preconditioner_dtype="float32"))
    elif name == "jacobi":
        kw = dict(base, solver=Solver(preconditioner_type="Jacobi"))
    elif name == "ilu":
        kw = dict(base, solver=Solver(preconditioner_type="ILU"))
    elif name == "torque":
        kw = dict(grid_type="Real", force_pole="Origin", solve_with_torque=True)
    elif name == "no_slip":
        kw = dict(
            grid_type="ImposedForce",
            imposed_component=1,
            no_slip_kernel=True,
            walls=(cm.WallConfig(enabled=False, position=(0.0, -2.0, 0.0), span=(10.0, 0.0, 10.0)),),
        )
    else:  # hanging
        cfg = cm.ProblemConfig(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            body_manifold="sphere",
            alpha_row_sum="component",
            walls=(cm.WallConfig(enabled=True, wall_type="no_slip", position=(0.0, -2.0, 0.0), span=(8.0, 0.0, 8.0)),),
            wall_refinement=cm.WallRefinementConfig(enabled=True, threshold=2.0, distance_from_center=3.0),
        )
        return fac.add_walls_to_mesh(fac.create_sphere(refinements=1), cfg), cfg
    return fac.create_sphere(refinements=2), cm.ProblemConfig(**kw)


def _record(out, fields, info):
    rec = dict(
        U=np.asarray(out),
        F=np.asarray(fields["F"]),
        forces=np.asarray(fields["forces"]),
        iterations=int(info["iterations"]),
    )
    for key in ("flagellum_omega", "motor_torque"):
        if key in fields:
            rec[key] = float(fields[key])
    return rec


# ---- the ranks (child processes) --------------------------------------------


def port_steps(mesh, names):
    import bemstokes_tpu_torch.config as cm
    import bemstokes_tpu_torch.mesh.factories as fac
    from bemstokes_tpu_torch.parallel.solve import make_sharded_frame_step
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    out = {}
    for name in names:
        m, cfg = case(name, cm, fac)
        prob = StokesBEMProblem(m, cfg, device="cpu")
        step = make_sharded_frame_step(prob, mesh, return_fields=True)
        U, _, info, fields = step(prob.initial_euler(), torch.zeros(3 * prob.n, dtype=torch.float64))
        out[name] = _record(U.numpy(), {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in fields.items()}, info)
        out[name]["hanging_nodes"] = prob.hanging.n
    return out


# ---- the JAX package (this process) -----------------------------------------


def jax_steps(world, names):
    import jax.numpy as jnp

    import bemstokes_tpu.config as cm
    import bemstokes_tpu.mesh.factories as fac
    from bemstokes_tpu.parallel import row_mesh
    from bemstokes_tpu.parallel.solve import make_sharded_frame_step
    from bemstokes_tpu.problem import StokesBEMProblem

    out = {}
    for name in names:
        m, cfg = case(name, cm, fac)
        prob = StokesBEMProblem(m, cfg)
        step = make_sharded_frame_step(prob, row_mesh(world), return_fields=True)
        U, _, info, fields = step(prob.initial_euler(), jnp.zeros(3 * prob.n))
        out[name] = _record(U, fields, info)
    return out


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Both W of the port (started first: they run while this process
    computes the JAX package's steps) and of JAX."""
    cases = {2: TABLE, 4: TABLE + EXTRA}
    groups = {w: Group(__name__, "port_steps", w, tmp_path_factory.mktemp(f"w{w}"), names=list(c)) for w, c in cases.items()}
    jax = {w: jax_steps(w, c) for w, c in cases.items()}
    return {w: (g.results(), jax[w]) for w, g in groups.items()}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _F_err(pt, rj):
    scale = max(np.abs(rj["F"]).max(), np.abs(rj["forces"]).max())
    return np.abs(pt["F"] - rj["F"]).max() / scale


def _same_on_every_rank(ranks, name):
    for r in ranks[1:]:
        for key, v in ranks[0][name].items():
            assert np.array_equal(np.asarray(r[name][key]), np.asarray(v)), (name, key)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", TABLE)
def test_frame_step_matches_jax(steps, world, name):
    ranks, jx = steps[world]
    _same_on_every_rank(ranks, name)
    pt, rj = ranks[0][name], jx[name]
    padded_block_jacobi = name == "ilu" and world == 4
    expected = JAX_ITERATIONS[world][name]
    assert rj["iterations"] == expected
    if padded_block_jacobi:
        assert pt["iterations"] <= expected
    elif expected > 20:
        assert abs(pt["iterations"] - expected) <= 2
    else:
        assert pt["iterations"] == expected
    tol = TOL_OTHER_PRECONDITIONER if padded_block_jacobi else TOL
    assert _rel(pt["forces"], rj["forces"]) <= tol
    assert _F_err(pt, rj) <= tol
    assert abs(pt["F"][0] - 18.6545072705) < 1e-9


@pytest.mark.parametrize("name", EXTRA)
def test_frame_step_variants_match_jax(steps, name):
    """W = 4: the motor-torque unknown, the Blake image kernel, hanging
    nodes."""
    ranks, jx = steps[4]
    _same_on_every_rank(ranks, name)
    pt, rj = ranks[0][name], jx[name]
    assert pt["iterations"] == rj["iterations"]
    for key in ("U", "forces"):
        assert _rel(pt[key], rj[key]) <= TOL, key
    assert _F_err(pt, rj) <= TOL
    if name == "torque":
        for key in ("flagellum_omega", "motor_torque"):
            assert abs(pt[key] - rj[key]) <= TOL * abs(rj[key]), key
    if name == "hanging":
        assert pt["hanging_nodes"] > 0
