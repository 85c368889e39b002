"""`bemstokes_tpu_torch/ops/resistance.py` and the grand-resistance
strategy of `StokesBEMProblem.solve_frame` (`monolithic=False`) against the
JAX package's, f64, meshes built in code.

Tolerances: the Dirichlet-to-Neumann map with an LU of V 1e-12 relative
(the JAX package maps it over the modes with `vmap`, the port solves the
R + 1 right-hand sides at once); with unpreconditioned GMRES 1e-10 (the
same Arnoldi steps, rounded in a different order); frames on
create_sphere(2) (300 unknowns) 1e-10 on rigid velocities, tractions and
the 6 x 6 resistance matrix; the strategy against the monolithic Direct
solve of the same frame 1e-7 on the rigid velocities (the JAX package's
own test holds it there)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.ops.resistance as res_j
from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.la.direct import lu_factor_dense as lu_factor_j
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.ops.resistance as res_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.la.direct import lu_factor_dense as lu_factor_t
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

KEYS = ("rigid_velocities", "stokes_forces", "resistance_matrix")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300)


def _operators(n=40, rows=3, seed=0):
    """Seeded stand-ins for V (well conditioned, symmetric part dominant),
    K, a unit "normal" field with its mass dual, and rows of velocities."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, n)) / np.sqrt(n)
    V = V @ V.T + np.eye(n)
    K = rng.normal(size=(n, n)) / np.sqrt(n)
    nrm = rng.normal(size=n)
    nrm /= np.linalg.norm(nrm)
    Mn = nrm * rng.uniform(0.5, 1.5, size=n)
    return V, K, nrm, Mn, float(nrm @ Mn), rng.normal(size=(rows, n))


@pytest.mark.parametrize("inner", ["lu", "gmres"])
def test_dirichlet_to_neumann_matches_jax(inner):
    V, K, nrm, Mn, l2, vs = _operators()
    kw_j = dict(V_lu=lu_factor_j(jnp.asarray(V))) if inner == "lu" else {}
    kw_t = dict(V_lu=lu_factor_t(torch.as_tensor(V))) if inner == "lu" else {}
    args_j = (jnp.asarray(V), jnp.asarray(K))
    proj_j = (jnp.asarray(nrm), jnp.asarray(Mn), l2)
    args_t = (torch.as_tensor(V), torch.as_tensor(K))
    proj_t = (torch.as_tensor(nrm), torch.as_tensor(Mn), l2)
    tol = 1e-12 if inner == "lu" else 1e-10
    f_j = np.stack([np.asarray(res_j.dirichlet_to_neumann(*args_j, jnp.asarray(v), *proj_j, **kw_j)) for v in vs])
    # one row at a time, and all rows in one call
    for v, fj in zip(vs, f_j):
        assert _rel(fj, res_t.dirichlet_to_neumann(*args_t, torch.as_tensor(v), *proj_t, **kw_t)) <= tol
    assert _rel(f_j, res_t.dirichlet_to_neumann(*args_t, torch.as_tensor(vs), *proj_t, **kw_t)) <= tol
    # the projector removed the normal component: (M n) . f = 0
    assert np.abs(f_j @ Mn).max() <= 1e-12 * np.abs(f_j).max()


@pytest.mark.parametrize("grid_type", ["ImposedForce", "ImposedVelocity", "Real"])
def test_solve_resistance_system_matches_jax(grid_type):
    V, K, nrm, Mn, l2, vs = _operators(rows=7, seed=1)
    N, N_dual = vs[:6], vs[:6] * 0.5 + 0.1 * vs[1:7]
    sdot = vs[6]
    out_j = res_j.solve_resistance_system(
        jnp.asarray(V), jnp.asarray(K), jnp.asarray(sdot), jnp.asarray(N), jnp.asarray(N_dual),
        jnp.asarray(nrm), jnp.asarray(Mn), l2, grid_type=grid_type, imposed_component=2,
    )
    out_t = res_t.solve_resistance_system(
        torch.as_tensor(V), torch.as_tensor(K), torch.as_tensor(sdot), torch.as_tensor(N),
        torch.as_tensor(N_dual), torch.as_tensor(nrm), torch.as_tensor(Mn), l2,
        grid_type=grid_type, imposed_component=2,
    )
    for a_j, a_t in zip(out_j, out_t):
        assert _rel(a_j, a_t) <= 1e-11


def _problems(cfg, refinements=2):
    pj = ProblemJ(fac_j.create_sphere(refinements=refinements), cfg)
    pt = ProblemT(fac_t.create_sphere(refinements=refinements), from_dict(dataclasses.asdict(cfg)), device="cpu")
    return pj, pt


def _fd_gait(e0):
    """A rigid motion of the sphere between two frames (the Real grid's
    finite-difference gait)."""
    c, s = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    return e0 @ R.T + np.array([0.02, -0.01, 0.03])


@pytest.mark.parametrize("grid_type", ["ImposedForce", "ImposedVelocity", "Real"])
def test_resistance_frame_matches_jax(grid_type):
    cfg = ProblemConfig(grid_type=grid_type, imposed_component=0, force_pole="Origin", monolithic=False)
    pj, pt = _problems(cfg)
    e0 = np.asarray(pj.initial_euler())
    sdot = np.zeros(3 * pj.n)
    if grid_type == "Real":
        sdot = np.asarray(pj.shape_velocities_fd(jnp.asarray(e0), jnp.asarray(_fd_gait(e0))))
    rj = pj.solve_frame(jnp.asarray(e0), jnp.asarray(sdot))
    rt = result_to_numpy(pt.solve_frame(e0, sdot))
    assert sorted(rt) == sorted(rj)
    assert rt["iterations"] == rj["iterations"] == 1 and rt["residual"] == rj["residual"] == 0.0
    for key in KEYS:
        assert _rel(rj[key], rt[key]) <= 1e-10, key
    assert _rel(rj["diagnostics"]["com_body"] + 1.0, rt["diagnostics"]["com_body"] + 1.0) <= 1e-12
    if grid_type == "ImposedForce":
        # the sphere's mobility and its resistance matrix at 300 unknowns
        # (the JAX package's run: 6 pi U_x = 1.01046)
        assert abs(6 * np.pi * rt["rigid_velocities"][0] - 1.01046) < 1e-5
        Rm = rt["resistance_matrix"]
        assert np.max(np.abs(Rm - np.diag(np.diag(Rm)))) <= 1e-12 * 6 * np.pi


def test_resistance_matches_monolithic_direct():
    """The two strategies solve the same discrete problem: rigid velocities
    of a finite-difference rigid-motion gait agree to 1e-7."""
    base = dict(grid_type="Real", force_pole="Origin")
    cfg_m = from_dict(dataclasses.asdict(ProblemConfig(solver=SolverConfig(solve_directly=True), **base)))
    cfg_r = from_dict(dataclasses.asdict(ProblemConfig(monolithic=False, **base)))
    mesh = fac_t.create_sphere(refinements=2)
    pm = ProblemT(mesh, cfg_m, device="cpu")
    pr = ProblemT(mesh, cfg_r, device="cpu")
    e0 = pm.initial_euler()
    sdot = pm.shape_velocities_fd(e0, torch.as_tensor(_fd_gait(e0.numpy())))
    U_m = pm.solve_frame(e0, sdot)["rigid_velocities"]
    U_r = pr.solve_frame(e0, sdot)["rigid_velocities"]
    assert np.max(np.abs(U_r - U_m)) <= 1e-7 * np.max(np.abs(U_m)), (U_r, U_m)


def test_resistance_is_dispatched_before_matrix_free():
    """`monolithic=False` wins over `matrix_free`, as in the JAX package."""
    cfg = ProblemConfig(grid_type="ImposedForce", imposed_component=1, monolithic=False)
    cfg_mf = dataclasses.replace(cfg, matrix_free=True)
    mesh = fac_t.create_sphere(refinements=1)
    r0 = result_to_numpy(ProblemT(mesh, from_dict(dataclasses.asdict(cfg)), device="cpu").solve_frame(
        torch.as_tensor(fac_t.create_sphere(refinements=1).vertices), np.zeros(78)))
    pmf = ProblemT(mesh, from_dict(dataclasses.asdict(cfg_mf)), device="cpu")
    r1 = result_to_numpy(pmf.solve_frame(pmf.initial_euler(), np.zeros(78)))
    assert "resistance_matrix" in r1 and pmf._matfree is None
    assert np.array_equal(r0["rigid_velocities"], r1["rigid_velocities"])


def test_resistance_needs_the_operators():
    cfg = ProblemConfig(monolithic=False, keep_operators=False)
    pt = ProblemT(fac_t.create_sphere(refinements=0), from_dict(dataclasses.asdict(cfg)), device="cpu")
    with pytest.raises(ValueError, match="keep_operators"):
        pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n))
