"""`bemstokes_tpu_torch/la/preconditioners.py` against the JAX package's
`bemstokes_tpu/la/preconditioners.py`, and the generic-GMRES branch of
`StokesBEMProblem.solve_frame` that it feeds, f64.

- Each `build_preconditioner` kind's `apply` on the same seeded matrix and
  vector: 1e-12 relative (LAPACK's triangular and LU solves on both sides,
  called through different wrappers).  The matrix carries a zero diagonal
  tail, as the monolithic saddle system does, so the zero-diagonal guard
  and the identity padding of the last block are exercised.
- `band_mask`: exact.
- The problem-level frame per type on create_sphere(2) (98 nodes, 300
  unknowns): equal GMRES iteration counts and 1e-10 relative on rigid
  velocities, forces and tractions (the JAX package's runs give 22, 51, 45,
  53 iterations for Jacobi, SOR, SSOR and ILU/AMG).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.la.preconditioners as pc_j
import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.la as la_t
import bemstokes_tpu_torch.la.preconditioners as pc_t
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

KINDS = ("Jacobi", "SOR", "SSOR", "ILU", "AMG", "BlockJacobi", "Direct")


def _system(n=83, tail=4, seed=0):
    """A seeded diagonally weighted matrix whose last `tail` diagonal
    entries are zero (the rigid saddle block), and a vector."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    A[n - tail :, n - tail :] = 0.0
    return A, rng.normal(size=n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300)


@pytest.mark.parametrize("bandwith", [None, 9], ids=["dense", "band9"])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_matches_jax(kind, bandwith):
    A, v = _system()
    kw = dict(omega=1.3, n_blocks=5, bandwith=bandwith)
    if kind == "Direct":
        # the LU of a zero-tailed saddle block is singular: factor a
        # regular matrix
        A = A + np.diag(np.where(np.diag(A) == 0, 1.0, 0.0))
    p_j = pc_j.build_preconditioner(jnp.asarray(A), kind, **kw)
    p_t = pc_t.build_preconditioner(torch.as_tensor(A), kind, **kw)
    out_j = p_j.apply(jnp.asarray(v))
    out_t = p_t.apply(torch.as_tensor(v))
    assert out_t.shape == (A.shape[0],) and out_t.dtype == torch.float64
    assert _rel(out_j, out_t.numpy()) <= 1e-12


@pytest.mark.parametrize("n_blocks", [1, 4, 7])
def test_block_jacobi_factors_match_jax(n_blocks):
    """The padded, batched block factors themselves: one LU per diagonal
    block, identity padding, zero diagonals set to 1."""
    A, v = _system(n=50, seed=n_blocks)
    lu_j, piv_j = pc_j._block_lu_factor(jnp.asarray(A), n_blocks)
    lu_t, piv_t = pc_t._block_lu_factor(torch.as_tensor(A), n_blocks)
    assert tuple(lu_t.shape) == lu_j.shape == (n_blocks, -(-50 // n_blocks), -(-50 // n_blocks))
    assert _rel(lu_j, lu_t.numpy()) <= 1e-12
    # LAPACK's pivots are 1-based in torch, 0-based in jax
    assert np.array_equal(np.asarray(piv_j), piv_t.numpy() - 1)


@pytest.mark.parametrize("bandwith", [0, 3, 40])
def test_band_mask_matches_jax(bandwith):
    A, _ = _system(n=31, seed=bandwith)
    out = pc_t.band_mask(torch.as_tensor(A), bandwith).numpy()
    assert np.array_equal(out, np.asarray(pc_j.band_mask(jnp.asarray(A), bandwith)))
    i, j = np.nonzero(out)
    assert np.abs(i - j).max() <= bandwith


def test_safe_diag_and_exports():
    A, _ = _system(n=12, tail=3)
    d = pc_t._safe_diag(torch.as_tensor(A)).numpy()
    assert np.array_equal(d, np.asarray(pc_j._safe_diag(jnp.asarray(A))))
    assert np.all(d[-3:] == 1.0)
    assert la_t.build_preconditioner is pc_t.build_preconditioner
    with pytest.raises(ValueError, match="unknown preconditioner"):
        pc_t.build_preconditioner(torch.as_tensor(A), "Chebyshev")


def test_direct_with_a_band_is_built_here_and_refused_by_the_problem():
    A, v = _system(n=20, tail=0)
    p = pc_t.build_preconditioner(torch.as_tensor(A), "Direct", bandwith=3)
    assert isinstance(p, la_t.LUPreconditioner) and p.initialized
    cfg = ProblemConfig(solver=SolverConfig(preconditioner_type="Direct", bandwith_preconditioner=True))
    with pytest.raises(ValueError, match="cannot be band-limited"):
        ProblemT(fac_t.create_sphere(refinements=0), from_dict(dataclasses.asdict(cfg)), device="cpu")


FRAME_CASES = {
    "Jacobi": dict(preconditioner_type="Jacobi"),
    "SOR": dict(preconditioner_type="SOR"),
    "SSOR": dict(preconditioner_type="SSOR"),
    "ILU": dict(preconditioner_type="ILU"),
    "AMG": dict(preconditioner_type="AMG"),
    "SSOR_band": dict(preconditioner_type="SSOR", bandwith_preconditioner=True, bandwith=20),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_problem_frame_matches_jax(case):
    """Two frames (the second a rigid motion of the first): the
    preconditioner is rebuilt from each frame's matrix, iterations equal."""
    cfg = ProblemConfig(
        grid_type="ImposedVelocity", imposed_component=0, solver=SolverConfig(**FRAME_CASES[case])
    )
    pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
    pt = ProblemT(fac_t.create_sphere(refinements=2), from_dict(dataclasses.asdict(cfg)), device="cpu")
    e0 = np.asarray(pj.initial_euler())
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    for e in (e0, e0 @ R.T + np.array([0.3, -0.1, 0.2])):
        rj = pj.solve_frame(jnp.asarray(e), jnp.zeros(3 * pj.n))
        rt = result_to_numpy(pt.solve_frame(e, np.zeros(3 * pt.n)))
        assert rt["iterations"] == rj["iterations"] > 1
        assert rt["converged"] and rj["converged"]
        assert not rt["refactored"]
        for key in ("rigid_velocities", "rigid_forces_pole", "stokes_forces"):
            assert _rel(rj[key], rt[key]) <= 1e-10, key
