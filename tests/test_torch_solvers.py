"""The port's GMRES and LU (pre)conditioner against the JAX package's on a
seeded diagonally-dominant system, f64: the same iteration counts and the
same solutions to 1e-12 (relative); the two packages run the same
arithmetic (MGS, Givens, true-residual restarts) in different loops."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bemstokes_tpu.la import direct as direct_j
from bemstokes_tpu.la.gmres import gmres as gmres_j
from bemstokes_tpu_torch.la import direct as direct_t
from bemstokes_tpu_torch.la.gmres import gmres as gmres_t
import torch_threads  # noqa: F401  (one torch thread a test process)

N = 60


def _system(seed=0, n=N):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) / np.sqrt(n) + 3.0 * np.eye(n)
    b = rng.normal(size=n)
    return A, b


def _solve_both(A, b, precond_j=None, precond_t=None, **kw):
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    xj, ij = gmres_j(lambda v: Aj @ v, bj, precond=precond_j, **kw)
    xt, it = gmres_t(lambda v: At @ v, bt, precond=precond_t, **kw)
    return np.asarray(xj), int(ij["iterations"]), float(ij["residual"]), xt.numpy(), it


@pytest.mark.parametrize(
    "restart,max_restarts,tol",
    [(100, 1, 1e-10), (8, 20, 1e-10), (5, 3, 1e-12), (30, 2, 1e-6)],
)
def test_gmres_unpreconditioned_matches_jax(restart, max_restarts, tol):
    A, b = _system()
    xj, ij, rj, xt, it = _solve_both(A, b, restart=restart, max_restarts=max_restarts, tol=tol)
    assert it["iterations"] == ij
    assert np.max(np.abs(xj - xt)) <= 1e-12 * np.max(np.abs(xj))
    assert abs(float(it["residual"]) - rj) <= 1e-12 * np.linalg.norm(b)


def test_gmres_zero_rhs():
    A, _ = _system()
    x, info = gmres_t(lambda v: torch.as_tensor(A) @ v, torch.zeros(N, dtype=torch.float64))
    assert info["iterations"] == 0 and float(torch.abs(x).max()) == 0.0


@pytest.mark.parametrize("perturb", [0.0, 0.05, 0.3])
def test_gmres_with_stale_lu_matches_jax(perturb):
    """Right preconditioning with the LU of a perturbed matrix (the stale-LU
    situation of the frame loop): exact LU -> 1 iteration, staler -> more."""
    A, b = _system(seed=1)
    rng = np.random.default_rng(2)
    A_old = A + perturb * rng.normal(size=A.shape) / np.sqrt(N)
    fj = direct_j.lu_factor_dense(jnp.asarray(A_old))
    ft = direct_t.lu_factor_dense(torch.as_tensor(A_old))
    xj, ij, _, xt, it = _solve_both(
        A,
        b,
        precond_j=lambda v: direct_j.lu_solve_dense(fj, v),
        precond_t=lambda v: direct_t.lu_solve_dense(ft, v),
        restart=100,
        max_restarts=10,
        tol=1e-10,
    )
    assert it["iterations"] == ij
    if perturb == 0.0:
        assert ij == 1
    assert np.max(np.abs(xj - xt)) <= 1e-12 * np.max(np.abs(xj))


@pytest.mark.parametrize("ncols", [None, 3])
def test_lu_factor_solve_matches_jax(ncols):
    A, b = _system(seed=3)
    if ncols:
        b = np.random.default_rng(4).normal(size=(N, ncols))
    xj = np.asarray(direct_j.lu_solve_dense(direct_j.lu_factor_dense(jnp.asarray(A)), jnp.asarray(b)))
    xt = direct_t.lu_solve_dense(direct_t.lu_factor_dense(torch.as_tensor(A)), torch.as_tensor(b)).numpy()
    assert xt.shape == b.shape
    assert np.max(np.abs(xj - xt)) <= 1e-12 * np.max(np.abs(xj))


def test_lu_preconditioner_refactor_trigger():
    """The stale-reuse rule: factor on first use, reuse while the last solve
    took at most `refactor_iteration_trigger` iterations, refactor past it —
    the same decisions as the JAX LUPreconditioner."""
    A, b = _system(seed=5)
    A2 = A + 0.1 * np.eye(N)
    pj = direct_j.LUPreconditioner(refactor_iteration_trigger=10)
    pt = direct_t.LUPreconditioner(refactor_iteration_trigger=10)
    assert not pt.initialized
    with pytest.raises(RuntimeError):
        pt.apply(torch.as_tensor(b))
    decisions = []
    for mat, last in ((A, 0), (A2, 10), (A2, 11), (A, 3)):
        dj = pj.maybe_refactor(jnp.asarray(mat), last)
        dt = pt.maybe_refactor(torch.as_tensor(mat), last)
        assert dj == dt
        decisions.append(dt)
        yj = np.asarray(pj.apply(jnp.asarray(b)))
        yt = pt.apply(torch.as_tensor(b)).numpy()
        assert np.max(np.abs(yj - yt)) <= 1e-12 * np.max(np.abs(yj))
    assert decisions == [True, False, True, False]


def test_lu_preconditioner_float32_factors():
    """factor_dtype=float32: f32 factors applied to (and cast back for) an
    f64 vector; agrees with JAX to f32 rounding (1e-5 relative)."""
    A, b = _system(seed=6)
    pj = direct_j.LUPreconditioner(factor_dtype=jnp.float32)
    pt = direct_t.LUPreconditioner(factor_dtype=torch.float32)
    pj.set_up(jnp.asarray(A))
    pt.set_up(torch.as_tensor(A))
    assert pt._factors[0].dtype == torch.float32
    yt = pt.apply(torch.as_tensor(b))
    assert yt.dtype == torch.float64
    yj = np.asarray(pj.apply(jnp.asarray(b)))
    assert np.max(np.abs(yj - yt.numpy())) <= 1e-5 * np.max(np.abs(yj))


def _pivoting_matrix(seed, n=N):
    """A nonsymmetric matrix whose LU swaps rows: no diagonal dominance."""
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, n)))


@pytest.mark.parametrize("refactor", [False, True], ids=["first", "refactored"])
@pytest.mark.parametrize("vector", ["fresh", "row_view"])
@pytest.mark.parametrize("factor_dtype", [None, torch.float32], ids=["f64", "f32"])
def test_lu_preconditioner_apply_is_lu_solve_bit_for_bit(factor_dtype, vector, refactor):
    """The apply (the permutation kept from the factorization, one gather,
    two triangular solves) gives `torch.linalg.lu_solve`'s bits, also after
    a refactor onto a matrix with other pivots."""
    pt = direct_t.LUPreconditioner(refactor_iteration_trigger=10, factor_dtype=factor_dtype)
    A, A2 = _pivoting_matrix(7), _pivoting_matrix(8)
    assert pt.maybe_refactor(A, 0)
    first = pt._perm
    if refactor:
        assert pt.maybe_refactor(A2, 11)
        assert not torch.equal(pt._perm, first)
    lu, piv = pt._factors
    assert not torch.equal(piv, torch.arange(1, N + 1, dtype=piv.dtype))
    V = torch.as_tensor(np.random.default_rng(9).normal(size=(3, N)))
    v = V[1] if vector == "row_view" else V[1].clone()
    y = pt.apply(v)
    ref = torch.linalg.lu_solve(lu, piv, v.to(lu.dtype)[:, None])[:, 0].to(v.dtype)
    assert y.dtype == v.dtype == torch.float64
    assert torch.equal(y, ref)
    # the factor of the matrix it holds: a solve, not only the same bits
    M = (A2 if refactor else A).to(lu.dtype)
    res = torch.linalg.vector_norm(M @ y.to(lu.dtype) - v.to(lu.dtype))
    assert float(res) <= (1e-4 if factor_dtype else 1e-10) * float(torch.linalg.vector_norm(v))


@pytest.mark.parametrize("n", [1, 2, 7, N])
def test_pivots_to_permutation_matches_lu_unpack(n):
    """(P^T A)[i] = A[p[i]] for torch.lu_unpack's P, without forming P."""
    lu, piv = torch.linalg.lu_factor(_pivoting_matrix(10 + n, n))
    P, _, _ = torch.lu_unpack(lu, piv)
    perm = direct_t.pivots_to_permutation(piv)
    assert perm.dtype == torch.long and sorted(perm.tolist()) == list(range(n))
    assert torch.equal(P.T, torch.eye(n, dtype=P.dtype)[perm])
