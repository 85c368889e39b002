"""The slab helpers and the slab LU of the port's distributed path
(`bemstokes_tpu_torch/parallel/sharded.py`, `lu.py` and the slab helpers of
`solve.py`) in a gloo group of W processes on the CPU, against the JAX
package's (`bemstokes_tpu/parallel/`) on `row_mesh(W)` at the same W, on
the same seeded inputs.

n = 37 nodes, d = 3 (n not divisible by W, as in tests/test_sharded_solve.py
and tests/test_sharded_lu.py), the padded rows of the input slabs filled
with seeded junk that the reorder must replace.  Each rank's piece is held
against its rows of the JAX package's global slab arrays:

- the layouts (flat -> slab, the round trip), the reordered matrix, the
  hanging-node rows, the diagonal: exactly;
- the LU factors (1e-12 of max|A|) and the block-local permutation
  (exactly), the solve against numpy's (1e-10, as tests/test_sharded_lu.py;
  one and two right-hand sides) and JAX's (1e-12 relative);
- the three matvecs and the solid-angle correction, plain and per component
  with the internal alpha, with its check: 1e-12 relative.

Block-Jacobi at W = 2 (rank 1 holds one padded node): rank 0's factors equal
the JAX package's; on rank 1 the port factors the block of its own nodes'
columns, where the JAX package's clamped `dynamic_slice` takes the columns
one node to the left (ROADMAP.md queue 3), both held against numpy.
"""

import numpy as np
import pytest
import torch

from bemstokes_tpu_torch.mesh.constraints import HangingConstraints
from bemstokes_tpu_torch.parallel import lu, sharded, solve
from torch_dist_group import Group
import torch_threads  # noqa: F401  (one torch thread a test process)

N, D = 37, 3
RELTOL = 1e-12


def _inputs(world):
    rng = np.random.default_rng(0)
    dn = D * N
    A = rng.standard_normal((dn, dn)) + 4.0 * np.eye(dn)
    K = rng.standard_normal((dn, dn))
    b = rng.standard_normal(dn)
    x = rng.standard_normal(dn)
    nloc = -(-N // world)
    m = D * nloc
    s = np.arange(world * m)
    node = (s // m) * nloc + (s % m) % nloc
    comp = (s % m) // nloc
    valid = node < N
    A_slab = rng.standard_normal((world * m, dn))  # junk padded rows
    K_slab = rng.standard_normal((world * m, dn))
    A_slab[valid] = A[comp[valid] * N + node[valid]]
    K_slab[valid] = K[comp[valid] * N + node[valid]]
    labels = (np.arange(N) >= 20).astype(np.int32)
    return dict(
        A=A,
        b=b,
        x=x,
        A_slab=A_slab,
        K_slab=K_slab,
        m=m,
        labels=labels,
        alpha=np.where(labels == 0, 1.0, 0.5),
        slaves=np.array([3, 17, 36], dtype=np.int32),
        masters=np.array([[0, 1], [5, 6], [30, 31]], dtype=np.int32),
        weights=np.array([[0.5, 0.5], [0.25, 0.75], [0.6, 0.4]]),
    )


# ---- the ranks (child processes) --------------------------------------------


def slab_ops(mesh):
    inp = _inputs(mesh.world)
    m, r = inp["m"], mesh.rank
    rows = slice(r * m, (r + 1) * m)
    A_loc = torch.as_tensor(inp["A_slab"][rows])
    K_loc = torch.as_tensor(inp["K_slab"][rows])
    b, x = torch.as_tensor(inp["b"]), torch.as_tensor(inp["x"])
    out = dict(
        slab=sharded.flat_to_slab(b, N, D, mesh),
        roundtrip=sharded.slab_to_flat(sharded.flat_to_slab(b, N, D, mesh), N, D, mesh),
        padded=sharded.padded_rows(N, mesh),
    )
    A2 = lu.slab_reorder_columns(A_loc, N, D, mesh)
    out["A2"] = A2.clone()
    LU, perm, plan = lu.slab_lu_factor(A2.clone(), mesh)
    out.update(LU=LU, perm=perm)
    out["solve"] = sharded.slab_to_flat(
        lu.slab_lu_solve(LU, perm, sharded.flat_to_slab(b, N, D, mesh), mesh, plan), N, D, mesh
    )
    bx = torch.stack([b, x], dim=1)
    out["solve2"] = sharded.slab_to_flat(
        lu.slab_lu_solve(LU, perm, sharded.flat_to_slab(bx, N, D, mesh), mesh, plan), N, D, mesh
    )
    out["mv"] = sharded.sharded_matvec(A_loc, x, mesh)
    out["mv_gathered"] = sharded.sharded_matvec_gathered(A_loc, x, mesh)
    out["mv_ring"] = sharded.sharded_matvec_ring(A2, sharded.flat_to_slab(x, N, D, mesh), mesh)
    out["K_corr"], out["check"] = solve.slab_solid_angle_correction(
        K_loc.clone(), N, D, mesh, return_check=True
    )
    out["K_corr_lab"], out["check_lab"] = solve.slab_solid_angle_correction(
        K_loc.clone(),
        N,
        D,
        mesh,
        use_internal_alpha=True,
        component_labels=inp["labels"],
        component_alpha=inp["alpha"],
        return_check=True,
    )
    hc = HangingConstraints(inp["slaves"], inp["masters"], inp["weights"])
    out["A_hc"] = solve.slab_apply_hanging_constraints(A_loc.clone(), hc, N, D, mesh)
    out["diag"] = solve.slab_diagonal(A_loc, N, D, mesh)
    return out


def block_jacobi(mesh):
    inp = _inputs(mesh.world)
    m, r = inp["m"], mesh.rank
    A_loc = torch.as_tensor(inp["A_slab"][r * m : (r + 1) * m])
    lu_loc, piv = solve.slab_block_jacobi_lu(A_loc, None, N, D, 6, mesh)
    v = sharded.flat_to_slab(torch.as_tensor(inp["b"]), N, D, mesh)
    return dict(lu=lu_loc, piv=piv, apply=solve.slab_block_jacobi_apply(lu_loc, piv, v, mesh))


# ---- the JAX package (this process) -----------------------------------------


def _jax_slab_ops(world):
    import jax.numpy as jnp

    from bemstokes_tpu.mesh.constraints import HangingConstraints as HcJ
    from bemstokes_tpu.parallel import lu as lu_j, sharded as sh_j, solve as so_j

    inp = _inputs(world)
    mesh = sh_j.row_mesh(world)
    A_slab, K_slab = jnp.asarray(inp["A_slab"]), jnp.asarray(inp["K_slab"])
    b, x = jnp.asarray(inp["b"]), jnp.asarray(inp["x"])
    out = dict(slab=sh_j.flat_to_slab(b, N, D, mesh), padded=sh_j.padded_rows(N, mesh))
    out["roundtrip"] = sh_j.slab_to_flat(out["slab"], N, D, mesh)
    A2 = lu_j.slab_reorder_columns(A_slab, N, D, mesh)
    LU, perm = lu_j.slab_lu_factor(A2, mesh)
    out.update(A2=A2, LU=LU, perm=perm)
    out["solve"] = sh_j.slab_to_flat(lu_j.slab_lu_solve(LU, perm, out["slab"], mesh), N, D, mesh)
    out["mv"] = sh_j.sharded_matvec(A_slab, x, mesh)
    out["mv_gathered"] = sh_j.sharded_matvec_gathered(A_slab, x, mesh)
    out["mv_ring"] = sh_j.sharded_matvec_ring(A2, sh_j.flat_to_slab(x, N, D, mesh), mesh)
    out["K_corr"], out["check"] = so_j.slab_solid_angle_correction(
        K_slab, N, D, mesh, return_check=True
    )
    out["K_corr_lab"], out["check_lab"] = so_j.slab_solid_angle_correction(
        K_slab,
        N,
        D,
        mesh,
        use_internal_alpha=True,
        component_labels=inp["labels"],
        component_alpha=inp["alpha"],
        return_check=True,
    )
    hc = HcJ(inp["slaves"], inp["masters"], inp["weights"])
    out["A_hc"] = so_j.slab_apply_hanging_constraints(A_slab, hc, N, D, mesh)
    out["diag"] = so_j.slab_diagonal(A_slab, N, D, mesh)
    return {k: (v if k == "padded" else np.asarray(v)) for k, v in out.items()}


def _jax_block_jacobi(world):
    import jax.numpy as jnp

    from bemstokes_tpu.parallel import sharded as sh_j, solve as so_j

    inp = _inputs(world)
    mesh = sh_j.row_mesh(world)
    lu_j, piv_j = so_j.slab_block_jacobi_lu(jnp.asarray(inp["A_slab"]), None, N, D, 6, mesh)
    v = sh_j.flat_to_slab(jnp.asarray(inp["b"]), N, D, mesh)
    app = so_j.slab_block_jacobi_apply(lu_j, piv_j, v, mesh)
    return np.asarray(lu_j), np.asarray(piv_j), np.asarray(app)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks at W = 4 and W = 2 (started first, so that they run
    while this process computes the JAX package's results), and JAX's."""
    g4 = Group(__name__, "slab_ops", 4, tmp_path_factory.mktemp("w4"))
    g2 = Group(__name__, "block_jacobi", 2, tmp_path_factory.mktemp("w2"))
    jax4 = _jax_slab_ops(4)
    jax2 = _jax_block_jacobi(2)
    return g4.results(), jax4, g2.results(), jax2


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / max(np.abs(_np(b)).max(), 1e-300)


def _pieces(port, key):
    return np.concatenate([_np(p[key]) for p in port])


@pytest.mark.parametrize("key", ["slab", "A2", "A_hc", "diag", "perm"])
def test_slab_pieces_equal_jax(runs, key):
    """Rank k's piece is rows [k m, (k + 1) m) of the JAX package's global
    slab array, exactly."""
    port, jx = runs[0], runs[1]
    assert np.array_equal(_pieces(port, key), jx[key])


@pytest.mark.parametrize("key", ["roundtrip", "mv_gathered", "check", "check_lab", "solve"])
def test_replicated_values_equal_jax(runs, key):
    """Replicated results are the same on every rank and equal JAX's."""
    port, jx = runs[0], runs[1]
    for p in port:
        assert np.array_equal(_np(p[key]), _np(port[0][key]))
    if key == "roundtrip":
        assert np.array_equal(_np(port[0][key]), jx[key])
        assert np.array_equal(_np(port[0][key]), _inputs(4)["b"])
    else:
        assert _rel(port[0][key], jx[key]) <= RELTOL, key


@pytest.mark.parametrize("key", ["mv", "mv_ring", "K_corr", "K_corr_lab"])
def test_slab_products_match_jax(runs, key):
    port, jx = runs[0], runs[1]
    assert _rel(_pieces(port, key), jx[key]) <= RELTOL


def test_slab_lu_matches_jax_and_numpy(runs):
    """The blocked LU at W = 4: factors within 1e-12 of max|A| of the JAX
    package's, the same permutation, and a solve equal to numpy's."""
    port, jx = runs[0], runs[1]
    inp = _inputs(4)
    assert [tuple(p["padded"]) for p in port] == [tuple(jx["padded"])] * 4 == [(40, 10)] * 4
    assert np.abs(_pieces(port, "LU") - jx["LU"]).max() <= 1e-12 * np.abs(inp["A"]).max()
    exact = np.linalg.solve(inp["A"], inp["b"])
    assert np.abs(_np(port[0]["solve"]) - exact).max() < 1e-10
    # two right-hand sides at once (the Schur columns of the Direct step)
    exact2 = np.linalg.solve(inp["A"], np.stack([inp["b"], inp["x"]], axis=1))
    assert np.abs(_np(port[0]["solve2"]) - exact2).max() < 1e-10
    # the ring matvec of the slab-ordered matrix is the gathered matvec's
    nloc = 10
    ring = _pieces(port, "mv_ring")
    s = np.arange(4 * D * nloc)
    node = (s // (D * nloc)) * nloc + (s % (D * nloc)) % nloc
    valid = node < N
    flat = inp["A"] @ inp["x"]
    comp = (s % (D * nloc)) // nloc
    assert np.abs(ring[valid] - flat[comp[valid] * N + node[valid]]).max() <= 1e-12 * np.abs(flat).max()


def test_block_jacobi_own_block(runs):
    """Block-Jacobi at W = 2 on n = 37 (rank 1: 18 real nodes and a pad).
    Rank 0 equals the JAX package's factors and application; on rank 1 the
    port factors the columns of its own nodes, the JAX package those one
    node to the left."""
    port, (lu_j, piv_j, app_j) = runs[2], runs[3]
    inp = _inputs(2)
    nloc, m = 19, 57
    lu0 = _np(port[0]["lu"])
    assert np.abs(lu0 - lu_j[:m]).max() <= 1e-12 * np.abs(lu_j[:m]).max()
    assert np.array_equal(_np(port[0]["piv"]) - 1, piv_j[:m])
    assert _rel(port[0]["apply"], app_j[:m]) <= RELTOL

    def own_block(rank, shift):
        r0 = rank * nloc
        nr = min(nloc, N - r0)
        blk = np.eye(m)
        loc = (np.arange(D)[:, None] * nloc + np.arange(nr)).reshape(-1)
        cols = (np.arange(D)[:, None] * N + r0 - shift + np.arange(nr)).reshape(-1)
        blk[np.ix_(loc, loc)] = inp["A_slab"][rank * m + loc][:, cols]
        return blk

    v1 = np.zeros(m)
    loc1 = (np.arange(D)[:, None] * nloc + np.arange(18)).reshape(-1)
    v1[loc1] = inp["b"][(np.arange(D)[:, None] * N + nloc + np.arange(18)).reshape(-1)]
    intended = np.linalg.solve(own_block(1, 0), v1)
    clamped = np.linalg.solve(own_block(1, 1), v1)
    assert _rel(port[1]["apply"], intended) <= 1e-10
    assert _rel(app_j[m:], clamped) <= 1e-10
    assert _rel(app_j[m:], intended) > 1e-3
