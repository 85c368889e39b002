"""`bemstokes_tpu_torch/postprocess.py` against the JAX package's
`bemstokes_tpu/postprocess.py`, f64, on create_sphere(2) (98 nodes, 96
panels) built in code, for each Green's function (free space, the free
surface and the no-slip wall at y = -2), and in 2D (free space) on the
10-cell clockwise circle refined twice (40 nodes).

The same seeded numpy boundary fields and evaluation points go through both
packages' evaluators with each package's own assembly tables.  Tolerance
1e-12 relative to the largest value (the two packages contract the same
terms in different orders; on the boundary the port sums only the
coinciding panels' singular rules, where the JAX package weights every
panel by 0 or 1).  The physics check: a translating sphere solved by the
port reproduces the exact Stokes flow at exterior points within the error
the JAX package's own field has at this size (1.3e-2)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.postprocess as pp_j
from bemstokes_tpu.config import ProblemConfig, SolverConfig, WallConfig
from bemstokes_tpu.fem.geometry import support_points as support_points_j
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.postprocess as pp_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.fem.geometry import support_points as support_points_t
from bemstokes_tpu_torch.physics.rigid import flatten
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-12
KERNELS = ("free_space", "free_surface", "no_slip")
#: the free-space kernel in 2D, on the 10-cell clockwise circle refined
#: twice (40 nodes)
CIRCLE = "circle"


def _cfg(kernel, **kw):
    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        no_slip_kernel=kernel == "no_slip",
        reflect_kernel=kernel == "free_surface",
        walls=(WallConfig(enabled=False, position=(0.0, -2.0, 0.0), span=(10.0, 0.0, 10.0)),),
        **kw,
    )


def _circle_problems():
    from bemstokes_tpu.mesh.refine import SphericalManifold as CircleJ, refine_uniform as refine_j
    from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
    from bemstokes_tpu_torch.mesh.refine import SphericalManifold as CircleT, refine_uniform as refine_t
    from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh as MeshT

    th = -2.0 * np.pi * np.arange(10) / 10
    verts = np.stack([np.cos(th), np.sin(th)], axis=1)
    cells = np.stack([np.arange(10), (np.arange(10) + 1) % 10], axis=1)
    cfg = ProblemConfig(dim=2, grid_type="ImposedVelocity", imposed_component=2)
    mesh_j = refine_j(MeshJ(verts, cells, np.zeros(10, np.int32)), CircleJ((0.0, 0.0)), times=2)
    mesh_t = refine_t(MeshT(verts, cells, np.zeros(10, np.int32)), CircleT((0.0, 0.0)), times=2)
    return ProblemJ(mesh_j, cfg), ProblemT(mesh_t, from_dict(dataclasses.asdict(cfg)), device="cpu")


@pytest.fixture(scope="module", params=KERNELS + (CIRCLE,))
def pair(request):
    """(kernel, JAX problem, port problem, euler, seeded u and f) on
    create_sphere(2), or on the circle."""
    if request.param == CIRCLE:
        pj, pt = _circle_problems()
    else:
        cfg = _cfg(request.param)
        pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
        pt = ProblemT(fac_t.create_sphere(refinements=2), from_dict(dataclasses.asdict(cfg)), device="cpu")
    euler = np.asarray(pj.initial_euler())
    rng = np.random.default_rng(7)
    u = rng.normal(size=pj.dim * pj.n)
    f = rng.normal(size=pj.dim * pj.n)
    return request.param, pj, pt, euler, u, f


def _close(a_j, a_t, tol=TOL):
    a_j = np.asarray(a_j)
    a_t = a_t.numpy() if isinstance(a_t, torch.Tensor) else np.asarray(a_t)
    assert a_j.shape == a_t.shape
    err = np.max(np.abs(a_j - a_t)) / np.max(np.abs(a_j))
    assert err <= tol, err


def _exterior_points(n, seed=3, r=(1.3, 3.0), dim=3):
    """Seeded points in a spherical shell around the unit sphere (an annulus
    around the unit circle with `dim=2`), above the wall plane y = -2."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, dim))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * rng.uniform(*r, size=(n, 1))
    pts[:, 1] = np.maximum(pts[:, 1], -1.5)
    return pts


def test_off_boundary_matches_jax(pair):
    kernel, pj, pt, euler, u, f = pair
    pts = _exterior_points(12, dim=pj.dim)
    out_j = pp_j.evaluate_stokes_bie(jnp.asarray(pts), jnp.asarray(u), jnp.asarray(f), jnp.asarray(euler), pj.tables)
    out_t = pp_t.evaluate_stokes_bie(
        pts, torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(euler), pt.tables
    )
    _close(out_j, out_t)


def test_kernels_at_match_jax(pair):
    kernel, pj, pt, euler, u, f = pair
    pts = _exterior_points(3, seed=5, dim=pj.dim)
    xq = np.random.default_rng(1).normal(size=(4, 5, pj.dim)) * 2.0
    G_j, W_j = pp_j._kernels_at(pj.tables.cfg, jnp.asarray(pts), jnp.asarray(xq))
    G_t, W_t = pp_t._kernels_at(pt.tables.cfg, torch.as_tensor(pts), torch.as_tensor(xq))
    _close(G_j, G_t, 1e-13)
    _close(W_j, W_t, 1e-13)


def test_on_boundary_matches_jax(pair):
    """Every fourth support point (on the boundary) and two points off it.

    On the circle the JAX package's evaluator cannot run: it forms the
    singular panels' normals by a 3D cross product alone
    (`bemstokes_tpu/postprocess.py:172`).  There the port is held to what
    the same rules give through the assembly instead: at a support point
    the field is the row of V f + K u of the uncorrected operators (the
    smooth rule off the point's panels, their singular rules on them), and
    off the boundary it is `evaluate_stokes_bie`.  To 1e-9: the singular
    rules' first points lie ~1e-6 from their node, where p . n cancels to
    O(r^2), and the assembly contracts W with the normal in another order
    (measured 1.05e-10 on the K side, 1.7e-15 on the V side)."""
    kernel, pj, pt, euler, u, f = pair
    sp_j = support_points_j(jnp.asarray(euler), pj.map_space, pj.fe_space)
    sp_t = support_points_t(torch.as_tensor(euler), pt.map_space, pt.fe_space)
    pts = np.concatenate([np.asarray(sp_j)[::4], _exterior_points(2, seed=11, dim=pj.dim)])
    out_t = pp_t.evaluate_stokes_bie_on_boundary(
        pts, torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(euler), sp_t, pt.tables
    )
    if kernel == CIRCLE:
        from bemstokes_tpu_torch.ops.assemble import assemble_V_K

        V, K = assemble_V_K(torch.as_tensor(euler), sp_t, pt.tables)
        rows = (V @ torch.as_tensor(f) + K @ torch.as_tensor(u)).reshape(2, -1).T[::4]
        off = pp_t.evaluate_stokes_bie(pts[-2:], torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(euler), pt.tables)
        _close(torch.cat([rows, off]).numpy(), out_t, 1e-9)
        return
    out_j = pp_j.evaluate_stokes_bie_on_boundary(
        jnp.asarray(pts), jnp.asarray(u), jnp.asarray(f), jnp.asarray(euler), sp_j, pj.tables
    )
    _close(out_j, out_t)


def test_velocity_gradient_and_stress_match_jax(pair):
    kernel, pj, pt, euler, u, f = pair
    pts = _exterior_points(3, seed=13, dim=pj.dim)
    g_j = pp_j.approximate_velocity_gradient(
        jnp.asarray(pts), jnp.asarray(u), jnp.asarray(f), jnp.asarray(euler), pj.tables, h=1e-4
    )
    g_t = pp_t.approximate_velocity_gradient(
        pts, torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(euler), pt.tables, h=1e-4
    )
    # a central difference divides the evaluation's rounding by 2h
    _close(g_j, g_t, 1e-9)
    _close(pp_j.cauchy_viscous_stress(g_j, mu=2.0), pp_t.cauchy_viscous_stress(g_t, mu=2.0), 1e-9)


def test_chunks_change_no_result(pair, monkeypatch):
    """One point a chunk gives the result of one chunk for all points."""
    kernel, pj, pt, euler, u, f = pair
    pts = _exterior_points(5, seed=17, dim=pj.dim)
    args = (torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(euler), pt.tables)
    whole = pp_t.make_bie_evaluator(pt.tables)(pts, *args[:3])
    monkeypatch.setattr(pp_t, "CHUNK_BYTES", 1)
    assert pp_t.points_per_chunk(16, 3, torch.float64) == 1
    torch.testing.assert_close(pp_t.evaluate_stokes_bie(pts, *args), whole, rtol=1e-14, atol=0)


@pytest.fixture(scope="module")
def solved_sphere():
    """The unit sphere translating along x, solved by both packages on
    create_sphere(2) with a direct solve."""
    cfg = _cfg("free_space", force_pole="Origin", solver=SolverConfig(solve_directly=True))
    pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
    pt = ProblemT(fac_t.create_sphere(refinements=2), from_dict(dataclasses.asdict(cfg)), device="cpu")
    euler = np.asarray(pj.initial_euler())
    rj = pj.solve_frame(jnp.asarray(euler), jnp.zeros(3 * pj.n))
    rt = result_to_numpy(pt.solve_frame(euler, np.zeros(3 * pt.n)))
    return pj, pt, euler, rj, rt


def _exact_translating_sphere(x, U):
    """Stokes flow past a unit sphere translating with velocity U."""
    r = np.linalg.norm(x, axis=1, keepdims=True)
    Ux = (x @ U)[:, None]
    return 0.75 * (U / r + Ux * x / r**3) + 0.25 * (U / r**3 - 3 * Ux * x / r**5)


def test_translating_sphere_field(solved_sphere):
    pj, pt, euler, rj, rt = solved_sphere
    U = rt["rigid_velocities"][:3]
    u_b = np.zeros((pt.n, 3))
    u_b[:] = U
    pts = _exterior_points(5, seed=19, r=(1.2, 4.0))
    u_t = pp_t.evaluate_stokes_bie(
        pts, flatten(torch.as_tensor(u_b)), torch.as_tensor(rt["stokes_forces"]), torch.as_tensor(euler), pt.tables
    ).numpy()
    u_j = pp_j.evaluate_stokes_bie(
        jnp.asarray(pts), jnp.asarray(flatten(torch.as_tensor(u_b)).numpy()), rj["stokes_forces"], jnp.asarray(euler), pj.tables
    )
    _close(u_j, u_t, 1e-10)
    exact = _exact_translating_sphere(pts, U)
    rel = np.linalg.norm(u_t - exact, axis=1) / np.linalg.norm(exact, axis=1)
    assert rel.max() <= 1.3e-2, rel
    # the single layer of the normal vanishes off the surface
    n_flat = flatten(torch.as_tensor(rt["operators"]["normal"]["normal"]))
    zero = torch.zeros_like(n_flat)
    far = pp_t.evaluate_stokes_bie([[0.1, 0.1, 0.1], [4.0, 4.0, 4.0]], zero, n_flat, torch.as_tensor(euler), pt.tables)
    assert far.abs().max() < 1e-2, far
    grad = pp_t.approximate_velocity_gradient(
        pts[:2], flatten(torch.as_tensor(u_b)), torch.as_tensor(rt["stokes_forces"]), torch.as_tensor(euler), pt.tables
    )
    assert torch.diagonal(grad, dim1=-2, dim2=-1).sum(-1).abs().max() < 1e-6


def test_sharded_evaluation_names_its_roadmap_item():
    """This raised while the distributed path waited for its module (the
    test keeps its name): `sharded_evaluate_stokes_bie` on a row mesh of one
    rank (a gloo group of one in this process) against the JAX package's on
    three devices, create_sphere(2) in free space, 37 points (not a
    multiple of 3), 1e-12; its ranks in a group of two:
    tests/test_torch_parallel_swimmer.py."""
    import torch.distributed as dist
    from bemstokes_tpu.parallel import row_mesh as row_mesh_j
    from bemstokes_tpu_torch.parallel import row_mesh

    cfg = _cfg("free_space")
    pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
    pt = ProblemT(fac_t.create_sphere(refinements=2), from_dict(dataclasses.asdict(cfg)), device="cpu")
    euler = np.array(pj.initial_euler())
    rng = np.random.default_rng(7)
    u, f = rng.normal(size=3 * pj.n), rng.normal(size=3 * pj.n)
    pts = _exterior_points(37)
    ref = np.asarray(
        pp_j.sharded_evaluate_stokes_bie(
            jnp.asarray(pts), jnp.asarray(u), jnp.asarray(f), jnp.asarray(euler), pj.tables, row_mesh_j(3)
        )
    )
    created = not dist.is_initialized()
    mesh = row_mesh(device="cpu")
    got = pp_t.sharded_evaluate_stokes_bie(
        pts, torch.as_tensor(u), torch.as_tensor(f), torch.as_tensor(euler), pt.tables, mesh
    )
    if created:
        dist.destroy_process_group()
    assert got.shape == (37, pj.dim)
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()
