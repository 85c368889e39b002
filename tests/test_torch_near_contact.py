"""Near contact on the port, f64 on the CPU, against the JAX package on the
same inputs: the twins of the JAX package's tests/test_near_contact.py
(which read a reference grid file absent here), on meshes built in code.

- a sphere approaching the Blake no-slip image wall against Brenner's exact
  perpendicular-drag series;
- quadrature auto-promotion (`problem.py`, `mesh/proximity.py`): it fires
  when the gap falls below the local panel diameter, and the promoted cheap
  far rule (order 2, near pairs at order 8 through the near-pair COO delta)
  recovers the uniform order-8 answer where the unpromoted order 2 does not;
- two co-moving spheres along their line of centres against Stimson and
  Jeffery's exact drag.

The series are copied from tests/test_near_contact.py.  The sphere is
create_sphere(2) (98 nodes, panel diameters 0.52-0.54) where the JAX tests
refine the reference's sphere once (diameters ~0.35), so the physical
bounds are this mesh's: the Brenner errors are set by the mesh (measured
2.18e-2, 3.61e-2, 1.035e-1 at H = 2, 1.5, 1.2; the bounds sit ~2x above, as
the JAX test's do over its own), and the promotion-recovery gap is H = 1.1
(image gap 0.2, 0.38 of a panel; the JAX test's 0.1 is 0.29 of its panels;
measured here: promoted order 2 7.7e-5 from order 8, unpromoted 3.8e-4;
at H = 1.05 the promoted rule is 1.45e-4 off).  Each solve runs in both packages from the same ProblemConfig
(`from_dict`) on the same mesh: the drag coefficient lambda and the rigid
forces to 1e-10 relative, `quadrature_promoted` equal.  The near-pair
selection meets exact distance ties on a symmetric sphere, which the JAX
package's jitted `lax.top_k` breaks otherwise than the port's stable sort:
every vertex is moved by a seeded 1e-6 jitter, which leaves no tie.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bemstokes_tpu.config import ProblemConfig, QuadratureConfig, SolverConfig, WallConfig
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.mesh.factories import create_body_in_code, create_sphere
from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-10


def brenner_lambda(H, terms=5000):
    """Sphere translating PERPENDICULAR to a rigid plane wall: exact drag
    correction F = 6 pi mu a U * lambda (Brenner 1961), H = center height /
    radius.  Exponentially-scaled terms (no overflow at large H)."""
    al = np.arccosh(np.float64(H))
    n = np.arange(1, terms + 1, dtype=np.float64)
    k = 2 * n + 1
    e = np.exp(-k * al)
    sha, sh2a = np.sinh(al), np.sinh(2 * al)
    num = (1 - e * e) + k * sh2a * e
    den = (1 - e) ** 2 - (k * sha) ** 2 * e
    return (
        (4.0 / 3.0)
        * sha
        * np.sum(n * (n + 1) / ((2 * n - 1) * (2 * n + 3)) * (num / den - 1))
    )


def stimson_jeffery_lambda(Hd, terms=5000):
    """Two equal spheres translating with EQUAL velocity along their line
    of centers: exact per-sphere drag correction (Stimson & Jeffery 1926),
    Hd = d / (2a) with d the center separation.  lambda -> 0.6452 at
    contact — the classical value."""
    al = np.arccosh(np.float64(Hd))
    n = np.arange(1, terms + 1, dtype=np.float64)
    k = 2 * n + 1
    e = np.exp(-k * al)
    sha, sh2a = np.sinh(al), np.sinh(2 * al)
    den = (1 - e * e) + k * sh2a * e
    num = (1 - e) ** 2 - (k * sha) ** 2 * e
    return (
        (4.0 / 3.0)
        * sha
        * np.sum(n * (n + 1) / ((2 * n - 1) * (2 * n + 3)) * (1.0 - num / den))
    )


def test_exact_series_sanity():
    """The truth curves themselves: free-space limits and lubrication /
    contact asymptotics."""
    assert abs(brenner_lambda(100.0) - 1.0) < 2e-2
    assert abs(brenner_lambda(1.001) * 0.001 - 1.0) < 5e-3
    assert abs(stimson_jeffery_lambda(50.0) - 1.0) < 2e-2
    assert abs(stimson_jeffery_lambda(1.0001) - 0.6452) < 1e-3


def jittered(mesh):
    """`mesh` with every vertex moved by a seeded 1e-6 jitter, as each
    package's SurfaceMesh."""
    v = mesh.vertices + 1e-6 * np.random.default_rng(3).standard_normal(mesh.vertices.shape)
    return (
        MeshJ(v, mesh.cells, mesh.material_id, mesh.flip_normal, mesh.edge_midpoints),
        SurfaceMesh(v, mesh.cells, mesh.material_id, mesh.flip_normal, mesh.edge_midpoints),
    )


def wall_config(H, quadrature=None):
    """The unit sphere moving toward the Blake image wall at y = -H."""
    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=1,
        force_pole="Origin",
        no_slip_kernel=True,
        body_manifold="sphere",
        walls=(WallConfig(enabled=False, position=(0.0, -H, 0.0), span=(10.0, 0.0, 10.0)),),
        quadrature=quadrature or QuadratureConfig(),
        solver=SolverConfig(preconditioner_type="Direct", tolerance=1e-10),
    )


def problems(mesh, cfg):
    """Both packages' problems of `cfg` on the jittered `mesh`, with equal
    promotion decisions."""
    mj, mt = jittered(mesh)
    cfg_t = from_dict(dataclasses.asdict(cfg))
    pj, pt = ProblemJ(mj, cfg), ProblemT(mt, cfg_t, device="cpu")
    assert pt.quadrature_promoted == pj.quadrature_promoted
    return pj, pt


def solve_lambda(pj, pt, component=1, n_bodies=1):
    """lambda = |F| / (n_bodies 6 pi) of one frame in each package, equal to
    1e-10; returns the port's."""
    rj = pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))
    rt = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
    for key in ("rigid_forces_pole", "stokes_forces"):
        a, b = np.asarray(rj[key]), rt[key]
        assert np.abs(a - b).max() <= TOL * np.abs(a).max(), key
    lam_j = abs(float(np.asarray(rj["rigid_forces_pole"])[component])) / (n_bodies * 6 * np.pi)
    lam_t = abs(float(rt["rigid_forces_pole"][component])) / (n_bodies * 6 * np.pi)
    assert abs(lam_t - lam_j) <= TOL * lam_j
    return lam_t


@pytest.mark.parametrize("H,tol", [(2.0, 4e-2), (1.5, 7e-2), (1.2, 2e-1)])
def test_wall_gap_sweep_vs_brenner(H, tol):
    """The perpendicular drag tracks Brenner's exact curve as the gap
    closes."""
    pj, pt = problems(create_sphere(refinements=2), wall_config(H))
    lam = solve_lambda(pj, pt)
    truth = brenner_lambda(H)
    assert abs(lam - truth) / truth < tol


def test_auto_promotion_trigger_and_recovery():
    """(a) The promotion fires exactly when the image gap 2 (H - 1) falls
    below the local panel diameter; (b) the promoted order-2 rule recovers
    the uniform order-8 answer to 1e-4, and the unpromoted order 2 is more
    than 3 times further from it."""
    mesh = create_sphere(refinements=2)
    pj, pt = problems(mesh, wall_config(2.0))
    assert not pt.quadrature_promoted
    H = 1.1
    plain = problems(mesh, wall_config(H, QuadratureConfig(order=2, auto_promote=False)))
    assert not plain[1].quadrature_promoted
    auto = problems(mesh, wall_config(H, QuadratureConfig(order=2, auto_promote=True, promote_boost=6)))
    assert auto[1].quadrature_promoted
    full = problems(mesh, wall_config(H, QuadratureConfig(order=8, auto_promote=False)))
    lam_plain, lam_auto, lam_full = (solve_lambda(*p) for p in (plain, auto, full))
    assert abs(lam_auto - lam_full) / lam_full < 1e-4
    assert abs(lam_plain - lam_full) > 3 * abs(lam_auto - lam_full)


@pytest.mark.parametrize("d,tol", [(3.0, 2e-2), (2.2, 2e-2)])
def test_two_sphere_approach_vs_stimson_jeffery(d, tol):
    """Two co-moving spheres along their line of centres against Stimson and
    Jeffery's exact drag; at d = 2.2 (gap 0.2) the quadrature promotes."""
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        build_sphere_in_code=True,
        internal_sphere_refinements=2,
        two_spheres=True,
        spheres_distance=d,
        solver=SolverConfig(preconditioner_type="Direct", tolerance=1e-10),
    )
    pj, pt = problems(create_body_in_code(from_dict(dataclasses.asdict(cfg))), cfg)
    if d <= 2.4:
        assert pt.quadrature_promoted
    lam = solve_lambda(pj, pt, component=0, n_bodies=2)
    truth = stimson_jeffery_lambda(d / 2.0)
    assert abs(lam - truth) / truth < tol
