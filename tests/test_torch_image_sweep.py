"""K2 and K3, the image node sweeps (`bemstokes_tpu_torch/ops/node_kernel.py`
with kernel="free_surface" / "no_slip"), and the image branches of the
port's assembly.

On the CPU (f64):
- the plain version against a per-pair numpy evaluation of the image
  Green's functions written out term by term (1e-13 relative to max|V|,
  max|K|), with an exact r^2 = 0 pair, zero-weight padding and ragged tiles;
- the port's `assemble_V_K` on create_sphere(2) above a wall at y = -2
  against the JAX package's Pallas node kernel in interpret mode and against
  its gather path (atol 1e-11, the node-vs-gather class of
  tests/test_pallas_assemble.py:41-70);
- the singular and near COO triplets with images (atol 1e-13), and the
  `wall_image_gap` auto-promotion.

On a card (marker `cuda`): the CUDA kernels against their plain version,
relative to max|V| and max|K|: 1e-12 in f64; 1e-5 in f32 at these
create_sphere(3) shapes (the kernels take every inverse power from one rsqrt
where the plain version divides by integer powers of a square root, and sum
in another order; on an NVIDIA H100 the no-slip K differs by 2.0e-6 here).

Run the card tests with `python3 -m pytest tests/test_torch_image_sweep.py
-m cuda` on a machine with a CUDA card and nvcc.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.ops.assemble as asm_j
from bemstokes_tpu.config import ProblemConfig, WallConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.fem.geometry as geo_t
import bemstokes_tpu_torch.mesh.dofs as dofs_t
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.ops.assemble as asm_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.ops import node_kernel
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT
import torch_threads  # noqa: F401  (one torch thread a test process)

KERNELS = ["free_surface", "no_slip"]
WALL = -2.0


def _random_inputs(wall_axis, nr=7, n=5, m=6, seed=0, dtype=torch.float64):
    """Rows and samples above the wall x[wall_axis] = WALL."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(nr, 3))
    Y = rng.normal(size=(n, m, 3))
    xi[:, wall_axis] = np.abs(xi[:, wall_axis]) + WALL + 0.3
    Y[..., wall_axis] = np.abs(Y[..., wall_axis]) + WALL + 0.3
    N = rng.normal(size=(n, m, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    W = rng.uniform(size=(n, m))
    W[:, -1] = 0.0  # incidence padding
    xi[2] = Y[3, 1]  # an exact r^2 = 0 pair
    return [torch.as_tensor(a, dtype=dtype) for a in (xi, Y, N, W)]


def _G0(p):
    r = math.sqrt(p @ p)
    return np.eye(3) / r + np.outer(p, p) / r**3


def _pair_G_Wn(kernel, w, p, pI, nrm):
    """(G, W.n) of one pair, written out term by term from the formulas in
    the docstrings of kernels/images.py."""
    e_w = np.eye(3)[w]
    s = np.where(np.arange(3) == w, -1.0, 1.0)  # -1 on the wall-normal row
    r, rI = math.sqrt(p @ p), math.sqrt(pI @ pI)
    pn, pIn = p @ nrm, pI @ nrm
    if kernel == "free_surface":
        G = (_G0(p) + s[:, None] * _G0(pI)) / (8 * math.pi)
        Wn = -3 / (4 * math.pi) * (
            pn * np.outer(p, p) / r**5 + s[:, None] * pIn * np.outer(pI, pI) / rI**5
        )
        return G, Wn
    h0 = 0.5 * (pI[w] - p[w])
    D = -3 * np.outer(pI, pI) / rI**5 + np.eye(3) / rI**3
    SD = (np.outer(e_w, pI) - np.outer(pI, e_w)) / rI**3
    corr = -2 * h0**2 * D + 2 * h0 * (pI[w] * D + SD)
    G = (_G0(p) - _G0(pI) - s[:, None] * corr) / (8 * math.pi)
    Tn = -(np.outer(nrm, pI) + np.diag(pI**2 * nrm)) / rI**5 + 5 * np.outer(pI, pI) * pIn / rI**7
    Un = (np.outer(pI, nrm) * pI[w] - np.outer(e_w, pI) * pIn) / rI**5
    Wn = -np.outer(p, p) * pn / r**5 + np.outer(pI, pI) * pIn / rI**5
    Wn = Wn + s[:, None] * (2 * h0**2 * Tn - 2 * h0 * (pI[w] * Tn + Un))
    return G, Wn * 3 / (4 * math.pi)


def _pairwise_numpy(kernel, wall_axis, xi, Y, N, W):
    """V, K [3 nr, 3 n] by an explicit loop over (row, column, sample)."""
    nr, (n, m, _) = xi.shape[0], Y.shape
    V = np.zeros((3, nr, 3, n))
    K = np.zeros((3, nr, 3, n))
    for i in range(nr):
        xi_img = xi[i].copy()
        xi_img[wall_axis] = 2 * WALL - xi[i, wall_axis]
        for j in range(n):
            for s in range(m):
                p = Y[j, s] - xi[i]
                pI = Y[j, s] - xi_img
                if p @ p == 0:
                    p = pI = np.ones(3)
                G, Wn = _pair_G_Wn(kernel, wall_axis, p, pI, N[j, s])
                V[:, i, :, j] += W[j, s] * G
                K[:, i, :, j] -= W[j, s] * Wn
    return V.reshape(3 * nr, 3 * n), K.reshape(3 * nr, 3 * n)


@pytest.mark.parametrize("row_tile,col_chunk", [(32, 256), (3, 2)])
@pytest.mark.parametrize("wall_axis", [0, 1, 2])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_version_matches_pairwise_loop(kernel, wall_axis, row_tile, col_chunk):
    args = _random_inputs(wall_axis)
    V, K = node_kernel.node_sweep_reference(
        *args,
        row_tile=row_tile,
        col_chunk=col_chunk,
        kernel=kernel,
        wall_axis=wall_axis,
        wall_position=WALL,
    )
    Vn, Kn = _pairwise_numpy(kernel, wall_axis, *(a.numpy() for a in args))
    assert np.max(np.abs(V.numpy() - Vn)) <= 1e-13 * np.max(np.abs(Vn))
    assert np.max(np.abs(K.numpy() - Kn)) <= 1e-13 * np.max(np.abs(Kn))


@pytest.mark.parametrize("kernel", KERNELS)
def test_image_blocks_are_not_symmetric(kernel):
    """The 3x3 blocks of the image kernels are not symmetric (row signs, SD
    and U terms), so a kernel may not reuse K1's 6-of-9 storage."""
    args = _random_inputs(1, seed=5)
    V, K = node_kernel.node_sweep_reference(*args, kernel=kernel, wall_axis=1, wall_position=WALL)
    nr, n = args[0].shape[0], args[1].shape[0]
    for M in (V, K):
        B = M.reshape(3, nr, 3, n)
        assert (B - B.permute(2, 1, 0, 3)).abs().max() > 1e-3 * B.abs().max()


@pytest.mark.parametrize("kernel", KERNELS)
def test_cpu_wrapper_runs_plain_version(kernel):
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    args = _random_inputs(1, seed=1)
    before = dict(node_kernel.launches)
    V, K = node_kernel.node_sweep(*args, kernel=kernel, wall_axis=1, wall_position=WALL)
    Vr, Kr = node_kernel.node_sweep_reference(*args, kernel=kernel, wall_axis=1, wall_position=WALL)
    assert node_kernel.launches == before
    assert torch.equal(V, Vr) and torch.equal(K, Kr)


@pytest.mark.parametrize("bad", [dict(kernel="blake"), dict(kernel="no_slip", wall_axis=3)])
def test_wrapper_rejects_unknown_kernel_or_axis(bad):
    with pytest.raises(ValueError):
        node_kernel.node_sweep(*_random_inputs(1, seed=2), **bad)


# ---- the assembly with images, against the JAX package --------------------


def _setup(kernel, refinements=2, wall_axis=1):
    mj = fac_j.create_sphere(refinements=refinements)
    mt = fac_t.create_sphere(refinements=refinements)
    sj, st = dofs_j.build_scalar_space(mj, 1), dofs_t.build_scalar_space(mt, 1)
    kw = dict(kernel=kernel, wall_axis=wall_axis, wall_position=WALL)
    tj = asm_j.build_assembly_tables(sj, sj, asm_j.AssemblyConfig(backend="jax", **kw))
    tt = asm_t.build_assembly_tables(st, st, asm_t.AssemblyConfig(**kw))
    ej = jnp.asarray(geo_j.euler_from_mesh(mj.vertices, sj))
    et = torch.as_tensor(geo_t.euler_from_mesh(mt.vertices, st))
    return (ej, geo_j.support_points(ej, sj, sj), tj), (et, geo_t.support_points(et, st, st), tt)


@pytest.fixture(scope="module", params=KERNELS)
def operators(request):
    jax_in, torch_in = _setup(request.param)
    V, K = asm_t.assemble_V_K(*torch_in)
    return jax_in, torch_in, V.numpy(), K.numpy()


def test_assemble_matches_jax_gather(operators):
    jax_in, _, V, K = operators
    Vj, Kj = asm_j.assemble_V_K(*jax_in)
    assert np.allclose(np.asarray(Vj), V, rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kj), K, rtol=0, atol=1e-11)


def test_assemble_matches_pallas_node_kernel(operators):
    (ej, spj, tj), _, V, K = operators
    pcfg = dataclasses.replace(tj.cfg, backend="pallas_interpret", column_mode="node")
    Vp, Kp = asm_j.assemble_V_K(ej, spj, dataclasses.replace(tj, cfg=pcfg))
    assert np.allclose(np.asarray(Vp), V, rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kp), K, rtol=0, atol=1e-11)


def test_assembled_operators_feel_the_wall(operators):
    """Not vacuous: the image operators differ from the free-space ones."""
    _, (et, spt, tt), V, K = operators
    free = dataclasses.replace(tt, cfg=dataclasses.replace(tt.cfg, kernel="free_space"))
    V0, K0 = asm_t.assemble_V_K(et, spt, free)
    assert np.max(np.abs(V - V0.numpy())) > 1e-3 * np.max(np.abs(V))
    assert np.max(np.abs(K - K0.numpy())) > 1e-3 * np.max(np.abs(K))


@pytest.mark.parametrize("wall_axis", [0, 2])
@pytest.mark.parametrize("kernel", KERNELS)
def test_assemble_other_wall_axes_match_jax(kernel, wall_axis):
    (ej, spj, tj), torch_in = _setup(kernel, refinements=1, wall_axis=wall_axis)
    V, K = asm_t.assemble_V_K(*torch_in)
    Vj, Kj = asm_j.assemble_V_K(ej, spj, tj)
    assert np.allclose(np.asarray(Vj), V.numpy(), rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kj), K.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("row_range", [(0, 40), (17, 98)])
def test_row_block_matches_full(operators, row_range):
    _, (et, spt, tt), V, K = operators
    r0, r1 = row_range
    Vb, Kb = asm_t.assemble_V_K(et, spt, tt, row_range=row_range)
    rows = np.concatenate([a * tt.n_nodes + np.arange(r0, r1) for a in range(3)])
    assert np.allclose(Vb.numpy(), V[rows], rtol=0, atol=1e-15)
    assert np.allclose(Kb.numpy(), K[rows], rtol=0, atol=1e-15)


def _dense(coo, shape):
    ri, ci, dV, dK = (np.asarray(a) for a in coo)
    keep = (ri < shape[0]) & (ci < shape[1])
    out = []
    for vals in (dV, dK):
        M = np.zeros(shape)
        np.add.at(M, (ri[keep], ci[keep]), vals[keep])
        out.append(M)
    return out


def _wall_cfg(kernel, height):
    return ProblemConfig(
        no_slip_kernel=kernel == "no_slip",
        reflect_kernel=kernel == "free_surface",
        walls=(WallConfig(enabled=False, position=(0.0, -height, 0.0), span=(10.0, 0.0, 10.0)),),
    )


@pytest.fixture(scope="module", params=KERNELS)
def near_wall(request):
    """A refinement-2 sphere whose lowest point is 0.1 above the image
    plane: the gap to its image (0.2) is below the local panel diameter, so
    both problems promote to the adaptive two-level rule."""
    cfg = _wall_cfg(request.param, 1.1)
    pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
    pt = ProblemT(fac_t.create_sphere(refinements=2), from_dict(dataclasses.asdict(cfg)), device="cpu")
    ej, et = pj.initial_euler(), pt.initial_euler()
    spj = geo_j.support_points(ej, pj.map_space, pj.fe_space)
    spt = geo_t.support_points(et, pt.map_space, pt.fe_space)
    return (ej, spj, pj), (et, spt, pt)


def test_wall_image_gap_promotes(near_wall):
    (_, _, pj), (_, _, pt) = near_wall
    assert pj.quadrature_promoted and pt.quadrature_promoted
    assert pt.tables.hq_weights is not None
    assert pt.asm_cfg.quad_order == pj.asm_cfg.quad_order == 8
    assert pt.asm_cfg.quad_order_far == pj.asm_cfg.quad_order_far == 4
    assert (pt.asm_cfg.wall_axis, pt.asm_cfg.wall_position) == (1, -1.1)


@pytest.mark.parametrize("kernel", KERNELS)
def test_far_wall_does_not_promote(kernel):
    """The same sphere 2 radii above the wall keeps the single-pass rule, and
    the wall plane is read from walls[0] (its zero-span axis)."""
    cfg = dataclasses.replace(
        _wall_cfg(kernel, 2.0),
        walls=(WallConfig(enabled=False, position=(0.5, 1.0, -2.0), span=(4.0, 4.0, 0.0)),),
    )
    pj = ProblemJ(fac_j.create_sphere(refinements=1), cfg)
    pt = ProblemT(fac_t.create_sphere(refinements=1), from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert not pt.quadrature_promoted and not pj.quadrature_promoted
    assert pt.asm_cfg.kernel == pj.asm_cfg.kernel == kernel
    assert (pt.asm_cfg.wall_axis, pt.asm_cfg.wall_position) == (2, -2.0)
    assert (pj.asm_cfg.wall_axis, pj.asm_cfg.wall_position) == (2, -2.0)


@pytest.mark.parametrize("row_range", [None, (30, 80)])
def test_near_coo_with_images_matches_jax(near_wall, row_range):
    (ej, spj, pj), (et, spt, pt) = near_wall
    n = pt.n
    r0, r1 = row_range or (0, n)
    nr = r1 - r0
    cj = asm_j._near_coo(ej, spj, spj[r0:r1], jnp.arange(r0, r1, dtype=jnp.int32), pj.tables, nr)
    ct = asm_t._near_coo(et, spt, spt[r0:r1], torch.arange(r0, r1), pt.tables, nr)
    shape = (3 * nr, 3 * n)
    for a, b in zip(_dense(cj, shape), _dense(ct, shape)):
        assert np.abs(a).max() > 0
        assert np.allclose(a, b, rtol=0, atol=1e-13)


@pytest.mark.parametrize("subtract_smooth", [False, True])
@pytest.mark.parametrize("row_range", [None, (30, 80)])
def test_singular_coo_with_images_matches_jax(near_wall, subtract_smooth, row_range):
    (ej, spj, pj), (et, spt, pt) = near_wall
    n = pt.n
    r0, r1 = row_range or (0, n)
    nr = r1 - r0
    cj = asm_j._singular_coo(ej, spj, pj.tables, r0, nr, subtract_smooth=subtract_smooth)
    ct = asm_t._singular_coo(et, spt, pt.tables, r0, nr, subtract_smooth=subtract_smooth)
    shape = (3 * nr, 3 * n)
    for a, b in zip(_dense(cj, shape), _dense(ct, shape)):
        assert np.abs(a).max() > 0
        assert np.allclose(a, b, rtol=0, atol=1e-13)


def test_near_wall_assembly_matches_jax(near_wall):
    """The whole promoted assembly (far-rule bulk + near + singular deltas)
    against JAX's gather path at the same adaptive rule."""
    (ej, spj, pj), (et, spt, pt) = near_wall
    Vj, Kj = asm_j.assemble_V_K(ej, spj, pj.tables)
    Vt, Kt = asm_t.assemble_V_K(et, spt, pt.tables)
    assert np.allclose(np.asarray(Vj), Vt.numpy(), rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kj), Kt.numpy(), rtol=0, atol=1e-11)


# ---- on a card --------------------------------------------------------------


def _sphere_inputs(dtype, device, refinements=3):
    """(xi, Yj, Nj, Wj) as the assembly builds them on create_sphere."""
    mesh = fac_t.create_sphere(refinements=refinements)
    space = dofs_t.build_scalar_space(mesh, 1)
    tables = asm_t.build_assembly_tables(space, space, asm_t.AssemblyConfig(dtype=dtype))
    euler = torch.as_tensor(geo_t.euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    return asm_t.node_sweep_inputs(euler, geo_t.support_points(euler, space, space), tables)


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K2 and K3 kernels have no CPU mode")
    return torch.device("cuda")


def _rel(A, B):
    return ((A - B).abs().max() / B.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("rows", [None, 37])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_version(cuda_device, kernel, dtype, tol, rows):
    xi, Yj, Nj, Wj = _sphere_inputs(dtype, cuda_device)
    if rows is not None:  # a ragged row block
        xi = xi[5 : 5 + rows].contiguous()
    kw = dict(kernel=kernel, wall_axis=1, wall_position=WALL)
    before = dict(node_kernel.launches)
    V, K = node_kernel.node_sweep(xi, Yj, Nj, Wj, **kw)
    torch.cuda.synchronize()
    assert node_kernel.launches[kernel] == before[kernel] + 1
    assert sum(node_kernel.launches.values()) == sum(before.values()) + 1
    Vr, Kr = node_kernel.node_sweep_reference(xi, Yj, Nj, Wj, **kw)
    assert _rel(V, Vr) <= tol and _rel(K, Kr) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("wall_axis", [0, 1, 2])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_random_inputs_and_dummy_offset(cuda_device, kernel, wall_axis):
    """Ragged shapes (nr, n, m not multiples of the kernel's tiles), zero
    weights and an exact r^2 = 0 pair, every wall axis, in f64."""
    args = [a.to(cuda_device) for a in _random_inputs(wall_axis, nr=37, n=45, m=36, seed=3)]
    kw = dict(kernel=kernel, wall_axis=wall_axis, wall_position=WALL)
    V, K = node_kernel.node_sweep(*args, **kw)
    Vr, Kr = node_kernel.node_sweep_reference(*args, **kw)
    assert _rel(V, Vr) <= 1e-12 and _rel(K, Kr) <= 1e-12
