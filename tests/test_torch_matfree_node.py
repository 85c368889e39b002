"""K5, the fused sweep-matvec (`bemstokes_tpu_torch/ops/matfree_node.py`).

On the CPU, where the wrapper runs the plain torch version, on
create_sphere(2) (98 nodes, m = 64 samples per column node), the wall at
y = -2, with the same seeded numpy vectors through both packages:

- against the JAX package's `sweep_matvec(backend="xla")` in f64, 1e-12 of
  the largest entry (the two contract the same G and W.n in another order);
- against its Pallas kernel in interpret mode in f32: V to 2e-5 (the bound
  of tests/test_matfree.py:190-235); K to 2e-4, because in f32 K's own-node
  terms are large and cancel, and every f32 evaluation lands 2e-5 to 1.3e-4
  of max|K x| away from the f64 value (measured here: the Pallas kernel and
  the JAX XLA sweep 1.8e-5, the port's plain version 4.3e-5, and 5.5e-5
  between the two packages), so both are also held to 2e-4 of the f64 sweep;
- against the port's own materialized `node_sweep` times the vectors, 1e-12;
- a batch wider than the TPU kernel's cap of 42 columns.

On a card (marker `cuda`): the CUDA kernel against the plain version on
create_sphere(3), 1e-12 of the largest entry in f64 and 5e-5 in f32 (the
kernel takes every inverse power from one rsqrt where the plain version
divides by powers of a square root, and contracts with the vector before it
sums, so own-node terms that cancel round differently), the same bits on a
second call, and K5 against `V @ x`, `K @ x` of the materialized kernels,
for every launch shape (two-sided, V only, K only, wide chunks), each wall
axis, ragged row blocks and ragged seeded tables with an odd sample count;
and the kernel's f64 inverse square root against 1 / sqrt.

Run the card tests with `python3 -m pytest tests/test_torch_matfree_node.py
-m cuda` on a machine with a CUDA card and nvcc.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.ops.assemble as asm_j
import bemstokes_tpu.ops.matfree_node as mfn_j
import bemstokes_tpu_torch.fem.geometry as geo_t
import bemstokes_tpu_torch.mesh.dofs as dofs_t
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.ops.assemble as asm_t
from bemstokes_tpu_torch.ops import matfree_node as mfn_t
from bemstokes_tpu_torch.ops import node_kernel
from bemstokes_tpu_torch.physics.rigid import build_mass_operator

KERNELS = ["free_space", "free_surface", "no_slip"]
WALL = -2.0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _vectors(n, BV, BK, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((3 * n, BV)), rng.standard_normal((3 * n, BK))


def _jax_sweep(kernel, dtype, backend, XV, XK, refinements=2):
    mesh = fac_j.create_sphere(refinements=refinements)
    space = dofs_j.build_scalar_space(mesh, 1)
    acfg = asm_j.AssemblyConfig(
        dim=3, kernel=kernel, wall_axis=1, wall_position=WALL, dtype=dtype, backend=backend
    )
    tables = asm_j.build_assembly_tables(space, space, acfg)
    euler = jnp.asarray(mesh.vertices, dtype)
    sp = geo_j.support_points(euler, space, space)
    xq, normals, jxw = geo_j.panel_geometry(
        euler[jnp.asarray(tables.cells_nodes_map)],
        jnp.asarray(tables.phi_map, dtype),
        jnp.asarray(tables.dphi_map, dtype),
        jnp.asarray(tables.q_weights, dtype),
        jnp.asarray(tables.flip_sign, dtype),
        ambient_dim=3,
    )
    st, arrs = mfn_j.build_sweep(
        tables, sp, xq, normals, jxw, backend="xla" if backend == "jax" else backend
    )
    V, K = mfn_j.sweep_matvec(st, arrs, jnp.asarray(XV, dtype), jnp.asarray(XK, dtype))
    return np.asarray(V), np.asarray(K)


def _torch_sweep_inputs(kernel, dtype, device="cpu", refinements=2, wall_axis=1):
    mesh = fac_t.create_sphere(refinements=refinements)
    space = dofs_t.build_scalar_space(mesh, 1)
    acfg = asm_t.AssemblyConfig(
        kernel=kernel, wall_axis=wall_axis, wall_position=WALL, dtype=dtype
    )
    tables = asm_t.build_assembly_tables(space, space, acfg)
    euler = torch.as_tensor(
        geo_t.euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device
    )
    sp = geo_t.support_points(euler, space, space)
    _, (xq, normals, jxw) = build_mass_operator(euler, tables)
    return tables, euler, sp, xq, normals, jxw


def _torch_sweep(kernel, dtype, XV, XK, device="cpu", refinements=2):
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs(kernel, dtype, device, refinements)
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    V, K = mfn_t.sweep_matvec(
        st,
        arrs,
        torch.as_tensor(XV, dtype=dtype, device=device),
        torch.as_tensor(XK, dtype=dtype, device=device),
    )
    return V.cpu().numpy(), K.cpu().numpy()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("BV,BK", [(2, 3), (45, 50)], ids=["b2x3", "wider_than_the_tpu_cap"])
def test_sweep_matches_jax_xla_f64(kernel, BV, BK):
    XV, XK = _vectors(98, BV, BK)
    Vj, Kj = _jax_sweep(kernel, jnp.float64, "jax", XV, XK)
    Vt, Kt = _torch_sweep(kernel, torch.float64, XV, XK)
    assert Vt.shape == (3 * 98, BV) and Kt.shape == (3 * 98, BK)
    assert _rel(Vt, Vj) <= 1e-12
    assert _rel(Kt, Kj) <= 1e-12


@pytest.mark.parametrize("kernel", KERNELS)
def test_sweep_matches_jax_pallas_interpret_f32(kernel):
    XV, XK = _vectors(98, 2, 3)
    Vj, Kj = _jax_sweep(kernel, jnp.float32, "pallas_interpret", XV, XK)
    Vt, Kt = _torch_sweep(kernel, torch.float32, XV, XK)
    _, K64 = _jax_sweep(kernel, jnp.float64, "jax", XV, XK)
    assert _rel(Vt, Vj) <= 2e-5
    assert _rel(Kt, Kj) <= 2e-4
    assert _rel(Kt, K64) <= 2e-4 and _rel(Kj, K64) <= 2e-4


@pytest.mark.parametrize("kernel", KERNELS)
def test_sweep_matches_materialized_sweep(kernel):
    """The fold against the port's dense node sweep times the vectors, on
    a ragged row block."""
    tables, euler, sp, xq, normals, jxw = _torch_sweep_inputs(kernel, torch.float64)
    xi = sp[5:42]
    st, arrs = mfn_t.build_sweep(tables, xi, xq, normals, jxw)
    XV, XK = (torch.as_tensor(a) for a in _vectors(98, 3, 2, seed=1))
    Vx, Kx = mfn_t.sweep_matvec(st, arrs, XV, XK)
    V, K = node_kernel.node_sweep(
        *asm_t.node_sweep_inputs(euler, xi, tables),
        kernel=kernel,
        wall_axis=1,
        wall_position=WALL,
    )
    assert _rel(Vx, V @ XV) <= 1e-12
    assert _rel(Kx, K @ XK) <= 1e-12


def test_one_dimensional_vectors_and_empty_batches():
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs("free_space", torch.float64)
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    XV, XK = (torch.as_tensor(a) for a in _vectors(98, 1, 1, seed=2))
    V2, K2 = mfn_t.sweep_matvec(st, arrs, XV, XK)
    V1, K1 = mfn_t.sweep_matvec(st, arrs, XV[:, 0], XK[:, 0])
    assert V1.shape == K1.shape == (294,)
    assert torch.equal(V1, V2[:, 0]) and torch.equal(K1, K2[:, 0])
    V0, K0 = mfn_t.sweep_matvec(st, arrs, XV[:, :0], XK)
    assert V0.shape == (294, 0) and torch.equal(K0, K2)


@pytest.mark.parametrize("kernel", KERNELS)
def test_one_sided_batches_are_the_two_sided_columns(kernel):
    """BK = 0 and BV = 0 (the kernel's one-sided launch shapes): the columns
    of the two-sided call exactly, an empty [3 nr, 0] tensor for the other
    side, and the JAX package's XLA sweep on the same vectors to 1e-12."""
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs(kernel, torch.float64)
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    XVn, XKn = _vectors(98, 1, 1, seed=4)
    XV, XK = torch.as_tensor(XVn), torch.as_tensor(XKn)
    V2, K2 = mfn_t.sweep_matvec(st, arrs, XV, XK)
    Vv, Kv = mfn_t.sweep_matvec(st, arrs, XV, XK[:, :0])
    Vk, Kk = mfn_t.sweep_matvec(st, arrs, XV[:, :0], XK)
    assert Kv.shape == Vk.shape == (294, 0) and Kv.dtype == Vk.dtype == torch.float64
    assert torch.equal(Vv, V2) and torch.equal(Kk, K2)
    Vj, Kj = _jax_sweep(kernel, jnp.float64, "jax", XVn, XKn)
    assert _rel(Vv, Vj) <= 1e-12 and _rel(Kk, Kj) <= 1e-12


def test_launch_shape_names_the_instantiation():
    shapes = {(1, 1): "1x1", (1, 0): "1x0", (0, 1): "0x1", (1, 10): "wide", (0, 5): "wide", (2, 0): "wide"}
    for (BV, BK), name in shapes.items():
        assert mfn_t.launch_shape(BV, BK) == name
    assert set(mfn_t.shape_launches) == {
        (k, s) for k in KERNELS for s in ("1x1", "1x0", "0x1", "wide")
    }


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no
    launch; the tiles of the plain version do not change its result beyond
    rounding."""
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs("no_slip", torch.float64)
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    XV, XK = (torch.as_tensor(a) for a in _vectors(98, 2, 2, seed=3))
    before, before_shapes = dict(mfn_t.launches), dict(mfn_t.shape_launches)
    V, K = mfn_t.sweep_matvec(st, arrs, XV, XK)
    Vr, Kr = mfn_t.sweep_matvec_reference(st, arrs, XV, XK)
    assert mfn_t.launches == before and mfn_t.shape_launches == before_shapes
    assert torch.equal(V, Vr) and torch.equal(K, Kr)
    Vs, Ks = mfn_t.sweep_matvec_reference(st, arrs, XV, XK, row_tile=7, col_chunk=5)
    assert _rel(Vs, Vr) <= 1e-13 and _rel(Ks, Kr) <= 1e-13


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_wrapper_rejects_mismatched_inputs(bad):
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs("free_space", torch.float64)
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    XV, XK = (torch.as_tensor(a) for a in _vectors(98, 1, 1))
    if bad == "shape":
        with pytest.raises(ValueError, match="XV"):
            mfn_t.sweep_matvec(st, arrs, XV[:-1], XK)
    else:
        with pytest.raises(TypeError, match="XK"):
            mfn_t.sweep_matvec(st, arrs, XV, XK.float())


def test_sweep_static_describes_the_tables():
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs("no_slip", torch.float32)
    st, arrs = mfn_t.build_sweep(tables, sp[:10], xq, normals, jxw)
    assert (st.n, st.nr, st.kernel, st.wall_axis, st.wall_position) == (98, 10, "no_slip", 1, WALL)
    assert st.vmax * st.nq == 64 and st.dtype == torch.float32
    assert arrs["Y"].shape == (98, 64, 3) and arrs["xi"].shape == (10, 3)
    assert all(a.is_contiguous() and a.dtype == torch.float32 for a in arrs.values())


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 5e-5)])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("wall_axis", [0, 1, 2])
def test_kernel_matches_plain_version(cuda_device, dtype, tol, kernel, wall_axis):
    if kernel == "free_space" and wall_axis != 1:
        pytest.skip("the free-space kernel has no wall")
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs(
        kernel, dtype, cuda_device, refinements=3, wall_axis=wall_axis
    )
    for xi in (sp, sp[5:42]):  # whole, and a ragged row block
        st, arrs = mfn_t.build_sweep(tables, xi, xq, normals, jxw)
        for BV, BK in ((1, 1), (1, 0), (0, 1), (1, 10), (0, 5), (5, 0), (45, 3)):
            XV, XK = (
                torch.as_tensor(a, dtype=dtype, device=cuda_device)
                for a in _vectors(386, BV, BK, seed=BV + BK)
            )
            before = mfn_t.launches[kernel]
            shape = kernel, mfn_t.launch_shape(BV, BK)
            before_shape = mfn_t.shape_launches[shape]
            V, K = mfn_t.sweep_matvec(st, arrs, XV, XK)
            torch.cuda.synchronize()
            assert mfn_t.launches[kernel] == before + 1
            assert mfn_t.shape_launches[shape] == before_shape + 1
            assert V.shape == (3 * st.nr, BV) and K.shape == (3 * st.nr, BK)
            V2, K2 = mfn_t.sweep_matvec(st, arrs, XV, XK)
            assert torch.equal(V, V2) and torch.equal(K, K2)
            Vr, Kr = mfn_t.sweep_matvec_reference(st, arrs, XV, XK, row_tile=64, col_chunk=512)
            if BV:
                assert _rel(V.cpu(), Vr.cpu()) <= tol
            if BK:
                assert _rel(K.cpu(), Kr.cpu()) <= tol


def _ragged_case(kernel, wall_axis, device):
    """Seeded tables with ragged sizes (11 rows, 37 column nodes, 7 samples a
    node) whose rows coincide with a sample exactly (the dummy offset)."""
    rng = np.random.default_rng(9)
    n, nr, m = 37, 11, 7
    Y = rng.standard_normal((n, m, 3))
    Y[..., wall_axis] += 3.0
    N = rng.standard_normal((n, m, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    st = mfn_t.SweepStatic(
        d=3, n=n, nr=nr, kernel=kernel, wall_axis=wall_axis, wall_position=-1.5,
        nq=1, vmax=m, dtype=torch.float64,
    )
    arrs = dict(xi=Y[:nr, 0].copy(), Y=Y, N=N, W=rng.random((n, m)))
    return st, {k: torch.as_tensor(v, device=device).contiguous() for k, v in arrs.items()}


@pytest.mark.parametrize("kernel", KERNELS)
def test_ragged_tables_with_coincident_rows_are_finite(kernel):
    """The plain version on the ragged seeded tables the card test uses:
    finite, and its one-sided calls are its two-sided columns."""
    st, arrs = _ragged_case(kernel, 2, "cpu")
    XV, XK = (torch.as_tensor(a) for a in _vectors(37, 2, 3, seed=6))
    V, K = mfn_t.sweep_matvec(st, arrs, XV, XK)
    assert torch.isfinite(V).all() and torch.isfinite(K).all()
    assert torch.equal(mfn_t.sweep_matvec(st, arrs, XV, XK[:, :0])[0], V)
    assert torch.equal(mfn_t.sweep_matvec(st, arrs, XV[:, :0], XK)[1], K)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("wall_axis", [0, 1, 2])
def test_kernel_on_ragged_tables(cuda_device, kernel, wall_axis):
    """Ragged nr, n and an odd m (the sample loop's zero-weight padding),
    rows on a sample (the dummy offset), every launch shape."""
    st, arrs = _ragged_case(kernel, wall_axis, cuda_device)
    for BV, BK in ((1, 1), (1, 0), (0, 1), (2, 6), (0, 9), (9, 0)):
        XV, XK = (
            torch.as_tensor(a, device=cuda_device) for a in _vectors(37, BV, BK, seed=BV + BK)
        )
        V, K = mfn_t.sweep_matvec(st, arrs, XV, XK)
        Vr, Kr = mfn_t.sweep_matvec_reference(st, arrs, XV, XK)
        assert torch.isfinite(V).all() and torch.isfinite(K).all()
        if BV:
            assert _rel(V.cpu(), Vr.cpu()) <= 1e-12
        if BK:
            assert _rel(K.cpu(), Kr.cpu()) <= 1e-12


@pytest.mark.cuda
def test_rsqrt_pos_against_sqrt(cuda_device):
    """The kernel's f64 inverse square root over the range of r^2 the sweeps
    see and far beyond it, against 1 / sqrt in extended precision: within
    one ulp (relative error below 2^-52)."""
    rng = np.random.default_rng(3)
    x = np.exp(rng.uniform(np.log(1e-12), np.log(1e8), 1_000_000))
    y = mfn_t.rsqrt_pos(torch.as_tensor(x, device=cuda_device)).cpu().numpy()
    exact = 1 / np.sqrt(x.astype(np.longdouble))
    assert float(np.abs((y - exact) / exact).max()) <= 2.0**-52


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_materialized_kernels(cuda_device, kernel):
    tables, euler, sp, xq, normals, jxw = _torch_sweep_inputs(
        kernel, torch.float64, cuda_device, refinements=3
    )
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    XV, XK = (torch.as_tensor(a, device=cuda_device) for a in _vectors(386, 1, 1, seed=5))
    Vx, Kx = mfn_t.sweep_matvec(st, arrs, XV, XK)
    V, K = node_kernel.node_sweep(
        *asm_t.node_sweep_inputs(euler, sp, tables),
        kernel=kernel,
        wall_axis=1,
        wall_position=WALL,
    )
    assert _rel(Vx.cpu(), (V @ XV).cpu()) <= 1e-12
    assert _rel(Kx.cpu(), (K @ XK).cpu()) <= 1e-12


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    tables, _, sp, xq, normals, jxw = _torch_sweep_inputs(
        "free_space", torch.float64, cuda_device
    )
    st, arrs = mfn_t.build_sweep(tables, sp, xq, normals, jxw)
    arrs["xi"] = arrs["xi"].T.contiguous().T
    XV, XK = (torch.as_tensor(a, device=cuda_device) for a in _vectors(98, 1, 1))
    with pytest.raises(ValueError, match="contiguous"):
        mfn_t.sweep_matvec(st, arrs, XV, XK)
