"""K1, the node-sweep kernel, and K4, its component-major twin
(`bemstokes_tpu_torch/ops/node_kernel.py`).

On the CPU: the wrapper runs the plain torch version and launches nothing,
and the plain version agrees with a per-pair numpy evaluation of the
Stokeslet / stresslet sums (f64, 1e-13 relative to max|V|, max|K|),
including the dummy offset on an exact r^2 = 0 pair, zero-weight padding
and ragged tiles.

The planes layout (K4): the plain version equals the dense form exactly
after `planes_to_dense`, and agrees with the Pallas TPU kernel it replaces,
`pallas_node_blocks(..., transposed=False, interpret=True)` fed through
`node_sweep_soa` at T = CJ = 128, to 1e-12 of max in f64.

On a card (marker `cuda`): the CUDA kernel against its plain version on the
same inputs at the create_sphere(3) shapes, relative to max|V| and max|K|:
1e-12 in f64, 1e-5 in f32 (FMA contraction, the rsqrt approximation and
the summation order differ between the two).

Run the card tests with `python3 -m pytest tests/test_torch_node_kernel.py
-m cuda` on a machine with a CUDA card and nvcc.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bemstokes_tpu.ops.assemble import node_sweep_soa
from bemstokes_tpu.ops.pallas_node import pallas_node_blocks
from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
from bemstokes_tpu_torch.ops import node_kernel
from bemstokes_tpu_torch.ops.assemble import (
    AssemblyConfig,
    build_assembly_tables,
    node_sweep_inputs,
)
import torch_threads  # noqa: F401  (one torch thread a test process)


def _random_inputs(nr=7, n=5, m=6, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(nr, 3))
    Y = rng.normal(size=(n, m, 3))
    N = rng.normal(size=(n, m, 3))
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    W = rng.uniform(size=(n, m))
    W[:, -1] = 0.0  # incidence padding
    xi[2] = Y[3, 1]  # an exact r^2 = 0 pair
    return [torch.as_tensor(a, dtype=dtype) for a in (xi, Y, N, W)]


def _pairwise_numpy(xi, Y, N, W):
    """V, K [3 nr, 3 n] by an explicit loop over (row, column, sample)."""
    nr, (n, m, _) = xi.shape[0], Y.shape
    V = np.zeros((3, nr, 3, n))
    K = np.zeros((3, nr, 3, n))
    for i in range(nr):
        for j in range(n):
            for s in range(m):
                R = Y[j, s] - xi[i]
                if R @ R == 0:
                    R = np.ones(3)
                r = math.sqrt(R @ R)
                G = (np.eye(3) / r + np.outer(R, R) / r**3) / (8 * math.pi)
                Wn = -3.0 / (4 * math.pi) * (R @ N[j, s]) * np.outer(R, R) / r**5
                V[:, i, :, j] += W[j, s] * G
                K[:, i, :, j] -= W[j, s] * Wn
    return V.reshape(3 * nr, 3 * n), K.reshape(3 * nr, 3 * n)


@pytest.mark.parametrize("row_tile,col_chunk", [(32, 256), (3, 2), (1, 1)])
def test_plain_version_matches_pairwise_loop(row_tile, col_chunk):
    args = _random_inputs()
    V, K = node_kernel.node_sweep_reference(*args, row_tile=row_tile, col_chunk=col_chunk)
    Vn, Kn = _pairwise_numpy(*(a.numpy() for a in args))
    assert np.max(np.abs(V.numpy() - Vn)) <= 1e-13 * np.max(np.abs(Vn))
    assert np.max(np.abs(K.numpy() - Kn)) <= 1e-13 * np.max(np.abs(Kn))


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper is the plain version and counts no
    launch."""
    args = _random_inputs(seed=1)
    before = dict(node_kernel.launches), dict(node_kernel.interactions)
    V, K = node_kernel.node_sweep(*args)
    Vr, Kr = node_kernel.node_sweep_reference(*args)
    assert (node_kernel.launches, node_kernel.interactions) == before
    assert torch.equal(V, Vr) and torch.equal(K, Kr)


@pytest.mark.parametrize(
    "bad",
    ["shape", "dtype"],
)
def test_wrapper_rejects_mismatched_inputs(bad):
    xi, Y, N, W = _random_inputs(seed=2)
    if bad == "shape":
        Y = Y[:, :4]
        err = ValueError
    else:
        W = W.float()
        err = TypeError
    with pytest.raises(err):
        node_kernel.node_sweep(xi, Y, N, W)


def _sphere_inputs(dtype, device, refinements=3):
    """(xi, Yj, Nj, Wj) as the assembly builds them on create_sphere."""
    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(space, space, AssemblyConfig(dtype=dtype))
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    return node_sweep_inputs(euler, support_points(euler, space, space), tables)


def test_sphere_inputs_shapes():
    xi, Yj, Nj, Wj = _sphere_inputs(torch.float64, "cpu")
    assert xi.shape == (386, 3) and Yj.shape == Nj.shape == (386, 64, 3)
    assert Wj.shape == (386, 64) and all(t.is_contiguous() for t in (xi, Yj, Nj, Wj))


@pytest.mark.parametrize("nr", [7, 3])
def test_planes_layout_is_the_dense_form_relaid(nr):
    xi, Y, N, W = _random_inputs(nr=nr)
    V, K = node_kernel.node_sweep_reference(xi, Y, N, W)
    Vp, Kp = node_kernel.node_sweep(xi, Y, N, W, layout="planes")
    assert Vp.shape == Kp.shape == (9, Y.shape[0], nr)
    assert torch.equal(node_kernel.planes_to_dense(Vp), V)
    assert torch.equal(node_kernel.planes_to_dense(Kp), K)
    # entry (3a + b, j, i) is entry (a*nr + i, b*n + j) of the dense form
    n = Y.shape[0]
    assert Vp[3 * 1 + 2, 4, nr - 1] == V[1 * nr + nr - 1, 2 * n + 4]


def test_planes_layout_is_free_space_only():
    args = _random_inputs()
    for fn in (node_kernel.node_sweep, node_kernel.node_sweep_reference):
        with pytest.raises(ValueError, match="free space only"):
            fn(*args, kernel="no_slip", layout="planes")
        with pytest.raises(ValueError, match="layout"):
            fn(*args, layout="rows")


@pytest.mark.parametrize("rows", [None, 37])
def test_planes_layout_matches_pallas_rows_in_lanes_kernel(rows):
    """create_sphere(2) (98 nodes, m = 64) through the TPU kernel's program
    layout, one 128 x 128 program; the padded rows and columns are cut."""
    xi, Yj, Nj, Wj = _sphere_inputs(torch.float64, "cpu", refinements=2)
    if rows is not None:
        xi = xi[5 : 5 + rows].contiguous()
    nr, n = xi.shape[0], Yj.shape[0]
    V, K = node_kernel.node_sweep(xi, Yj, Nj, Wj, layout="planes")
    xi_p, Y_soa, N_soa, W_b = node_sweep_soa(
        *(jnp.asarray(a.numpy()) for a in (xi, Yj, Nj, Wj)),
        d=3, nq=16, vmax=4, T=128, CJ=128, bulk_dt=jnp.float64,
    )
    Vp, Kp = pallas_node_blocks(
        xi_p, Y_soa, N_soa, W_b, CJ=128, nq=16, vmax=4, T=128, interpret=True, transposed=False
    )
    assert Vp.shape == (9, 128, 128)
    for A, P in ((V, Vp), (K, Kp)):
        P = np.asarray(P)[:, :n, :nr]
        assert np.max(np.abs(A.numpy() - P)) <= 1e-12 * np.max(np.abs(P))


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K1 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("rows", [None, 37])
def test_kernel_matches_plain_version(cuda_device, dtype, tol, rows):
    xi, Yj, Nj, Wj = _sphere_inputs(dtype, cuda_device)
    if rows is not None:  # a ragged row block
        xi = xi[5 : 5 + rows].contiguous()
    before = node_kernel.launches["free_space"]
    suffix = "f64" if dtype == torch.float64 else "f32"
    swept = node_kernel.interactions["free_space", suffix]
    V, K = node_kernel.node_sweep(xi, Yj, Nj, Wj)
    torch.cuda.synchronize()
    assert node_kernel.launches["free_space"] == before + 1
    assert node_kernel.interactions["free_space", suffix] == swept + xi.shape[0] * Yj.shape[0] * Yj.shape[1]
    Vr, Kr = node_kernel.node_sweep_reference(xi, Yj, Nj, Wj)
    assert ((V - Vr).abs().max() / Vr.abs().max()).item() <= tol
    assert ((K - Kr).abs().max() / Kr.abs().max()).item() <= tol


@pytest.mark.cuda
def test_kernel_random_inputs_and_dummy_offset(cuda_device):
    """Ragged shapes (nr, n, m not multiples of the kernel's tiles), zero
    weights and an exact r^2 = 0 pair, in f64."""
    args = [a.to(cuda_device) for a in _random_inputs(nr=37, n=45, m=36, seed=3)]
    V, K = node_kernel.node_sweep(*args)
    Vr, Kr = node_kernel.node_sweep_reference(*args)
    assert ((V - Vr).abs().max() / Vr.abs().max()).item() <= 1e-12
    assert ((K - Kr).abs().max() / Kr.abs().max()).item() <= 1e-12


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    xi, Y, N, W = (a.to(cuda_device) for a in _random_inputs(seed=4))
    with pytest.raises(ValueError, match="contiguous"):
        node_kernel.node_sweep(xi.T.contiguous().T, Y, N, W)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("rows", [None, 37])
def test_planes_kernel_matches_plain_version_and_k1(cuda_device, dtype, tol, rows):
    """K4 against its plain version, and K1's bits after `planes_to_dense`
    (both kernels run the same sample loop)."""
    xi, Yj, Nj, Wj = _sphere_inputs(dtype, cuda_device)
    if rows is not None:
        xi = xi[5 : 5 + rows].contiguous()
    before = node_kernel.launches["planes"]
    V, K = node_kernel.node_sweep(xi, Yj, Nj, Wj, layout="planes")
    torch.cuda.synchronize()
    assert node_kernel.launches["planes"] == before + 1
    Vr, Kr = node_kernel.node_sweep_reference(xi, Yj, Nj, Wj, layout="planes")
    assert ((V - Vr).abs().max() / Vr.abs().max()).item() <= tol
    assert ((K - Kr).abs().max() / Kr.abs().max()).item() <= tol
    Vd, Kd = node_kernel.node_sweep(xi, Yj, Nj, Wj)
    assert torch.equal(node_kernel.planes_to_dense(V), Vd)
    assert torch.equal(node_kernel.planes_to_dense(K), Kd)
