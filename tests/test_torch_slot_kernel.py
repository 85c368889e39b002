"""K6, the slot kernel of the gather assembly
(`bemstokes_tpu_torch/ops/slot_kernel.py`).

On the CPU, on seeded numpy inputs with masked pairs that include an exact
R = 0 (relative to max|V_slots| and max|K_slots|):

- the plain version `tile_slots_reference` against the Pallas TPU kernel it
  replaces, `pallas_tile_slots(..., interpret=True)`, for Q1 and Q2 panels
  (4 and 9 local nodes): 1e-12 in f64; 2e-5 in f32 (measured here: V 1.5e-7,
  K 6.1e-7 on these inputs; own-cell pairs are masked, so no slot is a sum
  of large cancelling terms);
- against a per-pair numpy loop: 1e-13 in f64;
- the image Green's functions of the plain version against the port's
  gathered pair blocks (`ops.assemble._pair_local_blocks`): 1e-13;
- the wrapper runs the plain version on CPU tensors and launches nothing.

On a card (marker `cuda`): the CUDA kernel against its plain version, 1e-12
in f64 and 2e-5 in f32, the same bits on a second call, ragged shapes.

Run the card tests with `python3 -m pytest tests/test_torch_slot_kernel.py
-m cuda` on a machine with a CUDA card and nvcc.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bemstokes_tpu.ops.pallas_assemble import pallas_tile_slots
from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
from bemstokes_tpu_torch.ops import assemble, slot_kernel
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


def _random_inputs(nt=7, nc=6, nq=5, nl=4, seed=0, dtype=torch.float64):
    """(xi, xq, nrm, wphi, keep) with masked pairs, one of them an exact
    R = 0, and a panel of zero weight."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(nt, 3))
    xq = rng.normal(size=(nc, nq, 3))
    nrm = rng.normal(size=(nc, nq, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    wphi = rng.normal(size=(nc, nq, nl))
    wphi[-1] = 0.0
    keep = (rng.uniform(size=(nc, nt)) > 0.25).astype(np.float64)
    xq[2, 1] = xi[3]  # a row node on one of its own panel's points
    keep[2, 3] = 0.0
    return [torch.as_tensor(a, dtype=dtype) for a in (xi, xq, nrm, wphi, keep)]


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("nl,nq,chunks", [(4, 16, 2), (9, 16, 1), (9, 9, 3)], ids=["Q1", "Q2", "Q2_nq9"])
def test_plain_version_matches_pallas_kernel(nl, nq, chunks, dtype):
    """`chunks` panel chunks of C = 4 panels in the TPU kernel's layout are
    the same 4 * chunks panels unchunked in the port's."""
    C, nt = 4, 8
    xi, xq, nrm, wphi, keep = _random_inputs(nt=nt, nc=C * chunks, nq=nq, nl=nl, seed=nl + nq, dtype=dtype)
    V, K = slot_kernel.tile_slots_reference(xi, xq, nrm, wphi, keep)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Vp, Kp = pallas_tile_slots(
        jnp.asarray(xi.numpy(), jdt),
        jnp.asarray(xq.numpy(), jdt).reshape(chunks, C, nq, 3),
        jnp.asarray(nrm.numpy(), jdt).reshape(chunks, C, nq, 3),
        jnp.asarray(wphi.numpy(), jdt).reshape(chunks, C, nq, nl),
        jnp.asarray(keep.numpy(), jdt).reshape(chunks, C, nt),
        C=C,
        nq=nq,
        nl=nl,
        interpret=True,
    )
    assert V.shape == K.shape == (C * chunks * nl, 9, nt) == Vp.shape == Kp.shape
    assert np.all(np.isfinite(V.numpy())) and np.all(np.isfinite(K.numpy()))
    assert _rel(V.numpy(), Vp) <= TOL[dtype]
    assert _rel(K.numpy(), Kp) <= TOL[dtype]
    # masked pairs give exact zeros in both
    masked = np.repeat(keep.numpy() == 0, nl, axis=0)[:, None, :]
    assert np.all(np.where(masked, V.numpy(), 0.0) == 0)
    assert np.all(np.where(masked, np.asarray(Kp), 0.0) == 0)


def _pairwise_numpy(xi, xq, nrm, wphi, keep):
    nt, (nc, nq, nl) = xi.shape[0], wphi.shape
    V = np.zeros((nc, nl, 3, 3, nt))
    K = np.zeros((nc, nl, 3, 3, nt))
    for t in range(nt):
        for c in range(nc):
            if keep[c, t] == 0:
                continue
            for q in range(nq):
                R = xq[c, q] - xi[t]
                r = math.sqrt(R @ R)
                G = (np.eye(3) / r + np.outer(R, R) / r**3) / (8 * math.pi)
                Wn = -3.0 / (4 * math.pi) * (R @ nrm[c, q]) * np.outer(R, R) / r**5
                for l in range(nl):
                    V[c, l, :, :, t] += wphi[c, q, l] * G
                    K[c, l, :, :, t] -= wphi[c, q, l] * Wn
    return V.reshape(nc * nl, 9, nt), K.reshape(nc * nl, 9, nt)


@pytest.mark.parametrize("cell_chunk", [256, 4, 1])
def test_plain_version_matches_pairwise_loop(cell_chunk):
    args = _random_inputs(nl=5)
    V, K = slot_kernel.tile_slots_reference(*args, cell_chunk=cell_chunk)
    Vn, Kn = _pairwise_numpy(*(a.numpy() for a in args))
    assert np.abs(Kn).max() > 0
    assert _rel(V.numpy(), Vn) <= 1e-13
    assert _rel(K.numpy(), Kn) <= 1e-13


@pytest.mark.parametrize("kernel", ["free_space", "free_surface", "no_slip"])
def test_plain_version_matches_gathered_pair_blocks(kernel):
    """The slots of one row against every panel of create_sphere(1) equal the
    port's gathered (row, panel) pair blocks on the same rule, for all three
    Green's functions."""
    mesh = create_sphere(refinements=1)
    space = build_scalar_space(mesh, 1)
    cfg = assemble.AssemblyConfig(kernel=kernel, wall_axis=1, wall_position=-2.0)
    tables = assemble.build_assembly_tables(space, space, cfg)
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space))
    sp = support_points(euler, space, space)
    rows = torch.tensor([0, 7, 19])
    xq, nrm, wphi = assemble.slot_inputs(euler, tables)
    keep = slot_kernel.own_cell_keep(tables.cells_nodes_fe, rows, sp)
    V, K = slot_kernel.tile_slots_reference(
        sp[rows], xq, nrm, wphi, keep, kernel=kernel, wall_axis=1, wall_position=-2.0
    )
    Nc, nl = tables.cells_nodes_fe.shape
    cells = torch.as_tensor(tables.cells_nodes_map, dtype=torch.long)
    ec = euler[cells][None].expand(len(rows), Nc, 4, 3)
    flip = torch.as_tensor(tables.flip_sign)[None].expand(len(rows), Nc)
    rule = (tables.q_weights, tables.phi_map, tables.dphi_map, tables.phi_fe)
    Vl, Kl = assemble._pair_local_blocks(cfg, ec, flip, sp[rows], keep.T.contiguous(), rule)
    # [t, c, a, b, l] -> [c*nl + l, 3a + b, t]
    Vl = Vl.permute(1, 4, 2, 3, 0).reshape(Nc * nl, 9, len(rows))
    Kl = Kl.permute(1, 4, 2, 3, 0).reshape(Nc * nl, 9, len(rows))
    assert int((keep == 0).sum()) == 10  # two cube-corner nodes (3 panels) and one of valence 4
    assert _rel(V.numpy(), Vl.numpy()) <= 1e-13
    assert _rel(K.numpy(), Kl.numpy()) <= 1e-13


def test_cpu_wrapper_runs_plain_version():
    args = _random_inputs(seed=1)
    before = dict(slot_kernel.launches)
    V, K = slot_kernel.tile_slots(*args)
    Vr, Kr = slot_kernel.tile_slots_reference(*args)
    assert slot_kernel.launches == before
    assert torch.equal(V, Vr) and torch.equal(K, Kr)


@pytest.mark.parametrize("bad", ["shape", "dtype", "keep_shape"])
def test_wrapper_rejects_mismatched_inputs(bad):
    xi, xq, nrm, wphi, keep = _random_inputs(seed=2)
    err = ValueError
    if bad == "shape":
        nrm = nrm[:, :3]
    elif bad == "keep_shape":
        keep = keep.T.contiguous()
    else:
        wphi, err = wphi.float(), TypeError
    with pytest.raises(err):
        slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)


def _sphere_inputs(dtype, device, degree, refinements=3):
    """(xi, xq, nrm, wphi, keep) of the first row block of the gather
    assembly on create_sphere."""
    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, degree)
    tables = assemble.build_assembly_tables(
        space, space, assemble.AssemblyConfig(dtype=dtype, column_mode="gather")
    )
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    sp = support_points(euler, space, space)
    xi = sp[: assemble.slot_block_rows(tables)].contiguous()
    keep = slot_kernel.own_cell_keep(tables.cells_nodes_fe, torch.arange(xi.shape[0], device=device), xi)
    return (xi, *assemble.slot_inputs(euler, tables), keep)


def test_sphere_inputs_shapes():
    xi, xq, nrm, wphi, keep = _sphere_inputs(torch.float64, "cpu", 1)
    assert xi.shape == (386, 3) and xq.shape == nrm.shape == (384, 16, 3)
    assert wphi.shape == (384, 16, 4) and keep.shape == (384, 386)
    assert int((keep == 0).sum()) == 384 * 4  # every (panel, own node) pair
    assert all(t.is_contiguous() for t in (xi, xq, nrm, wphi, keep))
    xi, xq, nrm, wphi, keep = _sphere_inputs(torch.float64, "cpu", 2, refinements=1)
    assert wphi.shape == (24, 16, 9) and int((keep == 0).sum()) == 24 * 9


def test_slot_block_rows_bound_the_slot_tensors():
    """Two slot tensors of one row block stay within SLOT_BLOCK_BYTES: 512
    rows in f64 and 1,152 in f32 at 6,144 Q1 panels; all rows when they fit."""
    mesh = create_sphere(refinements=1)
    space = build_scalar_space(mesh, 1)
    for dtype, rows in ((torch.float64, 512), (torch.float32, 1152)):
        tables = assemble.build_assembly_tables(space, space, assemble.AssemblyConfig(dtype=dtype))
        big = type(tables)(
            **{**tables.__dict__, "cells_nodes_fe": np.zeros((6144, 4), dtype=np.int32)}
        )
        assert assemble.slot_block_rows(big) == rows
        item = torch.finfo(dtype).bits // 8
        assert 2 * 6144 * 4 * 9 * rows * item <= assemble.SLOT_BLOCK_BYTES
        assert assemble.slot_block_rows(tables) > 386


@pytest.fixture
def cuda_device():
    """The card, decided inside the test run (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K6 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("degree", [1, 2], ids=["Q1", "Q2"])
def test_kernel_matches_plain_version(cuda_device, dtype, degree):
    args = _sphere_inputs(dtype, cuda_device, degree, refinements=3 if degree == 1 else 2)
    before = slot_kernel.launches["tile_slots"]
    V, K = slot_kernel.tile_slots(*args)
    V2, K2 = slot_kernel.tile_slots(*args)
    torch.cuda.synchronize()
    assert slot_kernel.launches["tile_slots"] == before + 2
    assert torch.equal(V, V2) and torch.equal(K, K2)  # one owner per element
    Vr, Kr = slot_kernel.tile_slots_reference(*args)
    assert ((V - Vr).abs().max() / Vr.abs().max()).item() <= TOL[dtype]
    assert ((K - Kr).abs().max() / Kr.abs().max()).item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [4, 5, 9])
def test_kernel_random_inputs_and_masked_zero(cuda_device, nl):
    """Ragged shapes (rows and panels not multiples of the kernel's tiles),
    local-node counts on both pass widths and a masked exact R = 0, in f64."""
    args = [a.to(cuda_device) for a in _random_inputs(nt=137, nc=11, nq=9, nl=nl, seed=3)]
    V, K = slot_kernel.tile_slots(*args)
    Vr, Kr = slot_kernel.tile_slots_reference(*args)
    assert bool(torch.isfinite(V).all() and torch.isfinite(K).all())
    assert ((V - Vr).abs().max() / Vr.abs().max()).item() <= 1e-12
    assert ((K - Kr).abs().max() / Kr.abs().max()).item() <= 1e-12


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    xi, xq, nrm, wphi, keep = (a.to(cuda_device) for a in _random_inputs(seed=4))
    with pytest.raises(ValueError, match="contiguous"):
        slot_kernel.tile_slots(xi, xq, nrm, wphi, keep.T.contiguous().T)
