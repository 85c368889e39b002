"""The column modes of the port's assembly (`bemstokes_tpu_torch/ops/
assemble.py`: "gather" through the slot tensors of `ops.slot_kernel`,
"scatter", "node") against the JAX package's, f64 on the CPU, where every
kernel wrapper runs its plain torch version.

- `assemble_V_K` in each mode against JAX `assemble_V_K` with
  `backend="jax"` in the same mode, and in gather mode also against the
  Pallas slot kernel in interpret mode (`backend="pallas_interpret"`), for
  the three Green's functions, whole and on a row range: atol 1e-11 (the
  class of tests/test_torch_assemble.py: the summation orders differ);
- once with `quad_order_far` set (near corrections) on a sheared sphere,
  where no two panel-centre distances tie (`jax.lax.top_k` breaks exact ties
  differently under `jit`);
- the slice as a whole: `StokesBEMProblem.solve_frame` of the JAX package
  with its default configuration, which is gather mode, against the port in
  gather mode, a fresh and a stale frame: forces and rigid velocities to
  1e-9 relative, equal iterations; and the port's gather, scatter, node and
  node_planes (K4 layout) frames against each other to 1e-9.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.ops.assemble as asm_j
from bemstokes_tpu.config import ProblemConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.fem.geometry as geo_t
import bemstokes_tpu_torch.mesh.dofs as dofs_t
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.ops.assemble as asm_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.ops import node_kernel, slot_kernel
from bemstokes_tpu_torch.problem import ASSEMBLY_BACKENDS, StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

KERNELS = ["free_space", "free_surface", "no_slip"]
SHEAR = np.array([[1.0, 0.13, -0.07], [0.0, 1.0, 0.11], [0.0, 0.0, 1.0]])


def _inputs(kernel, mode, backend="jax", refinements=2, shear=False, port_only=None, **cfg_kw):
    """((euler, support points, tables) of the JAX package, the same of the
    port) on create_sphere(refinements), wall at y = -2."""
    mj = fac_j.create_sphere(refinements=refinements)
    mt = fac_t.create_sphere(refinements=refinements)
    sj, st = dofs_j.build_scalar_space(mj, 1), dofs_t.build_scalar_space(mt, 1)
    kw = dict(kernel=kernel, wall_axis=1, wall_position=-2.0, column_mode=mode, **cfg_kw)
    tj = asm_j.build_assembly_tables(sj, sj, asm_j.AssemblyConfig(backend=backend, **kw))
    tt = asm_t.build_assembly_tables(st, st, asm_t.AssemblyConfig(**kw, **(port_only or {})))
    e = geo_t.euler_from_mesh(mt.vertices, st)
    if shear:
        e = e @ SHEAR.T
    ej, et = jnp.asarray(e), torch.as_tensor(e)
    return (ej, geo_j.support_points(ej, sj, sj), tj), (et, geo_t.support_points(et, st, st), tt)


@pytest.mark.parametrize("mode", ["gather", "scatter", "node"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_assemble_matches_jax_in_the_same_mode(kernel, mode):
    jax_in, torch_in = _inputs(kernel, mode)
    n = torch_in[2].n_nodes
    for row_range in (None, (17, 60)):
        Vj, Kj = asm_j.assemble_V_K(*jax_in, row_range=row_range)
        Vt, Kt = asm_t.assemble_V_K(*torch_in, row_range=row_range)
        nr = n if row_range is None else row_range[1] - row_range[0]
        assert Vt.shape == Kt.shape == (3 * nr, 3 * n)
        assert np.allclose(np.asarray(Vj), Vt.numpy(), rtol=0, atol=1e-11)
        assert np.allclose(np.asarray(Kj), Kt.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("kernel", KERNELS)
def test_gather_matches_pallas_slot_kernel(kernel):
    """JAX with backend="pallas_interpret" runs the Pallas slot kernel in
    free space and its XLA gather path for the image Green's functions, as
    the port runs K6 and plain torch."""
    jax_in, torch_in = _inputs(kernel, "gather", backend="pallas_interpret")
    for row_range in (None, (17, 60)):
        Vj, Kj = asm_j.assemble_V_K(*jax_in, row_range=row_range)
        Vt, Kt = asm_t.assemble_V_K(*torch_in, row_range=row_range)
        assert np.allclose(np.asarray(Vj), Vt.numpy(), rtol=0, atol=1e-11)
        assert np.allclose(np.asarray(Kj), Kt.numpy(), rtol=0, atol=1e-11)


@pytest.mark.parametrize("mode", ["gather", "scatter", "node"])
def test_near_corrections_on_a_sheared_sphere(mode):
    jax_in, torch_in = _inputs(
        "free_space", mode, shear=True, quad_order=6, quad_order_far=3, near_panels=12
    )
    assert torch_in[2].hq_weights is not None
    Vj, Kj = asm_j.assemble_V_K(*jax_in)
    Vt, Kt = asm_t.assemble_V_K(*torch_in)
    assert np.allclose(np.asarray(Vj), Vt.numpy(), rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kj), Kt.numpy(), rtol=0, atol=1e-11)
    # the near delta is there: the far rule alone differs
    coarse = dataclasses.replace(
        torch_in[2], hq_weights=None, hphi_map=None, hdphi_map=None, hphi_fe=None
    )
    Vc, _ = asm_t.assemble_V_K(torch_in[0], torch_in[1], coarse)
    assert (Vc - Vt).abs().max() > 1e-6


@pytest.mark.parametrize("kernel", KERNELS)
def test_port_modes_agree(kernel):
    """gather, scatter and node (dense and, in free space, planes layout)
    give one operator: 1e-13 of max; the planes layout gives node mode's
    bits."""
    out = {}
    for mode in ("node", "gather", "scatter"):
        _, torch_in = _inputs(kernel, mode, refinements=1)
        out[mode] = asm_t.assemble_V_K(*torch_in)
    for mode in ("gather", "scatter"):
        for A, B in zip(out[mode], out["node"]):
            assert ((A - B).abs().max() / B.abs().max()).item() <= 1e-13
    _, torch_in = _inputs(kernel, "node", refinements=1, port_only=dict(node_layout="planes"))
    if kernel == "free_space":
        V, K = asm_t.assemble_V_K(*torch_in)
        assert torch.equal(V, out["node"][0]) and torch.equal(K, out["node"][1])
    else:
        with pytest.raises(ValueError, match="free space only"):
            asm_t.assemble_V_K(*torch_in)


def test_unknown_mode_raises():
    _, torch_in = _inputs("free_space", "columns", refinements=1)
    with pytest.raises(ValueError, match="column_mode"):
        asm_t.assemble_V_K(*torch_in)


# ---- the slice as a whole -----------------------------------------------------


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _rotation(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def frames():
    """A fresh and a stale frame (a rigid motion of the first) of the JAX
    package with its default configuration, and of the port in each
    assembly backend, on create_sphere(2)."""
    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0)
    pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
    assert pj.asm_cfg.column_mode == "gather"
    e0 = np.asarray(pj.initial_euler())
    eulers = [e0, e0 @ _rotation(0.3).T + np.array([0.5, -0.2, 0.1])]
    sdot = np.zeros(3 * pj.n)
    out = {"jax": [pj.solve_frame(jnp.asarray(e), jnp.asarray(sdot)) for e in eulers]}
    before = dict(slot_kernel.launches), dict(node_kernel.launches)
    for backend in ("gather", "scatter", "jax", "node_planes"):
        tcfg = dataclasses.replace(from_dict(dataclasses.asdict(cfg)), assembly_backend=backend)
        pt = ProblemT(fac_t.create_sphere(refinements=2), tcfg, device="cpu")
        assert (pt.asm_cfg.column_mode, pt.asm_cfg.node_layout) == ASSEMBLY_BACKENDS[backend]
        out[backend] = [result_to_numpy(pt.solve_frame(e, sdot)) for e in eulers]
    # CPU tensors: plain versions, no launch
    assert (dict(slot_kernel.launches), dict(node_kernel.launches)) == before
    return out


@pytest.mark.parametrize("frame", [0, 1], ids=["fresh", "stale"])
def test_gather_frame_matches_jax_default(frames, frame):
    rj, rt = frames["jax"][frame], frames["gather"][frame]
    assert bool(rj["refactored"]) == rt["refactored"] == (frame == 0)
    assert int(rj["iterations"]) == rt["iterations"]
    assert _rel(rt["stokes_forces"], rj["stokes_forces"]) <= 1e-9
    assert _rel(rt["rigid_velocities"], rj["rigid_velocities"]) <= 1e-9
    assert _rel(rt["rigid_forces_pole"], rj["rigid_forces_pole"]) <= 1e-9
    # the drag of a unit sphere at 98 nodes (ROADMAP.md: 1.03e-2 off 6 pi)
    assert abs(abs(rt["rigid_forces_pole"][0]) / (6 * np.pi) - 1) < 1.1e-2


@pytest.mark.parametrize("backend", ["scatter", "jax", "node_planes"])
@pytest.mark.parametrize("frame", [0, 1], ids=["fresh", "stale"])
def test_port_frames_agree_across_backends(frames, backend, frame):
    ra, rb = frames[backend][frame], frames["gather"][frame]
    assert ra["iterations"] == rb["iterations"]
    for key in ("stokes_forces", "rigid_velocities", "rigid_forces_pole"):
        assert _rel(ra[key], rb[key]) <= 1e-9, key
    for key in ("V", "K"):
        assert _rel(ra["operators"][key], rb["operators"][key]) <= 1e-12


def test_assembly_backend_is_checked():
    cfg = from_dict(dataclasses.asdict(ProblemConfig()))
    with pytest.raises(ValueError, match="assembly_backend"):
        ProblemT(fac_t.create_sphere(refinements=1), dataclasses.replace(cfg, assembly_backend="slots"), device="cpu")
    wall = dataclasses.replace(cfg, assembly_backend="node_planes", no_slip_kernel=True)
    with pytest.raises(ValueError, match="free space only"):
        ProblemT(fac_t.create_sphere(refinements=1), wall, device="cpu")


def test_matrix_free_blocks_stay_on_node_mode():
    cfg = from_dict(dataclasses.asdict(ProblemConfig(matrix_free=True)))
    pt = ProblemT(
        fac_t.create_sphere(refinements=1), dataclasses.replace(cfg, assembly_backend="gather"), device="cpu"
    )
    assert (pt.asm_cfg.column_mode, pt.asm_cfg.node_layout) == ("node", "dense")


def test_a_gather_config_loads_in_the_jax_package():
    """The port's backend names are read by the JAX package as its XLA
    gather path."""
    tcfg = dataclasses.replace(from_dict(dataclasses.asdict(ProblemConfig())), assembly_backend="gather")
    pj = ProblemJ(fac_j.create_sphere(refinements=1), ProblemConfig(**{
        f.name: getattr(tcfg, f.name) for f in dataclasses.fields(ProblemConfig)
        if f.name in ("assembly_backend", "grid_type", "dtype")
    }))
    assert pj.asm_cfg.column_mode == "gather"
