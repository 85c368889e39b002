"""The node-column entry point of the slot kernel K6, `tile_nodes`, and its
node groups (`bemstokes_tpu_torch/ops/slot_kernel.py`).

On the CPU:

- the group table: every node in exactly one group; each group's union
  holds every panel incident to its nodes and no other, each once, with
  every local node's place in the group (or -1 outside it); no two panels
  of a round share a node of the group, and no round holds more panels than
  the block has warps; the redundancy at 32 nodes a group stays below 1.6
  on create_sphere(3) Q1 (1.492 by this table);
- `tile_nodes` on CPU tensors returns `tile_nodes_reference` and launches
  nothing; the plain version against the JAX package's gather reduction of
  the Pallas TPU kernel's slots (`pallas_tile_slots(..., interpret=True)`,
  reduced as `bemstokes_tpu/ops/assemble.py:518-520` does): 1e-12 in f64;
- the wrapper rejects mismatched shapes, dtypes and devices.

On a card (marker `cuda`): the kernel against its plain version (1e-12 in
f64, 2e-5 in f32, as `tile_slots`), the same bits on a second call, a
ragged row count.  Run them with `python3 -m pytest
tests/test_torch_node_groups.py -m cuda` on a machine with a CUDA card and
nvcc.
"""

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


def _tables(refinements, degree, dtype=torch.float64):
    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, degree)
    tables = assemble.build_assembly_tables(
        space, space, assemble.AssemblyConfig(dtype=dtype, column_mode="gather")
    )
    return mesh, space, tables


def _inputs(refinements, degree, rows=None, dtype=torch.float64, device="cpu"):
    """(xi, xq, nrm, wphi, row_ids, groups) of the gather assembly: the first
    `rows` support points (all by default), each on its own panels."""
    mesh, space, tables = _tables(refinements, degree, dtype)
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    sp = support_points(euler, space, space)
    rows = sp.shape[0] if rows is None else rows
    ids = torch.arange(rows, device=device)
    return (sp[:rows].contiguous(), *assemble.slot_inputs(euler, tables), ids, slot_kernel.node_groups(tables))


@pytest.mark.parametrize("refinements,degree", [(2, 1), (3, 1), (2, 2)], ids=["sphere2_Q1", "sphere3_Q1", "sphere2_Q2"])
def test_groups_cover_each_node_once_and_each_incident_panel(refinements, degree):
    _, _, tables = _tables(refinements, degree)
    g = slot_kernel.node_groups(tables)
    cells = tables.cells_nodes_fe
    nl = cells.shape[1]
    assert np.array_equal(np.sort(g.nodes), np.arange(tables.n_nodes))
    assert g.node_ptr[0] == 0 and g.node_ptr[-1] == tables.n_nodes
    assert np.all(np.diff(g.node_ptr) >= 1) and g.group_max <= slot_kernel.NODE_GROUP_SIZE
    assert g.round_panel.shape[1] == slot_kernel.NODE_GROUP_WARPS
    union = 0
    for k in range(g.n_groups):
        group = g.nodes[g.node_ptr[k] : g.node_ptr[k + 1]]
        place = {int(j): p for p, j in enumerate(group)}
        rounds = range(g.round_ptr[k], g.round_ptr[k + 1])
        seen = []
        for r in rounds:
            touched = []
            for c, places in zip(g.round_panel[r], g.round_place[r]):
                if c < 0:
                    assert np.all(places == -1)
                    continue
                seen.append(int(c))
                expect = [place.get(int(j), -1) for j in cells[c]]
                assert places.tolist() == expect
                touched += [p for p in expect if p >= 0]
            # no two panels of a round share a node of the group
            assert len(touched) == len(set(touched))
        incident = set((tables.inc_slot[group][tables.inc_mask[group] > 0] // nl).tolist())
        assert sorted(seen) == sorted(incident)  # each incident panel once, no other
        union += len(seen)
    assert union == g.union_panels
    assert g.round_ptr[-1] == len(g.round_panel)


def test_redundancy_at_32_nodes_a_group():
    _, _, tables = _tables(3, 1)
    g = slot_kernel.node_groups(tables)
    assert g.group_max == 32
    assert g.redundancy < 1.6
    assert g.round_fill > 0.9
    assert slot_kernel.node_groups(tables) is g  # built once


def test_cpu_wrapper_runs_plain_version():
    args = _inputs(2, 1, rows=45)
    before = dict(slot_kernel.launches)
    V, K = slot_kernel.tile_nodes(*args)
    Vr, Kr = slot_kernel.tile_nodes_reference(*args)
    assert slot_kernel.launches == before
    assert V.shape == K.shape == (98, 9, 45)
    assert torch.equal(V, Vr) and torch.equal(K, Kr)


@pytest.mark.parametrize("degree", [1, 2], ids=["Q1", "Q2"])
def test_plain_version_matches_pallas_gather(degree):
    """The JAX package's gather path on the TPU kernel: slots from
    `pallas_tile_slots` in interpret mode (one chunk of all panels), own-cell
    pairs masked by the same integer test, reduced over each node's
    incident slots."""
    xi, xq, nrm, wphi, ids, groups = _inputs(1, degree)
    V, K = slot_kernel.tile_nodes_reference(xi, xq, nrm, wphi, ids, groups)
    nc, nq, nl = wphi.shape
    keep = slot_kernel.own_cell_keep(groups.cells_fe, ids, xi)
    Vs, Ks = pallas_tile_slots(
        jnp.asarray(xi.numpy()),
        jnp.asarray(xq.numpy())[None],
        jnp.asarray(nrm.numpy())[None],
        jnp.asarray(wphi.numpy())[None],
        jnp.asarray(keep.numpy())[None],
        C=nc,
        nq=nq,
        nl=nl,
        interpret=True,
    )
    m = jnp.asarray(groups.inc_mask)[:, :, None, None]
    inc = jnp.asarray(groups.inc_slot)
    Vj = np.asarray((Vs[inc] * m).sum(axis=1))
    Kj = np.asarray((Ks[inc] * m).sum(axis=1))
    assert int((keep == 0).sum()) == nc * nl  # every (panel, own node) pair
    assert np.abs(V.numpy() - Vj).max() / np.abs(Vj).max() <= 1e-12
    assert np.abs(K.numpy() - Kj).max() / np.abs(Kj).max() <= 1e-12


@pytest.mark.parametrize("bad", ["shape", "dtype", "ids_shape", "ids_dtype", "ids_device", "groups"])
def test_wrapper_rejects_mismatched_inputs(bad):
    xi, xq, nrm, wphi, ids, groups = _inputs(1, 1, rows=7)
    err = ValueError
    if bad == "shape":
        nrm = nrm[:, :3]
    elif bad == "dtype":
        wphi, err = wphi.float(), TypeError
    elif bad == "ids_shape":
        ids = ids[:-1]
    elif bad == "ids_dtype":
        ids, err = ids.double(), TypeError
    elif bad == "ids_device":
        ids = ids.to("meta")
    else:
        groups = slot_kernel.node_groups(_tables(2, 1)[2])
    with pytest.raises(err):
        slot_kernel.tile_nodes(xi, xq, nrm, wphi, ids, groups)


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
    args = _inputs(3 if degree == 1 else 2, degree, rows=203, dtype=dtype, device=cuda_device)
    before = slot_kernel.launches["tile_nodes"]
    V, K = slot_kernel.tile_nodes(*args)
    V2, K2 = slot_kernel.tile_nodes(*args)
    torch.cuda.synchronize()
    assert slot_kernel.launches["tile_nodes"] == before + 2
    assert torch.equal(V, V2) and torch.equal(K, K2)  # one schedule, no atomics
    Vr, Kr = slot_kernel.tile_nodes_reference(*args)
    assert ((V - Vr).abs().max() / Vr.abs().max()).item() <= TOL[dtype]
    assert ((K - Kr).abs().max() / Kr.abs().max()).item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    xi, xq, nrm, wphi, ids, groups = _inputs(1, 1, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        slot_kernel.tile_nodes(xi, xq, nrm.transpose(0, 1).contiguous().transpose(0, 1), wphi, ids, groups)
