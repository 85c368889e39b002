"""The slot kernel K6: the panel-centric body of the "gather" assembly, as a
CUDA kernel for Hopper beside its plain torch version.

It replaces the Pallas TPU kernel `bemstokes_tpu/ops/pallas_assemble.py:45`
`_kernel` (`pallas_tile_slots`, `:114`): the Green's functions once per
(collocation row, panel quadrature point), contracted over the panel's
points with the JxW-weighted shape values of its `nl` local nodes, own-cell
pairs masked by `keep`.  The result is a pair of slot tensors
`[Nc * nl, 9, T]` that the incidence gather-reduce of `ops.assemble` maps to
node columns.  `csrc/tile_slots.cu` carries the note on what bounds the
kernel on the card (its stores) and what its design does about that.

Unlike the TPU kernel the panels come unchunked and in the assembly's own
layouts (`xq`, `nrm` `[Nc, nq, 3]`, `wphi` `[Nc, nq, nl]`): the TPU kernel's
panel chunks `C`, its SoA transposes and the far-away padding points of a
ragged last chunk have no meaning here.

`tile_slots(xi, xq, nrm, wphi, keep)` runs the kernel on CUDA tensors and
`tile_slots_reference` on CPU tensors; there is no fallback from one to the
other.  `ops/cuda_build.py` compiles the source with nvcc at first use and
loads it with ctypes.

The gather assembly itself takes the source's second entry point,
`tile_nodes(xi, xq, nrm, wphi, row_ids, groups)`: the same Green's
functions, contracted and summed into the node columns `[n, 9, T]` inside
the kernel, so that the slot tensors never reach memory.  The nodes are cut
into groups (`node_groups`, a table built once per set of assembly tables);
a thread block takes a tile of rows and one group, and evaluates the union
of the panels incident to the group's nodes.  Its plain version
`tile_nodes_reference` is `gather_reduce` of `tile_slots_reference`, with the
own-cell mask of `own_cell_keep`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib

import numpy as np
import torch

from ..kernels.images import image_point
from . import cuda_build
from .node_kernel import KERNEL_FREE_SPACE, eval_G_Wn, refuse_plane

SOURCE = cuda_build.CSRC / "tile_slots.cu"

#: kernel launches made by `tile_slots` and `tile_nodes` (plain counters:
#: set them to 0 before a run and read them after to see that the run went
#: through the kernels)
launches = {"tile_slots": 0, "tile_nodes": 0}
#: the (row, panel) pairs the launches of `tile_nodes` covered, T * Nc each,
#: per "f32" or "f64" (launches of different row counts add up comparably)
pairs = {"f32": 0, "f64": 0}

#: nodes a group of `tile_nodes` (the last group takes the rest); a block's
#: accumulators [group, 12, 32 rows] take 96 KiB of shared memory in f64,
#: so that two blocks fit on an SM
NODE_GROUP_SIZE = 32
#: warps of a `tile_nodes` block (csrc/tile_slots.cu NODE_WARPS): the
#: panels a round of a group's schedule holds
NODE_GROUP_WARPS = 4


def _declare(lib):
    for name in ("tile_slots_f32", "tile_slots_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    for name in ("tile_nodes_f32", "tile_nodes_f64"):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * 13
            + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int


def _check_inputs(xi, xq, nrm, wphi, keep, fn="tile_slots"):
    refuse_plane(fn, xi)
    nt, nc, nq = xi.shape[0], xq.shape[0], xq.shape[1]
    nl = wphi.shape[-1]
    shapes = {
        "xi": (xi, (nt, 3)),
        "xq": (xq, (nc, nq, 3)),
        "nrm": (nrm, (nc, nq, 3)),
        "wphi": (wphi, (nc, nq, nl)),
    }
    if keep is not None:
        shapes["keep"] = (keep, (nc, nt))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != xi.dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype}, xi is {xi.dtype}")
        if t.device != xi.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, xi on {xi.device}")
    return nt, nc, nq, nl


def tile_slots(xi, xq, nrm, wphi, keep):
    """Free-space slot tensors (V_slots, K_slots) `[Nc * nl, 9, T]` of the
    collocation rows `xi [T, 3]` against every panel: quadrature points `xq`
    and unit normals `nrm` `[Nc, nq, 3]`, weighted shape values
    `wphi [Nc, nq, nl]` (JxW * phi), and `keep [Nc, T]`, 1 on smooth pairs
    and 0 where row t is a node of panel c.  Entry (c * nl + l, 3a + b, t).

    A CUDA tensor launches the kernel K6 (float32 or float64, contiguous
    inputs) or raises; a CPU tensor runs `tile_slots_reference`."""
    nt, nc, nq, nl = _check_inputs(xi, xq, nrm, wphi, keep)
    if xi.device.type == "cpu":
        return tile_slots_reference(xi, xq, nrm, wphi, keep)
    if xi.device.type != "cuda":
        raise ValueError(f"tile_slots: no kernel for device {xi.device}")
    if xi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tile_slots: the kernel takes float32 or float64, got {xi.dtype}")
    for name, t in (("xi", xi), ("xq", xq), ("nrm", nrm), ("wphi", wphi), ("keep", keep)):
        if not t.is_contiguous():
            raise ValueError(f"tile_slots: {name} must be contiguous")
    suffix = "f64" if xi.dtype == torch.float64 else "f32"
    fn = getattr(cuda_build.library(SOURCE, _declare), f"tile_slots_{suffix}")
    with torch.cuda.device(xi.device):
        V = torch.empty((nc * nl, 9, nt), dtype=xi.dtype, device=xi.device)
        K = torch.empty_like(V)
        rc = fn(
            xi.data_ptr(),
            xq.data_ptr(),
            nrm.data_ptr(),
            wphi.data_ptr(),
            keep.data_ptr(),
            V.data_ptr(),
            K.data_ptr(),
            nt,
            nc,
            nq,
            nl,
            torch.cuda.current_stream(xi.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_slots: kernel launch failed with CUDA error {rc}")
    launches["tile_slots"] += 1
    return V, K


def tile_slots_reference(
    xi,
    xq,
    nrm,
    wphi,
    keep,
    cell_chunk: int = 256,
    kernel: str = KERNEL_FREE_SPACE,
    wall_axis: int = 1,
    wall_position: float = 0.0,
):
    """Plain torch version of K6: the `pair_blocks` einsum of the JAX
    package (`bemstokes_tpu/ops/assemble.py:457-483`), panels in chunks of
    `cell_chunk` so the pairwise intermediates stay
    [T, cell_chunk, nq, 3, 3].  With `kernel="free_surface"` / `"no_slip"`
    it evaluates the image system of the plane wall x[wall_axis] =
    wall_position instead (the JAX package keeps those on its XLA path, and
    K6 is free space only)."""
    nt, nc, nq, nl = _check_inputs(xi, xq, nrm, wphi, keep)
    dt, dev = xi.dtype, xi.device
    V = torch.empty((nc, nl, 3, 3, nt), dtype=dt, device=dev)
    K = torch.empty_like(V)
    image = kernel != KERNEL_FREE_SPACE
    if image:
        xi_img = image_point(xi, wall_axis, wall_position)
    for c0 in range(0, nc, cell_chunk):
        c1 = min(c0 + cell_chunk, nc)
        sing = (keep[c0:c1] == 0).T[:, :, None, None]  # [T, cc, 1, 1]
        # masked pairs can hit R == 0 exactly (a row node on one of its own
        # panels): a dummy offset keeps them finite, `keep` zeroes them below
        R = xq[None, c0:c1] - xi[:, None, None, :]  # [T, cc, nq, 3]
        R = torch.where(sing, torch.ones_like(R), R)
        if image:
            R_img = xq[None, c0:c1] - xi_img[:, None, None, :]
            R_img = torch.where(sing, torch.ones_like(R_img), R_img)
        else:
            R_img = R
        G, Wn = eval_G_Wn(kernel, wall_axis, R, R_img, nrm[None, c0:c1])
        keep_c = keep[c0:c1, None, None, None, :]  # [cc, 1, 1, 1, T]
        V[c0:c1] = torch.einsum("tcqab,cql->clabt", G, wphi[c0:c1]) * keep_c
        # minus sign: exterior problem (reference `:2941-2947`)
        K[c0:c1] = -torch.einsum("tcqab,cql->clabt", Wn, wphi[c0:c1]) * keep_c
    return V.reshape(nc * nl, 9, nt), K.reshape(nc * nl, 9, nt)


def own_cell_keep(cells_fe, node_ids: torch.Tensor, like: torch.Tensor):
    """keep [Nc, T] in `like`'s dtype: 0 where row node_ids[t] is a node of
    panel c (`cells_fe [Nc, nl]`, a singular pair, left to the singular
    rule), 1 elsewhere."""
    cells = torch.as_tensor(np.asarray(cells_fe), dtype=torch.long, device=like.device)
    sing = torch.any(cells[:, :, None] == node_ids[None, None, :], dim=1)
    return (~sing).to(like.dtype).contiguous()


def gather_reduce(slots: torch.Tensor, inc_slot, inc_mask) -> torch.Tensor:
    """The incidence gather-reduce: slot tensor [Nc*nl, 9, T] -> node columns
    [n, 9, T], column j the sum of its incident slots `inc_slot[j]` with
    `inc_mask[j]` zeroing the padding (one index_select per valence
    position, in valence order; no scatter)."""
    inc_slot = torch.as_tensor(np.asarray(inc_slot), dtype=torch.long, device=slots.device)
    inc_mask = torch.as_tensor(np.asarray(inc_mask), dtype=slots.dtype, device=slots.device)
    out = None
    for v in range(inc_slot.shape[1]):
        part = slots.index_select(0, inc_slot[:, v]) * inc_mask[:, v, None, None]
        out = part if out is None else out.add_(part)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class NodeGroups:
    """The node groups of `tile_nodes` for one mesh: a CSR of each group's
    nodes, and a CSR of the union of the panels incident to each group's
    nodes, laid out in rounds of NODE_GROUP_WARPS panels (one panel a warp;
    -1 pads a round).  No two panels of a round share a node of the group,
    so the warps of a block add into the group's accumulators without
    conflict, and each accumulator takes its terms in the schedule's order
    on every run.  Also the assembly tables' incidence arrays (the same
    arrays, not copies), which the plain version reduces with."""

    n_nodes: int
    cells_fe: np.ndarray  # [Nc, nl] int32
    inc_slot: np.ndarray  # [n, vmax]: the assembly tables' incidence
    inc_mask: np.ndarray  # [n, vmax]
    node_ptr: np.ndarray  # [G + 1] int32: group g holds nodes[node_ptr[g]:node_ptr[g + 1]]
    nodes: np.ndarray  # [n] int32
    round_ptr: np.ndarray  # [G + 1] int32: group g's rounds
    round_panel: np.ndarray  # [R, NODE_GROUP_WARPS] int32: a round's panels, -1 for none
    round_place: np.ndarray  # [R, NODE_GROUP_WARPS, nl] int32: each local node's place in the group, -1 outside
    union_panels: int  # the unions' sizes summed over the groups
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_groups(self) -> int:
        return len(self.node_ptr) - 1

    @property
    def group_max(self) -> int:
        return int(np.diff(self.node_ptr).max())

    @property
    def round_max(self) -> int:
        return int(np.diff(self.round_ptr).max())

    @property
    def redundancy(self) -> float:
        """Panels evaluated per panel of the mesh: the unions' sizes summed
        over the groups, over Nc."""
        return self.union_panels / self.cells_fe.shape[0]

    @property
    def round_fill(self) -> float:
        """Share of the rounds' panel places that hold a panel."""
        return self.union_panels / self.round_panel.size

    def on(self, device) -> tuple:
        """(cells_fe, node_ptr, nodes, round_ptr, round_panel, round_place)
        as contiguous int32 tensors on `device`, copied once per device."""
        key = str(torch.device(device))
        if key not in self._device:
            self._device[key] = tuple(
                torch.as_tensor(a, dtype=torch.int32, device=device).contiguous()
                for a in (self.cells_fe, self.node_ptr, self.nodes, self.round_ptr, self.round_panel, self.round_place)
            )
        return self._device[key]


def _rounds(panels, cells, place):
    """Rounds of at most NODE_GROUP_WARPS panels, no two sharing a node of the group
    (`place`: node -> its place in the group), and each panel's local nodes'
    places.  The panels with the most nodes in the group go first, each into
    the least full round that takes it; the count of rounds starts at the
    fewest the union's size allows and grows by one whenever a panel finds
    no round."""
    inside = {c: [place.get(int(j), -1) for j in cells[c]] for c in panels}
    order = sorted(panels, key=lambda c: (-sum(p >= 0 for p in inside[c]), c))
    warps = NODE_GROUP_WARPS
    count = max(1, -(-len(panels) // warps))
    while True:
        rounds = [(set(), []) for _ in range(count)]
        for c in order:
            mine = {p for p in inside[c] if p >= 0}
            free = [r for r in rounds if len(r[1]) < warps and not (r[0] & mine)]
            if not free:
                break
            used, members = min(free, key=lambda r: len(r[1]))
            used |= mine
            members.append(c)
        else:
            return [sorted(members) for _, members in rounds], inside
        count += 1


def build_node_groups(cells_fe, n_nodes, inc_slot, inc_mask, size=NODE_GROUP_SIZE):
    """The `NodeGroups` of a mesh: its nodes sorted by their lowest incident
    panel (so that a group's panels lie close together and few panels are
    shared with other groups), cut into groups of `size` (the kernel's
    NODE_GROUP_SIZE; tests cut smaller groups), each group's union of
    incident panels laid out in rounds."""
    warps = NODE_GROUP_WARPS
    cells = np.asarray(cells_fe, dtype=np.int64)
    Nc, nl = cells.shape
    inc_slot = np.asarray(inc_slot)
    inc_mask = np.asarray(inc_mask)
    lowest = np.full(n_nodes, Nc, dtype=np.int64)
    np.minimum.at(lowest, cells.reshape(-1), np.repeat(np.arange(Nc), nl))
    order = np.lexsort((np.arange(n_nodes), lowest))
    node_ptr = list(range(0, n_nodes, size)) + [n_nodes]
    round_ptr, panels_out, places_out, union = [0], [], [], 0
    for g in range(len(node_ptr) - 1):
        group = order[node_ptr[g] : node_ptr[g + 1]]
        place = {int(j): k for k, j in enumerate(group)}
        panels = np.unique(inc_slot[group][inc_mask[group] > 0] // nl).tolist()
        union += len(panels)
        rounds, inside = _rounds(panels, cells, place)
        for members in rounds:
            pad = warps - len(members)
            panels_out.append(members + [-1] * pad)
            places_out.append([inside[c] for c in members] + [[-1] * nl] * pad)
        round_ptr.append(round_ptr[-1] + len(rounds))
    return NodeGroups(
        n_nodes=int(n_nodes),
        cells_fe=np.ascontiguousarray(cells, dtype=np.int32),
        inc_slot=inc_slot,
        inc_mask=inc_mask,
        node_ptr=np.asarray(node_ptr, dtype=np.int32),
        nodes=order.astype(np.int32),
        round_ptr=np.asarray(round_ptr, dtype=np.int32),
        round_panel=np.asarray(panels_out, dtype=np.int32).reshape(-1, warps),
        round_place=np.asarray(places_out, dtype=np.int32).reshape(-1, warps, nl),
        union_panels=int(union),
    )


#: node groups built so far, by mesh (a few meshes at most)
_GROUPS: dict = {}


def node_groups(tables) -> NodeGroups:
    """The `NodeGroups` of assembly tables (`cells_nodes_fe`, `n_nodes`,
    `inc_slot`, `inc_mask`), built once and kept for tables of the same
    mesh."""
    cells, inc_slot, inc_mask = (
        np.ascontiguousarray(a) for a in (tables.cells_nodes_fe, tables.inc_slot, tables.inc_mask)
    )
    digest = hashlib.sha1(cells.tobytes() + inc_slot.tobytes() + inc_mask.tobytes()).hexdigest()
    key = (digest, cells.shape, int(tables.n_nodes))
    if key not in _GROUPS:
        if len(_GROUPS) >= 8:
            _GROUPS.pop(next(iter(_GROUPS)))
        _GROUPS[key] = build_node_groups(cells, tables.n_nodes, inc_slot, inc_mask)
    return _GROUPS[key]


def _check_node_inputs(xi, xq, nrm, wphi, row_ids, groups):
    nt, nc, nq, nl = _check_inputs(xi, xq, nrm, wphi, None, "tile_nodes")
    if tuple(groups.cells_fe.shape) != (nc, nl):
        raise ValueError(f"tile_nodes: the node groups are of {groups.cells_fe.shape} panel nodes, not {(nc, nl)}")
    if tuple(row_ids.shape) != (nt,):
        raise ValueError(f"tile_nodes: row_ids has shape {tuple(row_ids.shape)}, expected {(nt,)}")
    if row_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tile_nodes: row_ids must be int32 or int64, got {row_ids.dtype}")
    if row_ids.device != xi.device:
        raise ValueError(f"tile_nodes: row_ids is on {row_ids.device}, xi on {xi.device}")
    return nt, nc, nq, nl


def tile_nodes(xi, xq, nrm, wphi, row_ids, groups: NodeGroups):
    """Free-space node columns (V, K) `[n, 9, T]` of the collocation rows
    `xi [T, 3]`, row t the support point of node `row_ids[t]`: column node j
    the sum over its incident panels' slots, own-cell pairs (row node on the
    panel) left out, entry (j, 3a + b, t).  Panels as for `tile_slots`;
    `groups` from `node_groups` of the same mesh.

    A CUDA tensor launches the kernel (float32 or float64, contiguous inputs)
    or raises; a CPU tensor runs `tile_nodes_reference`."""
    nt, nc, nq, nl = _check_node_inputs(xi, xq, nrm, wphi, row_ids, groups)
    if xi.device.type == "cpu":
        return tile_nodes_reference(xi, xq, nrm, wphi, row_ids, groups)
    if xi.device.type != "cuda":
        raise ValueError(f"tile_nodes: no kernel for device {xi.device}")
    if xi.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tile_nodes: the kernel takes float32 or float64, got {xi.dtype}")
    for name, t in (("xi", xi), ("xq", xq), ("nrm", nrm), ("wphi", wphi)):
        if not t.is_contiguous():
            raise ValueError(f"tile_nodes: {name} must be contiguous")
    suffix = "f64" if xi.dtype == torch.float64 else "f32"
    fn = getattr(cuda_build.library(SOURCE, _declare), f"tile_nodes_{suffix}")
    tables = groups.on(xi.device)
    with torch.cuda.device(xi.device):
        ids = row_ids.to(torch.int32).contiguous()
        V = torch.empty((groups.n_nodes, 9, nt), dtype=xi.dtype, device=xi.device)
        K = torch.empty_like(V)
        rc = fn(
            xi.data_ptr(),
            xq.data_ptr(),
            nrm.data_ptr(),
            wphi.data_ptr(),
            ids.data_ptr(),
            *(t.data_ptr() for t in tables),
            V.data_ptr(),
            K.data_ptr(),
            nt,
            nc,
            nq,
            nl,
            groups.n_groups,
            groups.group_max,
            groups.round_max,
            torch.cuda.current_stream(xi.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"tile_nodes: kernel launch failed with CUDA error {rc}")
    launches["tile_nodes"] += 1
    pairs[suffix] += nt * nc
    return V, K


def tile_nodes_reference(xi, xq, nrm, wphi, row_ids, groups: NodeGroups):
    """Plain torch version of `tile_nodes`: the incidence gather-reduce of
    `tile_slots_reference`, own-cell pairs masked by `own_cell_keep`."""
    _check_node_inputs(xi, xq, nrm, wphi, row_ids, groups)
    keep = own_cell_keep(groups.cells_fe, row_ids, xi)
    V, K = tile_slots_reference(xi, xq, nrm, wphi, keep)
    return gather_reduce(V, groups.inc_slot, groups.inc_mask), gather_reduce(K, groups.inc_slot, groups.inc_mask)
