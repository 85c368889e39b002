"""Row-partitioned distributed operators over a `torch.distributed` process
group (port of `bemstokes_tpu/parallel/sharded.py`; the reference's Epetra
row maps + distributed SpMV, row partition `source/bem_stokes.cc:1599-1647`,
vmult usage `:4332`).

One process per device.  The global node set is padded to W * nloc nodes
(W the world size); rank k owns the contiguous node slab [k*nloc,
(k+1)*nloc) and holds the [d*nloc, d*n] block of rows (a, i) -> a*nloc + i
for its nodes: its *slab*.  A slab vector is the rank's [d*nloc] piece.
Columns, and therefore the GMRES iterates, stay in the global
component-blocked flat layout, the same tensor on every rank (replicated).

Where the JAX package's `shard_map` bodies reshard implicitly (a row-sharded
result read as a replicated value), the port gathers explicitly: every
collective of this package is one call of `collective` on the mesh's group,
at the place where the JAX package has its `psum`, `all_gather` or
`ppermute`.  `collective` counts each in the tracer (`utils/timers.py`):
"collectives", one a call, and "collective bytes", the bytes this rank
receives from the others, on the innermost span.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops.assemble import AssemblyTables, assemble_rows
from ..utils import timers

COLLECTIVES = "collectives"
COLLECTIVE_BYTES = "collective bytes"


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The 1-D row partition: a process group, this process's rank in it,
    its size and the device this rank's tensors live on."""

    group: object
    rank: int
    world: int
    device: torch.device

    def agree(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as rank 0 has it (a broadcast when the group has more than one
        rank).  Every scalar that decides a branch of a loop that runs
        collectives passes through here, so that no rank leaves the loop at
        another iteration than the others."""
        return collective("broadcast", t, self)


def collective(kind: str, t: torch.Tensor, mesh: RowMesh, src: int = 0, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """One collective of the mesh's group on `t`, counted.  `kind`:

    - "broadcast": `t` as rank `src` of the mesh has it (in place on a
      contiguous `t`);
    - "all_gather": every rank's `t` stacked along dim 0 in rank order;
    - "all_reduce": `t` reduced over the ranks by `op` (in place on a
      contiguous `t`);
    - "shift": the next rank's `t` (rank + 1 mod W), while this rank's goes
      to the previous one (one send and one receive, the JAX package's
      `ppermute` by one).

    A collective sends a tensor's storage as it lies, so `t` goes as a
    contiguous tensor.  Counts "collectives" one a call and "collective
    bytes" what this rank receives from the others: a broadcast's tensor
    (none on its source), W - 1 pieces of an all-gather or of an
    all-reduce (the others' contributions), the shifted tensor.  With one
    rank nothing is sent or counted and `t` comes back as it is."""
    W = mesh.world
    if W == 1:
        return t
    t = t.contiguous()
    nbytes = t.numel() * t.element_size()
    group = mesh.group
    if kind == "broadcast":
        dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
        received = 0 if mesh.rank == src else nbytes
    elif kind == "all_gather":
        out = t.new_empty((W * t.shape[0],) + t.shape[1:])
        dist.all_gather(list(out.chunk(W)), t, group=group)
        t, received = out, (W - 1) * nbytes
    elif kind == "all_reduce":
        dist.all_reduce(t, op=op, group=group)
        received = (W - 1) * nbytes
    elif kind == "shift":
        out = torch.empty_like(t)
        ops = [
            dist.P2POp(dist.isend, t, dist.get_global_rank(group, (mesh.rank - 1) % W), group),
            dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (mesh.rank + 1) % W), group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        t, received = out, nbytes
    else:
        raise ValueError(f"unknown collective {kind!r}")
    timers.count(COLLECTIVES)
    timers.count(COLLECTIVE_BYTES, received)
    return t


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def row_mesh(n_devices: int | None = None, device=None) -> RowMesh:
    """The row partition over the default process group, on `device` (the
    CUDA card of this rank unless the caller passes `device="cpu"`).

    When `torch.distributed` is not initialized, a 1-rank default group is
    created on the caller's device (NCCL for CUDA, gloo for the CPU) with an
    in-memory store: no network.  The port runs one process per device, so
    `n_devices` must be None or the group's size.  With no `device`, an
    initialized gloo group runs on the CPU and an NCCL one on this rank's
    card."""
    from ..problem import resolve_device

    if device is None and dist.is_initialized() and str(dist.get_backend()) == "gloo":
        device = "cpu"
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"{n_devices} devices need {n_devices} processes, one per "
                "device: launch them with torchrun (initialize_multihost); "
                "this process is alone"
            )
        dist.init_process_group(
            _backend_for(device), store=dist.HashStore(), rank=0, world_size=1
        )
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(
            f"distributed_devices={n_devices}, but the process group has "
            f"{world} ranks: the port runs one process per device, so the "
            "row partition spans the whole group"
        )
    backend = str(dist.get_backend())
    if backend != _backend_for(device):
        raise ValueError(
            f"tensors on {device} need the {_backend_for(device)} backend; "
            f"the process group was initialized with {backend}"
        )
    return RowMesh(dist.group.WORLD, dist.get_rank(), world, device)


def padded_rows(n_nodes: int, mesh: RowMesh) -> tuple[int, int]:
    """(n_padded, nloc): node count padded to a multiple of the world size."""
    nloc = -(-n_nodes // mesh.world)
    return nloc * mesh.world, nloc


def _real_rows(n_nodes: int, nloc: int, rank: int) -> int:
    """How many of rank `rank`'s nloc slab nodes are real (the rest pad)."""
    return max(0, min(nloc, n_nodes - rank * nloc))


def all_gather_rows(x: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """Every rank's `x` stacked along dim 0 in rank order, on every rank
    (the JAX package's `all_gather(..., tiled=True)`)."""
    return collective("all_gather", x, mesh)


def flat_to_slab(vflat: torch.Tensor, n_nodes: int, dim: int, mesh: RowMesh):
    """Component-blocked flat [d*n] (or [d*n, k]) -> this rank's slab piece
    [d*nloc] (component, then local node), zero on padded nodes.  No
    communication: the flat vector is replicated."""
    _, nloc = padded_rows(n_nodes, mesh)
    r0 = mesh.rank * nloc
    nr = _real_rows(n_nodes, nloc, mesh.rank)
    v = vflat.reshape((dim, n_nodes) + vflat.shape[1:])
    out = v.new_zeros((dim, nloc) + vflat.shape[1:])
    out[:, :nr] = v[:, r0 : r0 + nr]
    return out.reshape((dim * nloc,) + vflat.shape[1:])


def slab_to_flat(v_loc: torch.Tensor, n_nodes: int, dim: int, mesh: RowMesh):
    """This rank's slab piece [d*nloc] (or [d*nloc, k]) -> the replicated flat
    [d*n]: an all-gather of the pieces, then the padded nodes dropped."""
    nloc = v_loc.shape[0] // dim
    tail = v_loc.shape[1:]
    v = all_gather_rows(v_loc, mesh).reshape((mesh.world, dim, nloc) + tail)
    v = v.transpose(0, 1).reshape((dim, mesh.world * nloc) + tail)
    return v[:, :n_nodes].reshape((dim * n_nodes,) + tail)


def assemble_slab(
    euler: torch.Tensor,
    support_pts: torch.Tensor,
    tables: AssemblyTables,
    rank: int,
    world: int,
):
    """Rank `rank`'s slab (V, K), each [d*nloc, d*n], of a partition into
    `world` slabs: the real rows [r0, min(r0 + nloc, n)) through
    `ops.assemble.assemble_rows`, padded rows zero.  A plain function of
    (rank, world), so that one process can assemble any rank's slab."""
    d = tables.cfg.dim
    n = tables.n_nodes
    nloc = -(-n // world)
    r0 = rank * nloc
    nr = _real_rows(n, nloc, rank)
    dt = tables.cfg.dtype
    if nr == nloc:
        ids = torch.arange(r0, r0 + nr, dtype=torch.long, device=euler.device)
        return assemble_rows(euler, support_pts, support_pts[r0 : r0 + nr], ids, r0, tables)
    V = torch.zeros((d, nloc, d * n), dtype=dt, device=euler.device)
    K = torch.zeros_like(V)
    if nr > 0:
        ids = torch.arange(r0, r0 + nr, dtype=torch.long, device=euler.device)
        Vr, Kr = assemble_rows(euler, support_pts, support_pts[r0 : r0 + nr], ids, r0, tables)
        V[:, :nr] = Vr.reshape(d, nr, d * n)
        K[:, :nr] = Kr.reshape(d, nr, d * n)
    return V.reshape(d * nloc, d * n), K.reshape(d * nloc, d * n)


def sharded_assemble(
    euler: torch.Tensor,
    support_pts: torch.Tensor,
    tables: AssemblyTables,
    mesh: RowMesh,
):
    """Row-sharded assembly: this rank runs the row-block assembly for its
    node slab (geometry replicated, rows partitioned; the reference's SPMD
    masking `:2875-2877` turned into slabs).  Returns this rank's (V, K)
    slabs [d*nloc, d*n]."""
    return assemble_slab(euler, support_pts, tables, mesh.rank, mesh.world)


def sharded_matvec(A_loc: torch.Tensor, x: torch.Tensor, mesh: RowMesh):
    """y_loc = A_loc @ x with x replicated: this rank's slab piece of the
    product (`slab_to_flat` or `all_gather_rows` re-replicates it)."""
    return A_loc @ x


def sharded_matvec_gathered(A_loc: torch.Tensor, x: torch.Tensor, mesh: RowMesh):
    """y = gather(A_loc @ x): the local slab GEMV, then an all-gather, so
    every rank holds the replicated slab-ordered [W*m] vector."""
    return all_gather_rows(A_loc @ x, mesh)


def sharded_matvec_ring(A2_loc: torch.Tensor, x_loc: torch.Tensor, mesh: RowMesh):
    """y_loc = (A2 @ x) on this rank's rows with BOTH operands slab-ordered
    (columns reordered by `lu.slab_reorder_columns`) and x row-sharded: a
    W-step ring.  Each step multiplies the local [m, m] column block by the x
    block held, while that block moves on to the previous rank
    (`batch_isend_irecv`, the JAX package's `ppermute`)."""
    W, rank = mesh.world, mesh.rank
    m = A2_loc.shape[1] // W
    y = torch.zeros_like(x_loc)
    xcur = x_loc
    for s in range(W):
        j = (rank + s) % W  # xcur holds block j
        y = y + A2_loc[:, j * m : (j + 1) * m] @ xcur
        if s == W - 1:
            break
        xcur = collective("shift", xcur, mesh)
    return y
