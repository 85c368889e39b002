"""Collocation assembly of the dense single-layer (V) and double-layer (K)
operators (port of `bemstokes_tpu/ops/assemble.py`; reference
`assemble_stokes_system`, `source/bem_stokes.cc:2841-3000`).

Layout: for a scalar space with n nodes in dim-d space, V and K are dense
[d*n, d*n] with component-blocked indices (a*n + i, b*n + j), matching the
reference's `i + c*N/dim` layout.

`AssemblyConfig.column_mode` picks the formulation of the smooth bulk, as in
the JAX package; the port's default is "node" (the JAX package's is
"gather"):

- "node": every column node's incident panel quadrature is gathered once
  per frame (`node_column_samples`), then a pure pairwise sweep of
  collocation rows against those samples gives the dense smooth-rule
  operators — `ops.node_kernel.node_sweep`, a CUDA kernel (K1, K2 or K3; K4
  with `node_layout="planes"`) on a CUDA tensor and its plain torch version
  on a CPU tensor.  Own-cell pairs were swept with the smooth rule; the
  batched singular path adds (singular - smooth) per (cell, local node) as
  COO triplets (`_singular_coo(subtract_smooth=True)`);
- "gather": panel-centric.  Per row block the Green's functions are
  evaluated once per (row, panel quadrature point), contracted with the
  panel's weighted shape values into slots (c, l), own-cell pairs masked,
  and each slot summed into its node column cells_fe[c, l].  In free space
  on the card that is `ops.slot_kernel.tile_nodes`, the CUDA kernel K6,
  which sums the slots into the node columns [n, 9, T] inside the kernel.
  On the CPU, and for the image Green's functions on every device (the JAX
  package keeps those on its XLA path too), the plain slot tensors
  [Nc*nl, 9, T] are made and reduced by the incidence gather-reduce
  (`slot_kernel.gather_reduce`, what `tile_nodes_reference` does).  The
  singular path then adds the singular-rule integrals themselves
  (`subtract_smooth=False`);
- "scatter": the same slot tensors from the plain torch version on every
  device, reduced by an index-add over the slots' column nodes: the oracle
  of the other two.

In every mode, under adaptive quadrature (auto-promotion on near contact)
the `near_panels` nearest panels of each row are upgraded from the far rule
to the full rule as COO triplets (`_near_coo`).

With an image kernel (`AssemblyConfig.kernel` "free_surface" or "no_slip",
wall plane x[wall_axis] = wall_position) the node bulk runs K2 or K3 and
both deltas evaluate the same image Green's functions (`kernels/images.py`) at
the mirrored collocation point.

The host-side tables (`build_assembly_tables`, `_singular_rules`) are a copy
of the JAX package's numpy code.

A 2D problem (line cells in the plane; `cfg.dim == 2`) takes the plain
torch bulk of `ops/bulk_2d.py` in each column mode, on every device, as the
JAX package keeps 2D on its XLA path; its deltas are the same functions
here with the 2D normal.  The image kernels are 3D only (ValueError).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..fem.geometry import panel_geometry, parametric_normal
from ..fem.quadrature import (
    gauss_quad,
    iterated_gauss_quad,
    singular_rule_quad,
    singular_rule_line,
    gauss_1d,
    iterated_gauss_1d,
)
from ..fem.reference_element import reference_element
from ..kernels.images import image_point
from ..mesh.dofs import ScalarSpace
from ..utils import timers
from .node_kernel import (
    KERNEL_FREE_SPACE,
    KERNEL_FREE_SURFACE,
    KERNEL_NO_SLIP,
    LAYOUT_DENSE,
    LAYOUT_PLANES,
    eval_G_Wn,
    node_sweep,
    planes_to_dense,
)
from . import bulk_2d, slot_kernel
from .slot_kernel import node_groups, tile_nodes, tile_slots_reference

COLUMN_MODES = ("node", "gather", "scatter")
#: bytes the two slot tensors of one "gather"/"scatter" row block may take
#: together, or on the card in free-space gather mode its two node-column
#: tensors; it sets the rows per block
SLOT_BLOCK_BYTES = 2 * 1024**3


@dataclasses.dataclass(frozen=True)
class AssemblyConfig:
    dim: int = 3
    kernel: str = KERNEL_FREE_SPACE
    wall_axis: int = 1
    wall_position: float = 0.0
    quad_order: int = 4  # per-direction Gauss order for smooth panels
    # adaptive two-level quadrature: when set, the dense O(N^2) pass runs at
    # this (lower) order and only each node's `near_panels` nearest panels
    # are corrected to full `quad_order` by a gathered sparse pass.
    # None = single-pass.
    quad_order_far: int | None = None
    near_panels: int = 32
    singular_quadrature_order: int = 5
    singular_quadrature_type: str = "Mixed"  # Mixed | Duffy | Telles
    # the JAX package's XLA tile sizes; accepted so that configs convert and
    # read by nothing: the port sizes its row blocks from SLOT_BLOCK_BYTES
    # and its plain versions chunk by their own arguments
    row_tile: int = 32
    cell_chunk: int = 256
    dtype: torch.dtype = torch.float64
    # formulation of the smooth bulk: "node" | "gather" | "scatter" (see the
    # module docstring)
    column_mode: str = "node"
    # output layout of the node-mode sweep: "dense" (K1, K2, K3) or "planes"
    # (K4: component-major [9, n, nr], brought to the dense form afterwards;
    # free space only).  The counterpart of the JAX package's environment
    # variable BEMSTOKES_PALLAS_NODE_LAYOUT
    node_layout: str = LAYOUT_DENSE


@dataclasses.dataclass(frozen=True)
class AssemblyTables:
    """Host-precomputed static tables binding a (field space, map space) pair
    to an AssemblyConfig. All arrays are numpy; the device code converts
    them per call."""

    cfg: AssemblyConfig
    n_nodes: int
    nl_fe: int
    nl_map: int
    cells_nodes_fe: np.ndarray  # [Nc, nl_fe]
    cells_nodes_map: np.ndarray  # [Nc, nl_map]
    flip_sign: np.ndarray  # [Nc]
    # smooth rule (the DENSE pass: the far rule under adaptive quadrature)
    q_weights: np.ndarray  # [nq]
    phi_map: np.ndarray  # [nq, nl_map]
    dphi_map: np.ndarray  # [nq, nl_map, cdim]
    phi_fe: np.ndarray  # [nq, nl_fe]
    # singular rules, one per local FE node, padded to a common length
    sq_weights: np.ndarray  # [nl_fe, qs]
    sphi_map: np.ndarray  # [nl_fe, qs, nl_map]
    sdphi_map: np.ndarray  # [nl_fe, qs, nl_map, cdim]
    sphi_fe: np.ndarray  # [nl_fe, qs, nl_fe]
    # node -> incident (cell, local-node) flat slots c*nl + l, padded to the
    # max valence; inc_mask zeroes the padding
    inc_slot: np.ndarray  # [n_nodes, vmax] int32
    inc_mask: np.ndarray  # [n_nodes, vmax]
    # full-order rule for the gathered near-pair correction (None when the
    # dense pass already runs at full order; see AssemblyConfig.quad_order_far)
    hq_weights: np.ndarray | None = None
    hphi_map: np.ndarray | None = None
    hdphi_map: np.ndarray | None = None
    hphi_fe: np.ndarray | None = None


def _singular_rules(cfg: AssemblyConfig, fe_degree: int, unit_sp: np.ndarray):
    """Per-local-support-point singular rules, padded to uniform length.

    Mirrors the reference's selection (`source/bem_stokes.cc:4929-4986`):
    3D "Duffy" -> Duffy split at the support point; "Mixed" -> singular
    treatment for degree 1, iterated Gauss for higher degree; "Telles" ->
    tensor Telles.  2D: Telles for degree 1, iterated Gauss otherwise.
    """
    cdim = unit_sp.shape[1]
    rules = []
    for sp in unit_sp:
        if cdim == 2:
            kind = cfg.singular_quadrature_type
            if kind == "Telles":
                pts, wts = singular_rule_quad(
                    cfg.singular_quadrature_order, sp, kind="telles"
                )
            elif kind == "Mixed" and fe_degree > 1:
                pts, wts = iterated_gauss_quad(
                    cfg.singular_quadrature_order, max(fe_degree, 1)
                )
            else:  # Duffy, or Mixed at degree <= 1
                pts, wts = singular_rule_quad(
                    cfg.singular_quadrature_order, sp, kind="duffy"
                )
        else:
            if fe_degree > 1:
                x, w = iterated_gauss_1d(cfg.singular_quadrature_order, fe_degree)
                pts, wts = x[:, None], w
            else:
                pts, wts = singular_rule_line(cfg.singular_quadrature_order, sp)
        rules.append((pts, wts))
    qs = max(len(w) for _, w in rules)
    # pad with zero-weight points at the cell center
    center = np.full((cdim,), 0.5)
    pad_pts = np.stack(
        [
            np.concatenate([p, np.tile(center, (qs - len(w), 1))])
            for p, w in rules
        ]
    )
    pad_wts = np.stack(
        [np.concatenate([w, np.zeros(qs - len(w))]) for _, w in rules]
    )
    return pad_pts, pad_wts  # [nl_fe, qs, cdim], [nl_fe, qs]


def build_assembly_tables(
    fe_space: ScalarSpace, map_space: ScalarSpace, cfg: AssemblyConfig
) -> AssemblyTables:
    cdim = fe_space.cell_dim
    fe = reference_element(cdim, fe_space.degree)
    me = reference_element(cdim, map_space.degree)

    def rule(order):
        if cdim == 2:
            return gauss_quad(order)
        x, w = gauss_1d(order)
        return x[:, None], w

    dense_order = (
        cfg.quad_order_far if cfg.quad_order_far is not None else cfg.quad_order
    )
    q_pts, q_wts = rule(dense_order)
    hi_tables = {}
    if cfg.quad_order_far is not None:
        h_pts, h_wts = rule(cfg.quad_order)
        hi_tables = dict(
            hq_weights=h_wts,
            hphi_map=me.shape_values(h_pts),
            hdphi_map=me.shape_grads(h_pts),
            hphi_fe=fe.shape_values(h_pts),
        )

    s_pts, s_wts = _singular_rules(cfg, fe_space.degree, fe_space.unit_support_points)

    mesh = fe_space.mesh
    flip = np.where(mesh.flip_normal, -1.0, 1.0)

    # incidence lists: for each node, the flat (cell, local) slots carrying it
    # (the native C++ table where the library is available, numpy otherwise)
    from .._native import incidence_native

    n_nodes = fe_space.n_nodes
    native = incidence_native(fe_space.cells_nodes, n_nodes)
    if native is not None:
        inc_slot, inc_mask = native
    else:
        flat = np.asarray(fe_space.cells_nodes, dtype=np.int64).reshape(-1)
        counts = np.bincount(flat, minlength=n_nodes)
        vmax = int(counts.max()) if len(flat) else 1
        inc_slot = np.zeros((n_nodes, vmax), dtype=np.int32)
        inc_mask = np.zeros((n_nodes, vmax), dtype=np.float64)
        fill = np.zeros(n_nodes, dtype=np.int64)
        order = np.argsort(flat, kind="stable")
        for slot in order:
            j = flat[slot]
            inc_slot[j, fill[j]] = slot
            inc_mask[j, fill[j]] = 1.0
            fill[j] += 1

    return AssemblyTables(
        cfg=cfg,
        n_nodes=fe_space.n_nodes,
        nl_fe=fe_space.nl,
        nl_map=map_space.nl,
        cells_nodes_fe=np.asarray(fe_space.cells_nodes, dtype=np.int32),
        cells_nodes_map=np.asarray(map_space.cells_nodes, dtype=np.int32),
        flip_sign=flip,
        q_weights=q_wts,
        phi_map=me.shape_values(q_pts),
        dphi_map=me.shape_grads(q_pts),
        phi_fe=fe.shape_values(q_pts),
        sq_weights=s_wts,
        sphi_map=me.shape_values(s_pts),
        sdphi_map=me.shape_grads(s_pts),
        sphi_fe=fe.shape_values(s_pts),
        inc_slot=inc_slot,
        inc_mask=inc_mask,
        **hi_tables,
    )


def _t(arr, like: torch.Tensor, dtype=None):
    """A host table as a tensor on `like`'s device (in `like`'s dtype unless
    an integer `dtype` is given): a host sync."""
    with timers.host_sync():
        return torch.as_tensor(
            np.asarray(arr), dtype=dtype or like.dtype, device=like.device
        )


def _check_slice(cfg: AssemblyConfig):
    if cfg.kernel not in (KERNEL_FREE_SPACE, KERNEL_FREE_SURFACE, KERNEL_NO_SLIP):
        raise ValueError(cfg.kernel)
    if cfg.column_mode not in COLUMN_MODES:
        raise ValueError(f"column_mode must be one of {COLUMN_MODES}, got {cfg.column_mode!r}")
    if cfg.dim == 2:
        if cfg.kernel != KERNEL_FREE_SPACE:
            # the JAX package asserts dim == 3 in every image kernel
            # (`bemstokes_tpu/kernels/images.py:72`)
            raise ValueError(
                f"the image kernels are 3D only, as in the reference; a 2D "
                f"problem takes the free-space kernel, got {cfg.kernel!r}"
            )
        if cfg.node_layout != LAYOUT_DENSE:
            raise ValueError("the planes layout is K4's, a 3D kernel; 2D writes the dense layout")
    elif cfg.dim != 3:
        raise ValueError(f"dim must be 2 or 3, got {cfg.dim!r}")


def scatter_coo(M: torch.Tensor, ri, ci, vals) -> torch.Tensor:
    """M[ri, ci] += vals in place, dropping out-of-range triplets.

    The JAX package scatters with `mode="drop"` (rows outside the assembled
    block carry a sentinel index, ops/assemble.py:1067); torch's
    `index_put_(accumulate=True)` has no drop mode, so the triplets are
    filtered here.  On CUDA the accumulation is atomic and its order changes
    between runs: results agree to rounding, not bitwise.  The mask's
    selection reads its count back: a host sync."""
    keep = (ri < M.shape[0]) & (ci < M.shape[1])
    with timers.host_sync():
        M.index_put_((ri[keep], ci[keep]), vals[keep], accumulate=True)
    return M


def assemble_V_K(
    euler: torch.Tensor,  # [n_map_nodes, d]
    support_pts: torch.Tensor,  # [n, d] FE node positions under the mapping
    tables: AssemblyTables,
    row_range: tuple[int, int] | None = None,
):
    """Assemble dense V and K over a contiguous collocation-row range.
    Returns (V, K) of shape [d*nr, d*n] (all nodes by default), on the
    device of `euler`, in the tables' dtype."""
    n = tables.n_nodes
    if row_range is None:
        row_range = (0, n)
    r0, r1 = row_range
    node_ids = torch.arange(r0, r1, dtype=torch.long, device=euler.device)
    xi = support_pts[r0:r1]
    return assemble_rows(euler, support_pts, xi, node_ids, r0, tables)


def assemble_rows(
    euler: torch.Tensor,  # [n_map_nodes, d]
    support_pts: torch.Tensor,  # [n, d] all FE node positions (columns)
    xi: torch.Tensor,  # [nr, d] collocation points of the rows to assemble
    node_ids: torch.Tensor,  # [nr] global scalar node ids of those rows
    r0: int,  # first global node id of this row block
    tables: AssemblyTables,
):
    """Row-block assembly: (V, K) [d*nr, d*n] for a contiguous block of
    collocation nodes — the smooth bulk in the configured column mode plus
    the near and singular COO deltas."""
    cfg = tables.cfg
    _check_slice(cfg)
    dt = cfg.dtype
    euler = euler.to(dt)
    support_pts = support_pts.to(dt)
    xi = xi.to(dt)
    nr = xi.shape[0]
    node_mode = cfg.column_mode == "node"
    if cfg.dim == 2:
        V, K = _bulk_2d(euler, xi, node_ids, tables)
    elif node_mode:
        V, K = node_sweep(
            *node_sweep_inputs(euler, xi, tables),
            kernel=cfg.kernel,
            wall_axis=cfg.wall_axis,
            wall_position=cfg.wall_position,
            layout=cfg.node_layout,
        )
        if cfg.node_layout == LAYOUT_PLANES:
            V, K = planes_to_dense(V), planes_to_dense(K)
    else:
        V, K = _panel_bulk(euler, xi, node_ids, tables)
    V, K = _add_near_corrections(V, K, euler, support_pts, xi, node_ids, tables, nr)
    # node mode swept own-cell pairs with the smooth rule, the panel-centric
    # modes masked them
    return _add_singular_rows(
        V, K, euler, support_pts, tables, r0, nr, subtract_smooth=node_mode
    )


def smooth_panel_geometry(euler: torch.Tensor, tables: AssemblyTables):
    """(xq [Nc, nq, d], unit normals [Nc, nq, d], JxW [Nc, nq]) of every panel
    on the smooth (dense-pass) rule under the geometry `euler`, in the tables'
    dtype."""
    euler = euler.to(tables.cfg.dtype)
    return panel_geometry(
        euler[_t(tables.cells_nodes_map, euler, torch.long)],
        _t(tables.phi_map, euler),
        _t(tables.dphi_map, euler),
        _t(tables.q_weights, euler),
        _t(tables.flip_sign, euler),
        ambient_dim=tables.cfg.dim,
    )


def slot_block_rows(tables: AssemblyTables) -> int:
    """Rows per block of the panel-centric modes: the most for which the two
    slot tensors [Nc*nl, 9, T] stay within SLOT_BLOCK_BYTES together, in
    whole multiples of 128 (the kernel's rows per thread block) once there is
    room for that."""
    Nc, nl = tables.cells_nodes_fe.shape
    item = torch.finfo(tables.cfg.dtype).bits // 8
    rows = max(1, SLOT_BLOCK_BYTES // (2 * Nc * nl * 9 * item))
    return rows // 128 * 128 if rows >= 128 else rows


def slot_inputs(euler: torch.Tensor, tables: AssemblyTables):
    """The panel arguments (xq, nrm, wphi) of `tile_slots` under the geometry
    `euler`: the smooth-rule quadrature points and unit normals [Nc, nq, 3]
    and the JxW-weighted shape values [Nc, nq, nl], contiguous, in the
    tables' dtype."""
    xq, normals, jxw = smooth_panel_geometry(euler, tables)
    wphi = jxw[:, :, None] * _t(tables.phi_fe, jxw)[None]  # [Nc, nq, nl]
    return xq.contiguous(), normals.contiguous(), wphi.contiguous()


def node_block_rows(tables: AssemblyTables) -> int:
    """Rows per block of the node-column route (`tile_nodes` on the card):
    the most for which the two node-column tensors [n, 9, T] stay within
    SLOT_BLOCK_BYTES together, in whole multiples of 128 once there is room
    for that."""
    item = torch.finfo(tables.cfg.dtype).bits // 8
    rows = max(1, SLOT_BLOCK_BYTES // (2 * tables.n_nodes * 9 * item))
    return rows // 128 * 128 if rows >= 128 else rows


def _panel_bulk(euler, xi, node_ids, tables: AssemblyTables):
    """The smooth bulk of the "gather" and "scatter" modes: dense (V, K)
    [d*nr, d*n] with own-cell pairs left out, in row blocks.  Free-space
    gather mode on the card goes through the kernel `tile_nodes` (row blocks
    of `node_block_rows`, no slot tensor made); every other route makes the
    plain slot tensors and reduces them (row blocks of `slot_block_rows`)."""
    cfg = tables.cfg
    d = cfg.dim
    n = tables.n_nodes
    nr = xi.shape[0]
    xq, nrm, wphi = slot_inputs(euler, tables)
    plain = dict(kernel=cfg.kernel, wall_axis=cfg.wall_axis, wall_position=cfg.wall_position)
    scatter = cfg.column_mode == "scatter"
    nodes_route = not scatter and cfg.kernel == KERNEL_FREE_SPACE and xi.device.type == "cuda"
    cols = _t(tables.cells_nodes_fe, xi, torch.long).reshape(-1)  # slot -> column node
    V = torch.empty((d, nr, d, n), dtype=cfg.dtype, device=xi.device)
    K = torch.empty_like(V)
    if nodes_route:
        groups = node_groups(tables)
        T = node_block_rows(tables)
    else:
        T = slot_block_rows(tables)
    for t0 in range(0, nr, T):
        xi_t = xi[t0 : t0 + T].contiguous()
        if nodes_route:
            Mts = tile_nodes(xi_t, xq, nrm, wphi, node_ids[t0 : t0 + T], groups)
        else:
            keep = slot_kernel.own_cell_keep(tables.cells_nodes_fe, node_ids[t0 : t0 + T], xi_t)
            Mts = []
            for slots in tile_slots_reference(xi_t, xq, nrm, wphi, keep, **plain):
                if scatter:
                    Mt = torch.zeros((n,) + slots.shape[1:], dtype=cfg.dtype, device=xi.device)
                    Mt.index_add_(0, cols, slots)
                else:
                    Mt = slot_kernel.gather_reduce(slots, tables.inc_slot, tables.inc_mask)
                Mts.append(Mt)
        for Mt, M in zip(Mts, (V, K)):
            # [n, (a, b), t] -> rows (a, t), columns (b, n)
            M[:, t0 : t0 + T] = Mt.reshape(n, d, d, -1).permute(1, 3, 2, 0)
        del Mts
    return V.reshape(d * nr, d * n), K.reshape(d * nr, d * n)


def _bulk_2d(euler, xi, node_ids, tables: AssemblyTables):
    """The smooth bulk of a 2D problem in its column mode, plain torch on
    every device (`ops/bulk_2d.py`: the CUDA sweeps are 3D, as the JAX
    package's Pallas kernels are)."""
    xq, normals, jxw = smooth_panel_geometry(euler, tables)
    if tables.cfg.column_mode == "node":
        Yj, Nj, Wj, _, _ = node_column_samples(tables, xq, normals, jxw)
        return bulk_2d.node_bulk(xi, Yj, Nj, Wj)
    wphi = jxw[:, :, None] * _t(tables.phi_fe, jxw)[None]  # [Nc, nq, nl]
    return bulk_2d.panel_bulk(
        xi,
        node_ids,
        xq,
        normals,
        wphi,
        _t(tables.cells_nodes_fe, xi, torch.long),
        _t(tables.inc_slot, xi, torch.long),
        _t(tables.inc_mask, xi),
        scatter=tables.cfg.column_mode == "scatter",
    )


def node_sweep_inputs(euler: torch.Tensor, xi: torch.Tensor, tables: AssemblyTables):
    """The arguments (xi, Yj, Nj, Wj) of `node_sweep` for collocation rows
    xi under the geometry `euler`: the smooth-rule panel geometry gathered
    into per-column-node sample tables, contiguous, in the tables' dtype.
    The kernel choice and the wall plane travel in `tables.cfg`
    (`assemble_rows` passes them on)."""
    xq, normals, jxw = smooth_panel_geometry(euler, tables)
    Yj, Nj, Wj, _, _ = node_column_samples(tables, xq, normals, jxw)
    return xi.to(tables.cfg.dtype).contiguous(), Yj.contiguous(), Nj.contiguous(), Wj.contiguous()


def node_column_samples(tables: AssemblyTables, xq, normals, jxw):
    """Per-column-node quadrature sample tables for the node sweep: gather
    each node's incident panel quadrature (points, unit normals,
    phi*JxW-weighted shape values) ONCE per frame.  Returns
    (Yj [n, m, d], Nj [n, m, d], Wj [n, m], vmax, nq) with m = vmax*nq and
    zero weights on incidence padding."""
    cfg = tables.cfg
    d = cfg.dim
    n = tables.n_nodes
    nq = xq.shape[1]
    nl = tables.nl_fe
    phi_fe = _t(tables.phi_fe, jxw)  # [nq, nl]
    wphi = jxw[:, :, None] * phi_fe[None]  # [Nc, nq, nl]

    inc_slot = _t(tables.inc_slot, jxw, torch.long)  # [n, vmax]
    inc_mask = _t(tables.inc_mask, jxw)
    cell_of = inc_slot // nl
    loc_of = inc_slot % nl
    vmax = inc_slot.shape[1]
    m = vmax * nq

    Yj = xq[cell_of].reshape(n, m, d)  # [n, m, d]
    Nj = normals[cell_of].reshape(n, m, d)
    Wj = torch.take_along_dim(
        wphi[cell_of], loc_of[:, :, None, None], dim=3
    )[..., 0]
    Wj = (Wj * inc_mask[:, :, None]).reshape(n, m)
    return Yj, Nj, Wj, vmax, nq


def _pair_local_blocks(cfg, euler_cells, flip, xi_rows, keep, rule):
    """Local (V, K) blocks [RC, Kn, d, d, nl] for gathered (row, panel)
    pairs, evaluated on one quadrature rule.

    euler_cells [RC, Kn, nlm, d]; xi_rows [RC, d]; keep [RC, Kn] zeroes
    masked (singular) pairs; rule = (weights [q], phi_map [q, nlm],
    dphi_map [q, nlm, cdim], phi_fe [q, nl])."""
    w, phi_map, dphi_map, phi_fe = (_t(t, euler_cells) for t in rule)
    xq = torch.einsum("qm,rkmd->rkqd", phi_map, euler_cells)
    J = torch.einsum("qmc,rkmd->rkqdc", dphi_map, euler_cells)
    nrm = parametric_normal(J, cfg.dim)
    jac = torch.sqrt(torch.sum(nrm * nrm, dim=-1))
    normals = nrm / jac[..., None] * flip[..., None, None]
    jxw = jac * w[None, None, :]  # [RC, Kn, q]
    R = xq - xi_rows[:, None, None, :]
    wz = keep[..., None, None] == 0
    R = torch.where(wz, torch.ones_like(R), R)
    if cfg.kernel == KERNEL_FREE_SPACE:
        R_img = R
    else:
        xi_img = image_point(xi_rows, cfg.wall_axis, cfg.wall_position)
        R_img = torch.where(wz, torch.ones_like(R), xq - xi_img[:, None, None, :])
    G, Wn = eval_G_Wn(cfg.kernel, cfg.wall_axis, R, R_img, normals)
    keep_l = keep[:, :, None, None, None]
    Vloc = torch.einsum("rkqab,rkq,qm->rkabm", G, jxw, phi_fe) * keep_l
    Kloc = -torch.einsum("rkqab,rkq,qm->rkabm", Wn, jxw, phi_fe) * keep_l
    return Vloc, Kloc


def _add_near_corrections(V, K, euler, support_pts, xi, node_ids, tables, nr):
    """Upgrade each block row's `near_panels` nearest panels from the dense
    far rule to the full `quad_order` rule: scatter-add (hi - lo) local
    blocks.  No-op unless adaptive quadrature is enabled."""
    if tables.hq_weights is None:
        return V, K
    with near_delta_span(tables, xi.shape[0]):
        ri, ci, dV, dK = _near_coo(euler, support_pts, xi, node_ids, tables, nr)
        return scatter_coo(V, ri, ci, dV), scatter_coo(K, ri, ci, dK)


#: rows of the near-pair upgrade's local blocks evaluated at once
NEAR_ROW_CHUNK = 4096


@contextlib.contextmanager
def near_delta_span(tables, rows, RC: int = NEAR_ROW_CHUNK):
    """The span "Near delta" of one near-pair upgrade of `rows` rows
    (`_near_coo` and whatever applies its triplets), with its sizes as
    attributes; counts its (row, panel) pairs as "near pairs" (on the host:
    rows x near panels, the masked own-cell pairs among them)."""
    Kn = min(tables.cfg.near_panels, tables.cells_nodes_fe.shape[0])
    with timers.span(
        "Near delta",
        rows=rows,
        near_panels=Kn,
        chunks=-(-rows // RC),
        far_points=len(tables.q_weights),
        near_points=len(tables.hq_weights),
    ):
        timers.count("near pairs", rows * Kn)
        yield


def _near_coo(euler, support_pts, xi, node_ids, tables, nr, RC: int = NEAR_ROW_CHUNK):
    """COO triplets (ri, ci, dV, dK) of the near-pair quadrature upgrade, in
    row chunks of RC.  Only under adaptive quadrature (`tables.hq_weights`).
    (The local blocks are chains of small elementwise ops: in chunks of 256
    rows a promoted create_sphere(5) frame's delta paid for its launches,
    in chunks of 4,096 it is half the time, PERF.md §5.)

    The nearest panels are the `near_panels` smallest squared center
    distances, ties broken towards the lower panel index (a stable sort;
    `jax.lax.top_k` breaks ties the same way)."""
    cfg = tables.cfg
    d = cfg.dim
    n = tables.n_nodes
    dt = cfg.dtype
    cells_map = _t(tables.cells_nodes_map, euler, torch.long)
    cells_fe = _t(tables.cells_nodes_fe, euler, torch.long)
    Nc, nl = tables.cells_nodes_fe.shape
    Kn = min(cfg.near_panels, Nc)
    flip_all = _t(tables.flip_sign, euler)

    with timers.span("Near selection"):
        centers = euler[cells_map].mean(dim=1).to(dt)  # [Nc, d]
        d2 = torch.sum(
            (xi[:, None, :].to(dt) - centers[None, :, :]) ** 2, dim=-1
        )  # [nr, Nc]
        near = torch.sort(d2, dim=1, stable=True).indices[:, :Kn]  # [nr, Kn]

    lo_rule = (tables.q_weights, tables.phi_map, tables.dphi_map, tables.phi_fe)
    hi_rule = (tables.hq_weights, tables.hphi_map, tables.hdphi_map, tables.hphi_fe)
    ar = torch.arange(d, dtype=torch.long, device=euler.device)

    with timers.span("Near local blocks"):
        ris, cis, dVs, dKs = [], [], [], []
        for c0 in range(0, xi.shape[0], RC):
            xi_c = xi[c0 : c0 + RC].to(dt)
            ids_c = node_ids[c0 : c0 + RC]
            near_c = near[c0 : c0 + RC]
            rows_c = torch.arange(
                c0, c0 + xi_c.shape[0], dtype=torch.long, device=euler.device
            )
            rc = xi_c.shape[0]
            ec = euler[cells_map[near_c]].to(dt)  # [rc, Kn, nlm, d]
            flip = flip_all[near_c]
            cols = cells_fe[near_c]  # [rc, Kn, nl]
            # mask singular (own-cell) pairs
            sing = torch.any(cols == ids_c[:, None, None], dim=-1)  # [rc, Kn]
            keep = (~sing).to(dt)
            Vh, Kh = _pair_local_blocks(cfg, ec, flip, xi_c, keep, hi_rule)
            Vl, Kl = _pair_local_blocks(cfg, ec, flip, xi_c, keep, lo_rule)
            # scatter rows (a, row) local; cols (b, cells_fe) global
            row_idx = ar[None, :] * nr + rows_c[:, None]  # [rc, d]
            col_idx = ar[None, None, :, None] * n + cols[:, :, None, :]  # [rc, Kn, d, nl]
            shape = (rc, Kn, d, d, nl)
            ris.append(row_idx[:, None, :, None, None].expand(shape).reshape(-1))
            cis.append(col_idx[:, :, None, :, :].expand(shape).reshape(-1))
            dVs.append((Vh - Vl).reshape(-1))
            dKs.append((Kh - Kl).reshape(-1))
        return torch.cat(ris), torch.cat(cis), torch.cat(dVs), torch.cat(dKs)


def _add_singular_rows(
    V, K, euler, support_pts, tables: AssemblyTables, r0, nr, subtract_smooth=False
):
    """Scatter the singular COO triplets into dense (V, K), in place."""
    ri, ci, dV, dK = _singular_coo(
        euler, support_pts, tables, r0, nr, subtract_smooth=subtract_smooth
    )
    return scatter_coo(V, ri, ci, dV), scatter_coo(K, ri, ci, dK)


def _singular_coo(
    euler, support_pts, tables: AssemblyTables, r0, nr, subtract_smooth=False
):
    """Batched singular-pair integrals as COO triplets (ri, ci, dV, dK): for
    every (cell c, local node l) the collocation point is the cell's own node
    and the rule is the precomputed per-local-node singular rule.
    Contributions whose row node falls outside [r0, r0+nr) get the
    out-of-range row index d*nr + d*n (`scatter_coo` drops them).

    With `subtract_smooth` (the node-mode bulk) the dense pass already added
    an own-cell contribution with the smooth rule; this path adds
    (singular - smooth) so the net own-cell value is the singular-rule
    integral.  Without it (the "gather" and "scatter" bulks, which mask
    own-cell pairs) the triplets are the singular-rule integrals."""
    cfg = tables.cfg
    _check_slice(cfg)
    d = cfg.dim
    n = tables.n_nodes
    dt = cfg.dtype
    euler = euler.to(dt)
    support_pts = support_pts.to(dt)
    cells_map = _t(tables.cells_nodes_map, euler, torch.long)
    cells_fe = _t(tables.cells_nodes_fe, euler, torch.long)
    Nc, nl = tables.cells_nodes_fe.shape

    euler_cells = euler[cells_map]  # [Nc, nlm, d]
    sphi_map = _t(tables.sphi_map, euler)  # [nl, qs, nlm]
    sdphi_map = _t(tables.sdphi_map, euler)  # [nl, qs, nlm, cdim]
    sq_w = _t(tables.sq_weights, euler)  # [nl, qs]
    sphi_fe = _t(tables.sphi_fe, euler)  # [nl, qs, nl]

    xq = torch.einsum("lqm,cmd->clqd", sphi_map, euler_cells)  # [Nc, nl, qs, d]
    J = torch.einsum("lqmk,cmd->clqdk", sdphi_map, euler_cells)
    nrm = parametric_normal(J, d)
    jac = torch.sqrt(torch.sum(nrm * nrm, dim=-1))
    flip = _t(tables.flip_sign, euler)[:, None, None]
    normals = nrm / jac[..., None] * flip[..., None]
    jxw = jac * sq_w[None, :, :]  # [Nc, nl, qs]

    xi = support_pts[cells_fe]  # [Nc, nl, d] collocation points
    R = xq - xi[:, :, None, :]
    # zero-weight padding points sit at the cell center, which coincides with
    # the center collocation node for Q2 — substitute a finite dummy offset
    wz = (jxw == 0)[..., None]
    R = torch.where(wz, torch.ones_like(R), R)
    if cfg.kernel == KERNEL_FREE_SPACE:
        R_img = R
    else:
        xi_img = image_point(xi, cfg.wall_axis, cfg.wall_position)
        R_img = torch.where(wz, torch.ones_like(R), xq - xi_img[:, :, None, :])
    G, Wn = eval_G_Wn(cfg.kernel, cfg.wall_axis, R, R_img, normals)  # [Nc, nl, qs, d, d]

    Vloc = torch.einsum("clqab,clq,lqm->clabm", G, jxw, sphi_fe)
    Kloc = -torch.einsum("clqab,clq,lqm->clabm", Wn, jxw, sphi_fe)

    if subtract_smooth:
        # remove the dense pass's own-cell smooth-rule contribution: same
        # smooth rule (tables.q_weights = the dense rule), same dummy-offset
        # convention for exact R == 0, evaluated per (cell, row-local-node)
        xq_s, normals_s, jxw_s = panel_geometry(
            euler_cells,
            _t(tables.phi_map, euler),
            _t(tables.dphi_map, euler),
            _t(tables.q_weights, euler),
            _t(tables.flip_sign, euler),
            ambient_dim=d,
        )  # [Nc, nq, ...]
        wphi_s = jxw_s[:, :, None] * _t(tables.phi_fe, euler)[None]
        R2 = xq_s[:, None, :, :] - xi[:, :, None, :]  # [Nc, nl, nq, d]
        r0m = torch.sum(R2 * R2, dim=-1, keepdim=True) == 0
        R2 = torch.where(r0m, torch.ones_like(R2), R2)
        if cfg.kernel == KERNEL_FREE_SPACE:
            R2_img = R2
        else:
            R2_img = xq_s[:, None, :, :] - xi_img[:, :, None, :]
            R2_img = torch.where(r0m, torch.ones_like(R2_img), R2_img)
        G2, Wn2 = eval_G_Wn(
            cfg.kernel, cfg.wall_axis, R2, R2_img, normals_s[:, None]
        )  # [Nc, nl, nq, d, d]
        Vloc = Vloc - torch.einsum("clqab,cqm->clabm", G2, wphi_s)
        Kloc = Kloc + torch.einsum("clqab,cqm->clabm", Wn2, wphi_s)

    # scatter: row (a, cells_fe[c, l] - r0) local to this block; col
    # (b, cells_fe[c, m]) global.  Out-of-block rows get an out-of-range
    # index, which scatter_coo drops.
    local_node = cells_fe - r0  # [Nc, nl]
    in_block = (local_node >= 0) & (local_node < nr)
    big = d * nr + d * n
    ar = torch.arange(d, dtype=torch.long, device=euler.device)
    row_idx = torch.where(
        in_block[:, :, None],
        ar[None, None, :] * nr + local_node[:, :, None],
        big,
    )  # [Nc, nl, d]
    col_idx = ar[None, :, None] * n + cells_fe[:, None, :]  # [Nc, d, nl(m)]
    shape = (Nc, nl, d, d, nl)
    ri = row_idx[:, :, :, None, None].expand(shape).reshape(-1)
    ci = col_idx[:, None, None, :, :].expand(shape).reshape(-1)
    return ri, ci, Vloc.reshape(-1), Kloc.reshape(-1)
