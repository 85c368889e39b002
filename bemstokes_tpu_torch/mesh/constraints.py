"""Hanging-node constraints for locally refined quad surface meshes.

The reference gets these from deal.II (`DoFTools::make_hanging_node_constraints`,
reference `source/bem_stokes.cc:1654-1656`) and bakes them into the system:
constrained rows of the monolithic matrix carry the interpolation identity
instead of a collocated BIE row (`:2970-2995`, sparsity `:1661-1712`).

Array-first equivalent: detection is purely topological — a vertex m hangs on
a parent edge (a, b) iff the half-edges (a, m) and (m, b) each belong to
exactly one cell (the refinement front) AND (a, b) itself is still an edge of
some (coarser) cell.  On a conforming closed surface every edge has two
incident cells, so there are no false positives; on wall meshes with boundary,
true boundary chains fail the (a, b)-is-an-edge test.

Constraints are Q1 (vertex) constraints with weights (1/2, 1/2); chained
constraints from multi-level fronts are resolved to unconstrained masters.
Degree >= 2 field spaces on non-conforming meshes are not supported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .surface_mesh import SurfaceMesh

_QUAD_EDGES = ((0, 1), (2, 3), (0, 2), (1, 3))  # lexicographic local corners


@dataclasses.dataclass(frozen=True)
class HangingConstraints:
    """slave node h ->  u_h = sum_k weights[h, k] * u[masters[h, k]]."""

    slaves: np.ndarray  # [H] int32 scalar node ids
    masters: np.ndarray  # [H, M] int32
    weights: np.ndarray  # [H, M] float64

    @property
    def n(self) -> int:
        return len(self.slaves)

    def flat_rows(self, n: int, d: int) -> np.ndarray:
        """The constrained rows of a component-blocked [d*n] system: the d
        rows a*n + h of every slave h, component-major [d*H]."""
        return (self.slaves[None, :].astype(np.int64) + np.arange(d)[:, None] * n).reshape(-1)


def _edge_set(mesh: SurfaceMesh) -> dict[tuple[int, int], int]:
    edge_count: dict[tuple[int, int], int] = {}
    for cell in mesh.cells:
        for la, lb in _QUAD_EDGES:
            a, b = int(cell[la]), int(cell[lb])
            key = (a, b) if a < b else (b, a)
            edge_count[key] = edge_count.get(key, 0) + 1
    return edge_count


def hanging_vertex_pairs(mesh: SurfaceMesh) -> dict[int, tuple[int, int]]:
    """Raw hanging-vertex map {midpoint: (parent_a, parent_b)} (un-expanded:
    parents may themselves hang on a coarser front)."""
    if mesh.cells.shape[1] != 4:
        return {}
    edge_count = _edge_set(mesh)
    raw: dict[int, tuple[int, int]] = {}
    if mesh.edge_midpoints is not None:
        for m, a, b in mesh.edge_midpoints:
            key = (int(a), int(b)) if a < b else (int(b), int(a))
            if key in edge_count:
                raw[int(m)] = key
        return raw
    return _geometric_hanging_pairs(mesh, edge_count)


def hanging_node_constraints(mesh: SurfaceMesh) -> HangingConstraints:
    """Detect hanging vertices of a (possibly locally refined) quad mesh.

    Exact path: the refiner records every edge midpoint it creates as
    (mid, a, b) in `mesh.edge_midpoints`; a midpoint hangs iff the parent
    edge (a, b) is still an edge of some (unrefined, coarser) cell.  The
    geometric between-ness heuristic is only a fallback for meshes that were
    refined outside this library, and warns when used."""
    if mesh.cells.shape[1] != 4:
        # line cells (2D problems) always refine conformingly
        return HangingConstraints(
            np.zeros(0, np.int32), np.zeros((0, 2), np.int32), np.zeros((0, 2))
        )
    raw = hanging_vertex_pairs(mesh)
    return _build_constraints({m: {a: 0.5, b: 0.5} for m, (a, b) in raw.items()})


def _geometric_hanging_pairs(
    mesh: SurfaceMesh, edge_count: dict[tuple[int, int], int]
) -> dict[int, tuple[int, int]]:
    raw: dict[int, tuple[int, int]] = {}

    # ---- fallback: geometric detection for externally refined meshes ----
    # vertex -> neighbors over single-cell edges (refinement front candidates)
    front_nbrs: dict[int, list[int]] = {}
    for (a, b), cnt in edge_count.items():
        if cnt == 1:
            front_nbrs.setdefault(a, []).append(b)
            front_nbrs.setdefault(b, []).append(a)

    # NOTE on the between-ness filter: for a true hanging triple {a, m, b}
    # all three edges (a,b), (a,m), (m,b) exist with count 1, so topology
    # alone can't tell the slave m from the endpoints a, b.  The slave is the
    # vertex that lies BETWEEN the other two: |am| + |mb| is within a hair of
    # |ab| (manifold projection bends the half-edges slightly off the chord),
    # while an endpoint candidate overshoots by ~50%.  On coarse curved
    # meshes (edge arc >~ 70 deg) this can miss true hanging nodes — hence
    # the warning; prefer meshes refined by `mesh.refine`, which records
    # exact parentage.
    import warnings

    V = mesh.vertices
    matched_triples = 0
    for m, nbrs in front_nbrs.items():
        for i in range(len(nbrs)):
            for j in range(i + 1, len(nbrs)):
                a, b = nbrs[i], nbrs[j]
                key = (a, b) if a < b else (b, a)
                if key not in edge_count:
                    continue
                matched_triples += 1
                lam = np.linalg.norm(V[a] - V[m])
                lmb = np.linalg.norm(V[m] - V[b])
                lab = np.linalg.norm(V[a] - V[b])
                if lam + lmb <= 1.05 * lab:
                    if m in raw and raw[m] != key:
                        warnings.warn(
                            f"hanging node {m}: multiple parent-edge "
                            f"candidates {raw[m]} and {key}; keeping {key}",
                            stacklevel=2,
                        )
                    raw[m] = key
    if front_nbrs and matched_triples and len(raw) < matched_triples // 3:
        warnings.warn(
            "geometric hanging-node detection matched few of the candidate "
            "front triples; coarse curved meshes can defeat the between-ness "
            "test — refine with bemstokes_tpu.mesh.refine to get exact "
            "parent-edge records",
            stacklevel=2,
        )

    return raw


def _build_constraints(
    raw: dict[int, dict[int, float]]
) -> HangingConstraints:
    """Resolve a {slave: {master: weight}} map into flat constraint arrays,
    expanding chains (a master that is itself a slave expands recursively)."""

    def expand(node: int, weight: float, acc: dict[int, float], depth=0):
        if node in raw and depth < 8:
            for parent, w in raw[node].items():
                expand(parent, w * weight, acc, depth + 1)
        else:
            acc[node] = acc.get(node, 0.0) + weight

    slaves, masters, weights = [], [], []
    for m, entries in sorted(raw.items()):
        acc: dict[int, float] = {}
        for parent, w in entries.items():
            expand(parent, w, acc)
        acc = {k: v for k, v in acc.items() if v != 0.0}
        slaves.append(m)
        masters.append(list(acc.keys()))
        weights.append(list(acc.values()))
    H = len(slaves)
    if H == 0:
        return HangingConstraints(
            np.zeros(0, np.int32), np.zeros((0, 2), np.int32), np.zeros((0, 2))
        )
    M = max(len(m) for m in masters)
    mast = np.zeros((H, M), dtype=np.int32)
    wts = np.zeros((H, M))
    for i, (ms, ws) in enumerate(zip(masters, weights)):
        mast[i, : len(ms)] = ms
        wts[i, : len(ws)] = ws
    return HangingConstraints(np.asarray(slaves, np.int32), mast, wts)


def _edge_node_map(space) -> dict[tuple[int, int], np.ndarray]:
    """(va, vb) (sorted vertex pair) -> the degree-1 interior edge node ids of
    a scalar space, ordered from min(va, vb) to max."""
    d = space.degree
    mesh = space.mesh
    n1 = d + 1

    def lex(i, j):
        return j * n1 + i

    edges_def = [
        (0, 1, [lex(i, 0) for i in range(1, d)]),
        (2, 3, [lex(i, d) for i in range(1, d)]),
        (0, 2, [lex(0, j) for j in range(1, d)]),
        (1, 3, [lex(d, j) for j in range(1, d)]),
    ]
    corner_local = {0: lex(0, 0), 1: lex(d, 0), 2: lex(0, d), 3: lex(d, d)}
    out: dict[tuple[int, int], np.ndarray] = {}
    for c in range(mesh.n_cells):
        verts = mesh.cells[c]
        for va_l, vb_l, locals_along in edges_def:
            va, vb = int(verts[va_l]), int(verts[vb_l])
            key = (min(va, vb), max(va, vb))
            if key in out:
                continue
            ids = space.cells_nodes[c, locals_along]
            out[key] = ids if va <= vb else ids[::-1]
    return out


def _lagrange_1d(deg: int, t: float) -> np.ndarray:
    """Values of the degree-`deg` 1D Lagrange basis (equispaced nodes on
    [0, 1]) at parameter t — [deg+1] ordered by node position."""
    nodes = np.linspace(0.0, 1.0, deg + 1)
    vals = np.ones(deg + 1)
    for j in range(deg + 1):
        for k in range(deg + 1):
            if k != j:
                vals[j] *= (t - nodes[k]) / (nodes[j] - nodes[k])
    return vals


def hanging_node_constraints_for_space(mesh: SurfaceMesh, space) -> HangingConstraints:
    """Hanging-node constraints in the scalar-node numbering of a degree-d
    Lagrange space: on each hanging parent edge (a, b) with midpoint m, the
    fine-side nodes (the vertex m and the interior nodes of the half edges
    (a, m), (m, b)) must interpolate the coarse edge's degree-d trace —
    deal.II's make_hanging_node_constraints for quads
    (reference usage `source/bem_stokes.cc:1654-1656`)."""
    d = space.degree
    if d == 1 or mesh.cells.shape[1] != 4:
        return hanging_node_constraints(mesh)
    pairs = hanging_vertex_pairs(mesh)
    if not pairs:
        return HangingConstraints(
            np.zeros(0, np.int32), np.zeros((0, 2), np.int32), np.zeros((0, 2))
        )
    edge_nodes = _edge_node_map(space)
    raw: dict[int, dict[int, float]] = {}
    for m, (a, b) in pairs.items():
        key = (a, b)  # already sorted
        if key not in edge_nodes:
            continue
        # coarse edge nodes ordered along the a -> b parametrization
        coarse = [a] + [int(x) for x in edge_nodes[key]] + [b]

        def constrain(node: int, t: float):
            w = _lagrange_1d(d, t)
            raw[int(node)] = {
                cn: float(wj) for cn, wj in zip(coarse, w) if wj != 0.0
            }

        constrain(m, 0.5)
        for lo, hi, t0, t1 in ((a, m, 0.0, 0.5), (m, b, 0.5, 1.0)):
            fkey = (min(lo, hi), max(lo, hi))
            if fkey not in edge_nodes:
                continue
            fids = edge_nodes[fkey]  # ordered min -> max
            tmin, tmax = (t0, t1) if fkey[0] == lo else (t1, t0)
            for k, node in enumerate(fids, start=1):
                constrain(node, tmin + (k / d) * (tmax - tmin))
    return _build_constraints(raw)


def apply_hanging_constraints_monolithic(A, rhs, hc: HangingConstraints, n, d):
    """Overwrite the d constrained rows per hanging node with the
    interpolation identity u_h - sum w_k u_{m_k} = 0 (reference `:2970-2995`).
    The rows of the torch tensors A and rhs are overwritten where they lie
    (the JAX package returns new arrays): the frame solve's system is its
    own, and a copy would add a second system to the peak."""
    import torch

    if hc.n == 0:
        return A, rhs
    dev = A.device
    comp = np.arange(d)[:, None] * n  # [d, 1]
    rows_np = hc.flat_rows(n, d)  # [d*H]
    rows = torch.as_tensor(rows_np, dtype=torch.long, device=dev)
    A[rows, :] = 0.0
    A[rows, rows] = 1.0
    cols = torch.as_tensor(
        (hc.masters[None, :, :] + comp[:, :, None]).reshape(-1),
        dtype=torch.long,
        device=dev,
    )  # [d*H*M]
    vals = -torch.as_tensor(
        np.broadcast_to(hc.weights[None], (d, *hc.weights.shape)).reshape(-1),
        dtype=A.dtype,
        device=dev,
    )
    rr = torch.as_tensor(
        np.repeat(rows_np, hc.masters.shape[1]), dtype=torch.long, device=dev
    )
    A.index_put_((rr, cols), vals, accumulate=True)
    rhs[rows] = 0.0
    return A, rhs
