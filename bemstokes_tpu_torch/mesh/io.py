"""Mesh file readers: gmsh (.msh v1/v2), UCD (.inp), legacy VTK (.vtk) and
Wavefront OBJ (.obj) — the formats the reference accepts in
`read_input_mesh_file` (`source/bem_stokes.cc:497-523`, deferring to deal.II
GridIn::read_msh / read_ucd / read_vtk / read_assimp).

A copy of `bemstokes_tpu/mesh/io.py` (that package cannot be imported
without importing jax); `tests/test_torch_host_layer.py` pins it to its
original.  Host-side numpy: nothing here touches the device.

Quad connectivity in both formats is counterclockwise (v0, v1, v2, v3); we
store lexicographic (v0, v1, v3, v2).  Physical/material tags map straight
onto `SurfaceMesh.material_id`.
"""

from __future__ import annotations

import numpy as np

from .surface_mesh import SurfaceMesh

# gmsh element types: 1 = 2-node line, 3 = 4-node quad, 15 = point
_GMSH_LINE = 1
_GMSH_QUAD = 3


def _ccw_quad_to_lex(quad):
    return [quad[0], quad[1], quad[3], quad[2]]


def read_msh(path: str, dim: int = 3) -> SurfaceMesh:
    with open(path) as f:
        tokens = f.read().split("\n")
    i = 0
    node_ids: list[int] = []
    coords: list[list[float]] = []
    cells: list[list[int]] = []
    mats: list[int] = []
    n_lines = len(tokens)
    while i < n_lines:
        line = tokens[i].strip()
        if line in ("$NOD", "$Nodes"):
            v2 = line == "$Nodes"
            n = int(tokens[i + 1])
            for k in range(n):
                parts = tokens[i + 2 + k].split()
                node_ids.append(int(parts[0]))
                coords.append([float(x) for x in parts[1:4]])
            i += 2 + n
        elif line in ("$ELM", "$Elements"):
            v2 = line == "$Elements"
            n = int(tokens[i + 1])
            for k in range(n):
                parts = [int(x) for x in tokens[i + 2 + k].split()]
                if v2:
                    etype = parts[1]
                    ntags = parts[2]
                    phys = parts[3] if ntags > 0 else 0
                    nodes = parts[3 + ntags :]
                else:
                    etype = parts[1]
                    phys = parts[2]
                    nodes = parts[5:]
                if dim == 3 and etype == _GMSH_QUAD:
                    cells.append(_ccw_quad_to_lex(nodes))
                    mats.append(phys)
                elif dim == 2 and etype == _GMSH_LINE:
                    cells.append(nodes)
                    mats.append(phys)
            i += 2 + n
        else:
            i += 1

    id_map = {nid: k for k, nid in enumerate(node_ids)}
    cells_idx = np.array([[id_map[v] for v in c] for c in cells], dtype=np.int32)
    verts = np.asarray(coords, dtype=np.float64)[:, :dim]
    return SurfaceMesh(verts, cells_idx, np.asarray(mats, dtype=np.int32))


def read_inp(path: str, dim: int = 3) -> SurfaceMesh:
    """AVS UCD reader (deal.II GridIn::read_ucd format)."""
    with open(path) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    counts = lines[0].split()
    n_nodes, n_cells = int(counts[0]), int(counts[1])
    node_ids = []
    coords = []
    for ln in lines[1 : 1 + n_nodes]:
        parts = ln.split()
        node_ids.append(int(parts[0]))
        coords.append([float(x) for x in parts[1:4]])
    id_map = {nid: k for k, nid in enumerate(node_ids)}
    cells = []
    mats = []
    for ln in lines[1 + n_nodes : 1 + n_nodes + n_cells]:
        parts = ln.split()
        mat = int(parts[1])
        ctype = parts[2]
        nodes = [id_map[int(x)] for x in parts[3:]]
        if ctype == "quad" and dim == 3:
            cells.append(_ccw_quad_to_lex(nodes))
            mats.append(mat)
        elif ctype == "line" and dim == 2:
            cells.append(nodes)
            mats.append(mat)
    return SurfaceMesh(
        np.asarray(coords, dtype=np.float64)[:, :dim],
        np.asarray(cells, dtype=np.int32),
        np.asarray(mats, dtype=np.int32),
    )


def read_vtk(path: str, dim: int = 3) -> SurfaceMesh:
    """Legacy-VTK ASCII reader (POINTS / CELLS with VTK_QUAD=9 / VTK_LINE=3)."""
    with open(path) as f:
        text = f.read().split()
    verts, cells, types = [], [], []
    i = 0
    while i < len(text):
        tok = text[i].upper()
        if tok == "POINTS":
            n = int(text[i + 1])
            data = [float(x) for x in text[i + 3 : i + 3 + 3 * n]]
            verts = np.asarray(data).reshape(n, 3)
            i += 3 + 3 * n
        elif tok == "CELLS":
            n = int(text[i + 1])
            total = int(text[i + 2])
            j = i + 3
            for _ in range(n):
                cnt = int(text[j])
                cells.append([int(x) for x in text[j + 1 : j + 1 + cnt]])
                j += 1 + cnt
            i = j
        elif tok == "CELL_TYPES":
            n = int(text[i + 1])
            types = [int(x) for x in text[i + 2 : i + 2 + n]]
            i += 2 + n
        else:
            i += 1
    out_cells, mats = [], []
    for c, t in zip(cells, types):
        if t == 9 and dim == 3:
            out_cells.append(_ccw_quad_to_lex(c))
            mats.append(0)
        elif t == 3 and dim == 2:
            out_cells.append(c)
            mats.append(0)
    return SurfaceMesh(
        np.asarray(verts, dtype=np.float64)[:, :dim],
        np.asarray(out_cells, dtype=np.int32),
        np.asarray(mats, dtype=np.int32),
    )


def read_obj(path: str, dim: int = 3) -> SurfaceMesh:
    """Wavefront OBJ reader (quad faces; `f v`, `f v/vt`, `f v//vn` and
    `f v/vt/vn` index styles; negative indices are relative).  The reference
    reads .obj swimmer scans through assimp (`read_input_mesh_file`,
    `source/bem_stokes.cc:497-523` with `GridIn::read_assimp`)."""
    verts: list[list[float]] = []
    cells: list[list[int]] = []
    mats: list[int] = []
    mat = 0
    with open(path) as f:
        for ln in f:
            parts = ln.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] in ("usemtl", "g", "o"):
                # material groups map onto material ids by order of appearance
                if parts[0] == "usemtl":
                    mat += 1
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                if len(idx) != 4:
                    raise ValueError(
                        f"{path}: only quad faces are supported (got a "
                        f"{len(idx)}-gon; triangulated scans must be "
                        "re-meshed to quads)"
                    )
                cells.append(_ccw_quad_to_lex(idx))
                mats.append(max(mat - 1, 0))
    return SurfaceMesh(
        np.asarray(verts, dtype=np.float64)[:, :dim],
        np.asarray(cells, dtype=np.int32),
        np.asarray(mats, dtype=np.int32),
    )


def read_mesh(
    path: str, dim: int = 3, force_material: int | None = None
) -> SurfaceMesh:
    """Read a mesh file; `force_material` overrides every cell's material id
    (the reference resets the swimmer grid to body material 0 after reading,
    `source/bem_stokes.cc:515-521` — walls add their own materials later).

    Uses the native C++ parser (native/meshcore.cpp) when available — the
    frame loop re-reads a gait mesh every frame, so parsing sits on the
    critical path; falls back to the pure-numpy readers."""
    if path.endswith(".msh") or path.endswith(".inp"):
        from .._native import read_mesh_native

        out = read_mesh_native(path, dim, path.rsplit(".", 1)[1])
        if out is not None:
            verts, cells, mats = out
            mesh = SurfaceMesh(verts, cells, mats)
        elif path.endswith(".msh"):
            mesh = read_msh(path, dim)
        else:
            mesh = read_inp(path, dim)
    elif path.endswith(".vtk"):
        mesh = read_vtk(path, dim)
    elif path.endswith(".obj"):
        mesh = read_obj(path, dim)
    elif path.endswith(".iges") or path.endswith(".igs"):
        # the reference reads iges flagellum CAD geometry only when built
        # with OpenCASCADE (`BEM_STOKES_WITH_OCE`, `source/bem_stokes.cc:
        # 532-578`); no CAD kernel is available in this environment, and the
        # analytic flagellum factory (bemstokes_tpu_torch.flagella) covers
        # the same geometry family
        raise NotImplementedError(
            "iges input needs a CAD kernel (the reference gates it behind "
            "BEM_STOKES_WITH_OCE); use the analytic flagellum factory "
            "(use_flagellum_handler) or convert the CAD surface to msh/inp"
        )
    else:
        raise ValueError(f"unsupported mesh format: {path}")
    if force_material is not None:
        mesh.material_id[:] = force_material
    return mesh
