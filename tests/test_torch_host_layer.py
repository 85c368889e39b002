"""The torch port's copy of the numpy host layer gives arrays IDENTICAL to
the JAX package's (exact equality, no tolerance), and the port imports
neither jax nor bemstokes_tpu (a static check of its sources)."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import bemstokes_tpu.config as cfg_j
import bemstokes_tpu.config_io as cio_j
import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.constraints as con_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.mesh.proximity as prox_j
import bemstokes_tpu.mesh.refine as ref_j
import bemstokes_tpu.mesh.surface_mesh as sm_j
import bemstokes_tpu.mesh.io as io_j
import bemstokes_tpu.mesh.io_vtu as vtu_j
import bemstokes_tpu._native as native_j
import bemstokes_tpu.ops.assemble as asm_j
import bemstokes_tpu.utils.dealii_io as dio_j
import bemstokes_tpu_torch.config as cfg_t
import bemstokes_tpu_torch.config_io as cio_t
import bemstokes_tpu_torch.fem.geometry as geo_t
import bemstokes_tpu_torch.mesh.constraints as con_t
import bemstokes_tpu_torch.mesh.dofs as dofs_t
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.mesh.proximity as prox_t
import bemstokes_tpu_torch.mesh.refine as ref_t
import bemstokes_tpu_torch.mesh.surface_mesh as sm_t
import bemstokes_tpu_torch.mesh.io as io_t
import bemstokes_tpu_torch.mesh.io_vtu as vtu_t
import bemstokes_tpu_torch._native as native_t
import bemstokes_tpu_torch.ops.assemble as asm_t
import bemstokes_tpu_torch.utils.dealii_io as dio_t
import torch_threads  # noqa: F401  (one torch thread a test process)

PORT = Path(__file__).resolve().parent.parent / "bemstokes_tpu_torch"


def _two_spheres(fac):
    return fac.create_sphere(refinements=2).merged_with(
        fac.create_sphere(center=(2.2, 0.0, 0.0), refinements=2)
    )


def _refined_wall(fac, ref):
    """A wall with a locally refined patch: hanging nodes on the front."""
    wall = fac.create_wall((0.0, -2.0, 0.0), (2.0, 0.0, 2.0), refinements=2)
    trigger = np.zeros(wall.n_cells, dtype=bool)
    trigger[:3] = True
    return ref.refine_uniform(wall, cell_filter=trigger)


MESHES = {
    "sphere2": lambda fac, ref: fac.create_sphere(refinements=2),
    "sphere3": lambda fac, ref: fac.create_sphere(refinements=3),
    "two_spheres": lambda fac, ref: _two_spheres(fac),
    "cube": lambda fac, ref: fac.create_cube(refinements=1),
    "refined_wall": _refined_wall,
}


def _meshes(name):
    return MESHES[name](fac_j, ref_j), MESHES[name](fac_t, ref_t)


def _same(a, b):
    """Exact equality of two values built from numpy arrays, dataclasses,
    dicts and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshes_identical(name):
    mj, mt = _meshes(name)
    _same(mj, mt)
    _same(sm_j.cell_components_and_closedness(mj), sm_t.cell_components_and_closedness(mt))


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("name", ["sphere2", "two_spheres", "refined_wall"])
def test_scalar_space_and_euler_identical(name, degree):
    mj, mt = _meshes(name)
    sj = dofs_j.build_scalar_space(mj, degree)
    st = dofs_t.build_scalar_space(mt, degree)
    for field in ("degree", "n_nodes", "cells_nodes", "unit_support_points"):
        _same(getattr(sj, field), getattr(st, field))
    _same(sj.node_positions(), st.node_positions())
    _same(geo_j.euler_from_mesh(mj.vertices, sj), geo_t.euler_from_mesh(mt.vertices, st))
    manifold_j = ref_j.SphericalManifold((0.0, 0.0, 0.0), radius=1.0)
    manifold_t = ref_t.SphericalManifold((0.0, 0.0, 0.0), radius=1.0)
    _same(
        geo_j.euler_from_mesh(mj.vertices, sj, manifold_j),
        geo_t.euler_from_mesh(mt.vertices, st, manifold_t),
    )


@pytest.mark.parametrize("name", ["sphere2", "sphere3", "two_spheres"])
@pytest.mark.parametrize("far", [None, 2])
def test_assembly_tables_identical(name, far):
    """build_assembly_tables at quadrature order 4 (with and without the
    adaptive far rule); the JAX AssemblyConfig's TPU-only fields have no
    port counterpart and are not part of the tables."""
    mj, mt = _meshes(name)
    sj = dofs_j.build_scalar_space(mj, 1)
    st = dofs_t.build_scalar_space(mt, 1)
    tj = asm_j.build_assembly_tables(sj, sj, asm_j.AssemblyConfig(quad_order=4, quad_order_far=far))
    tt = asm_t.build_assembly_tables(st, st, asm_t.AssemblyConfig(quad_order=4, quad_order_far=far))
    for f in dataclasses.fields(tt):
        if f.name != "cfg":
            _same(getattr(tj, f.name), getattr(tt, f.name))
    # m = vmax * nq: 4 panels per node, (far or 4)^2 points on the dense rule
    assert tt.inc_slot.shape[1] * tt.q_weights.shape[0] == 4 * (far or 4) ** 2


@pytest.mark.parametrize("order", [2, 5])
@pytest.mark.parametrize("kind", ["Mixed", "Duffy", "Telles"])
def test_singular_rules_identical(kind, order):
    mj, mt = _meshes("sphere2")
    for degree in (1, 2):
        sj = dofs_j.build_scalar_space(mj, degree)
        st = dofs_t.build_scalar_space(mt, degree)
        cj = asm_j.AssemblyConfig(singular_quadrature_type=kind, singular_quadrature_order=order)
        ct = asm_t.AssemblyConfig(singular_quadrature_type=kind, singular_quadrature_order=order)
        _same(
            asm_j._singular_rules(cj, degree, sj.unit_support_points),
            asm_t._singular_rules(ct, degree, st.unit_support_points),
        )


@pytest.mark.parametrize("name", ["two_spheres", "refined_wall", "sphere2"])
def test_proximity_and_constraints_identical(name):
    mj, mt = _meshes(name)
    _same(prox_j.min_intercomponent_gap(mj), prox_t.min_intercomponent_gap(mt))
    _same(prox_j.cell_diameters(mj.vertices, mj.cells), prox_t.cell_diameters(mt.vertices, mt.cells))
    _same(prox_j.wall_image_gap(mj, 1, -3.0), prox_t.wall_image_gap(mt, 1, -3.0))
    for degree in (1, 2):
        sj = dofs_j.build_scalar_space(mj, degree)
        st = dofs_t.build_scalar_space(mt, degree)
        _same(
            con_j.hanging_node_constraints_for_space(mj, sj),
            con_t.hanging_node_constraints_for_space(mt, st),
        )


def test_refined_wall_has_hanging_nodes():
    """The constraint comparison above is not vacuous."""
    _, mt = _meshes("refined_wall")
    assert con_t.hanging_node_constraints(mt).n > 0


# one field of values where %.12g formatting has its corners: signed zeros,
# the switch between fixed and exponent notation, ties of the 12th digit
# (999999999999.5, 2^-18, 12345678901.25), the ends of the double range,
# non-finite values and exact integers
EDGE_VALUES = [
    -0.0, 0.0, 1e-5, 9.99999999999e-5, 1e-4, 1e12, 999999999999.5, 1e16, 5e-324,
    1.7976931348623157e308, -1e-300, 2.0**-18, 12345678901.25, 0.1, -2.5, 1e11,
    123456789012.0, 9.999999999995, float("inf"), -float("inf"), float("nan"), -float("nan"),
    7.0, -3.0, 42.0, 1e5, 2.0**53 + 2, -(2.0**40),
]


def _vtu_case(kind):
    """(points, cells, point_data, cell_data) of a writer case."""
    rng = np.random.default_rng(0)
    if kind == "lines":
        points = rng.normal(size=(6, 2))
        cells = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 0]])
    else:
        mesh = fac_t.create_sphere(refinements=5 if kind == "sphere_wall" else 1)
        points, cells = mesh.vertices, mesh.cells
    n = len(points)
    point_data = dict(forces=rng.normal(size=(n, 3)), scalar=rng.normal(size=n))
    if kind == "sphere_wall":  # the frame loop's field set beside a wall
        point_data = dict(
            forces=rng.normal(size=(n, 3)),
            total_velocities=rng.normal(size=(n, 3)) * 1e-3,
            shape_velocities=np.zeros(3 * n).reshape(3, -1).T,
            normals=rng.normal(size=(n, 3)),
        )
        modes = rng.normal(size=(6, n, 3))
        for r in range(6):
            point_data[f"rigid_mode_{r}"] = modes[r]
    elif kind == "edge_values":
        point_data["edges"] = np.resize(np.array(EDGE_VALUES), (n, 3))
    elif kind == "float32":
        point_data = {k: v.astype(np.float32) for k, v in point_data.items()}
    elif kind == "integer":
        point_data["ids"] = rng.integers(-(10**13), 10**13, size=(n, 3))
        point_data["small"] = np.arange(n, dtype=np.int32)
    elif kind == "transposed":
        point_data["shape_velocities"] = rng.normal(size=(3, n)).T
        point_data["every_other"] = rng.normal(size=(2 * n, 3))[::2]
    cell_data = dict(material=np.arange(len(cells), dtype=np.float64))
    return points, cells, point_data, cell_data


def _vtu_bytes(mod, path, kind):
    points, cells, point_data, cell_data = _vtu_case(kind)
    mod.write_vtu(str(path), points, cells, point_data=point_data, cell_data=cell_data)
    return path.read_bytes()


VTU_KINDS = ["quads", "lines", "sphere_wall", "edge_values", "float32", "integer", "transposed"]


@pytest.mark.parametrize("kind", VTU_KINDS)
def test_vtu_writer_identical(tmp_path, kind):
    """`mesh/io_vtu.py:write_vtu` writes the same file, byte for byte."""
    written = _vtu_bytes(vtu_t, tmp_path / "t.vtu", kind)
    assert written == _vtu_bytes(vtu_j, tmp_path / "j.vtu", kind)
    assert b"<PointData>" in written and b"<CellData>" in written


def test_vtu_writer_without_native_library(tmp_path, monkeypatch):
    """Where the native formatter cannot be loaded, Python formats every
    value, to the same bytes."""
    monkeypatch.setattr(vtu_t, "native_lib", lambda: None)
    before = dict(vtu_t.timers.counts)
    written = _vtu_bytes(vtu_t, tmp_path / "t.vtu", "edge_values")
    assert written == _vtu_bytes(vtu_j, tmp_path / "j.vtu", "edge_values")
    assert vtu_t.timers.counts.get("VTU values native", 0) == before.get("VTU values native", 0)
    assert vtu_t.timers.counts["VTU values python"] > before.get("VTU values python", 0)


@pytest.mark.parametrize("native", [True, False])
def test_vtu_counter_splits_values(tmp_path, monkeypatch, native):
    """One write counts each value it wrote once, as native or python."""
    if not native:
        monkeypatch.setattr(vtu_t, "native_lib", lambda: None)
    elif vtu_t.native_lib() is None:
        pytest.fail("the native VTU formatter did not build (g++ -std=c++17)")
    points, cells, point_data, cell_data = _vtu_case("quads")
    values = 3 * len(points) + sum(np.size(v) for v in (*point_data.values(), *cell_data.values()))
    values += cells.size + 2 * len(cells)  # connectivity, offsets, types
    counts = vtu_t.timers.counts
    before = {k: counts.get(k, 0) for k in ("VTU values native", "VTU values python")}
    vtu_t.write_vtu(str(tmp_path / "t.vtu"), points, cells, point_data=point_data, cell_data=cell_data)
    added = {k: counts.get(k, 0) - v for k, v in before.items()}
    assert added["VTU values native"] + added["VTU values python"] == values
    assert added["VTU values native" if native else "VTU values python"] == values


def test_vtu_native_formatter_matches_python():
    """The native formatter (its integer route and std::to_chars) gives
    Python's `%.12g` on values over the whole double range, on ties of the
    12th digit and on integers."""
    if vtu_t.native_lib() is None:
        pytest.fail("the native VTU formatter did not build (g++ -std=c++17)")
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2**63, size=20000, dtype=np.int64).view(np.float64)
    logs = rng.normal(size=40000) * 10.0 ** rng.uniform(-14, 14, size=40000)
    # q / 2^t = q 5^t / 10^t with q odd and q 5^t of 13 digits: an exact tie
    ties = []
    for t in range(1, 18):
        lo, hi = -(-(10**12) // 5**t), (10**13 - 1) // 5**t
        q = rng.integers(lo, hi + 1, size=400) | 1
        ties.append(np.ldexp(q[q <= hi].astype(np.float64), -t))
    ties = np.concatenate(ties)
    assert all(float(f"{v:.12e}") == v and f"{v:.12e}".split("e")[0][-1] == "5" for v in ties)
    values = np.concatenate([bits, logs, -logs[:1000], ties, np.array(EDGE_VALUES)])
    expect = vtu_t.text_python(values)
    assert bytes(vtu_t.text_native(values)) == expect
    ints = np.concatenate([rng.integers(-(2**62), 2**62, size=5000), np.arange(-5, 300)])
    assert bytes(vtu_t.text_native(ints, integer=True)) == vtu_t.text_python(ints, integer=True)


def test_dealii_block_io_identical(tmp_path):
    """`utils/dealii_io.py`: either package reads what the other wrote, and
    a truncated file raises in both."""
    v = np.random.default_rng(1).normal(size=37)
    dio_j.block_write(str(tmp_path / "j.bin"), v)
    dio_t.block_write(str(tmp_path / "t.bin"), v)
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    assert np.array_equal(dio_t.block_read(str(tmp_path / "j.bin")), v)
    assert np.array_equal(dio_j.block_read(str(tmp_path / "t.bin")), v)
    (tmp_path / "cut.bin").write_bytes((tmp_path / "t.bin").read_bytes()[:-9])
    for mod in (dio_j, dio_t):
        with pytest.raises(ValueError):
            mod.block_read(str(tmp_path / "cut.bin"))


def test_config_from_dict_roundtrip():
    """A JAX ProblemConfig, nested configs and walls included, converts to
    the port's config field for field."""
    jcfg = cfg_j.ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        dtype="float32",
        quadrature=cfg_j.QuadratureConfig(order=3, order_far=2, near_panels=8),
        solver=cfg_j.SolverConfig(tolerance=1e-6, preconditioner_dtype="float32"),
        walls=(cfg_j.WallConfig(enabled=True, position=(0.0, -2.0, 0.0)),),
        cylinder=cfg_j.CylinderConfig(radius=2.0),
        wall_refinement=cfg_j.WallRefinementConfig(threshold=0.5),
    )
    tcfg = cfg_t.from_dict(dataclasses.asdict(jcfg))
    assert isinstance(tcfg.solver, cfg_t.SolverConfig)
    assert isinstance(tcfg.walls[0], cfg_t.WallConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(cfg_t.ProblemConfig)] == [
        f.name for f in dataclasses.fields(cfg_j.ProblemConfig)
    ]


def _code(fn):
    """A function's compiled body: equal for two copies of one source."""
    def body(c):
        consts = tuple(body(k) if hasattr(k, "co_code") else k for k in c.co_consts[1:])
        return c.co_code, consts, c.co_names, c.co_varnames

    return body(fn.__code__)


@pytest.mark.parametrize(
    "name", ["_ccw_quad_to_lex", "read_msh", "read_inp", "read_vtk", "read_obj"]
)
def test_mesh_readers_are_the_original_code(name):
    """`mesh/io.py`: the numpy readers are the JAX package's, statement for
    statement (tests/test_torch_cli.py reads files through both)."""
    assert _code(getattr(io_t, name)) == _code(getattr(io_j, name))


@pytest.mark.parametrize(
    "name", ["parse_prm", "config_from_dict", "load_config", "save_config", "_set_path", "_to_floats"]
)
def test_config_io_is_the_original_code(name):
    assert _code(getattr(cio_t, name)) == _code(getattr(cio_j, name))


def test_config_io_tables_identical():
    for table in ("PRM_MAP", "PRM_MAP_SOLVER"):
        tj, tt = getattr(cio_j, table), getattr(cio_t, table)
        assert list(tj) == list(tt)
        for key in tj:
            assert tj[key][0] == tt[key][0] and tj[key][1].__name__ == tt[key][1].__name__
    assert cio_j.PRM_MAP_FLAGELLUM == cio_t.PRM_MAP_FLAGELLUM
    assert cio_j.N_WALLS == cio_t.N_WALLS
    for rx in ("_WALL_RE", "_QUAT_RE", "_RIGID_AXIS_RE", "_FE_RE"):
        assert getattr(cio_j, rx).pattern == getattr(cio_t, rx).pattern


def test_native_reader_binding_is_the_original_code():
    """`_native.py` binds the same library the same way: the reader half,
    and the table half (`incidence_native`, `weld_native` and the argument
    types `get_lib` declares for them), which `build_assembly_tables` takes
    first, as the JAX package's does.  (`_build` differs: the port's builds
    under a file lock, tests/test_torch_native.py.)"""
    assert _code(native_t.read_mesh_native) == _code(native_j.read_mesh_native)
    assert native_t._SO == native_j._SO
    assert native_t._MeshBuf._fields_ == native_j._MeshBuf._fields_
    assert _code(native_t.incidence_native) == _code(native_j.incidence_native)
    assert _code(native_t.weld_native) == _code(native_j.weld_native)
    assert _code(native_t.get_lib) == _code(native_j.get_lib)
    assert _code(asm_t.build_assembly_tables) == _code(asm_j.build_assembly_tables)


def test_make_tables_is_the_original_code():
    """`fem/geometry.py`: `QuadratureTables` and `make_tables` are the JAX
    package's, statement for statement and field for field."""
    assert _code(geo_t.make_tables) == _code(geo_j.make_tables)
    assert [(f.name, f.type) for f in dataclasses.fields(geo_t.QuadratureTables)] == [
        (f.name, f.type) for f in dataclasses.fields(geo_j.QuadratureTables)
    ]


def test_cylinder_import_reads_a_mesh_file(tmp_path):
    """`add_walls_to_mesh` with `cylinder.import_mesh`: the wall read from a
    file, in both packages."""
    tube = fac_t.create_cylindrical_wall(radius=2.0, height=3.0)
    path = str(tmp_path / "tube.inp")
    with open(path, "w") as f:
        f.write("%d %d 0 0 0\n" % (tube.n_vertices, tube.n_cells))
        for k, v in enumerate(tube.vertices):
            f.write("%d %.17g %.17g %.17g\n" % (k + 1, *v))
        for k, c in enumerate(tube.cells[:, [0, 1, 3, 2]]):
            f.write("%d 0 quad %d %d %d %d\n" % (k + 1, *(c + 1)))
    out = []
    for cfg_mod, fac in ((cfg_j, fac_j), (cfg_t, fac_t)):
        cfg = cfg_mod.ProblemConfig(
            cylinder=cfg_mod.CylinderConfig(import_mesh=True, mesh_filename=path, wall_type="free_surface")
        )
        out.append(fac.add_walls_to_mesh(fac.create_sphere(refinements=1), cfg))
    _same(out[0], out[1])
    assert out[1].n_cells == 24 + tube.n_cells


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    # chip_smoke.py loads scripts/torch_sass_count.py to count the node sweeps
    scripts = sorted((PORT.parent / "scripts").glob("torch_*.py"))
    return sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"] + scripts


def test_port_imports_no_jax():
    """Static (AST) check: importing the package here proves nothing, since
    jax may already be loaded in this interpreter."""
    bad = []
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "bemstokes_tpu"):
                bad.append(f"{path.relative_to(PORT.parent)}: {mod}")
    assert not bad, bad
    assert len(_sources()) > 20
