"""The port's mesh-file readers, parameter files and command line
(`bemstokes_tpu_torch/mesh/io.py`, `config_io.py`, `cli.py`) against the JAX
package's, on files the tests write into `tmp_path`.

- readers: a gmsh v2, a UCD, a legacy VTK and an OBJ file written from
  create_sphere(1) read to EXACTLY the arrays the JAX package's readers
  give, through `read_mesh` (the native parser where it builds) and through
  the numpy readers;
- parameter files: `parse_prm`, `save_config` and `load_config` of the two
  packages agree field by field, and a file written by either loads in the
  other;
- the slice as a whole: `cli.main(["run", "-p", json, "--device", "cpu",
  "0", "2", "-o", dir])` on a gait of three frame mesh files against the JAX
  package's `SwimmerSimulation` on the same files: state and result files to
  1e-9 relative, equal iterations.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bemstokes_tpu.config_io as cio_j
import bemstokes_tpu.mesh.io as io_j
from bemstokes_tpu.config import ProblemConfig
from bemstokes_tpu.swimmer import SwimmerSimulation as SimJ, SwimmerState as StateJ
import bemstokes_tpu_torch.config as cfg_t
import bemstokes_tpu_torch.config_io as cio_t
import bemstokes_tpu_torch.mesh.io as io_t
from bemstokes_tpu_torch import cli
from bemstokes_tpu_torch.mesh import create_sphere
from bemstokes_tpu_torch.swimmer import SwimmerSimulation as SimT, SwimmerState as StateT
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-9


def _ccw(cells):
    """The readers store quads lexicographically (v0, v1, v3, v2); files
    hold them counterclockwise."""
    return cells[:, [0, 1, 3, 2]]


def write_msh(path, verts, cells, tag=7):
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n%d\n" % len(verts))
        for k, v in enumerate(verts):
            f.write("%d %.17g %.17g %.17g\n" % (k + 1, *v))
        f.write("$EndNodes\n$Elements\n%d\n" % len(cells))
        for k, c in enumerate(_ccw(cells)):
            f.write("%d 3 2 %d %d %d %d %d %d\n" % (k + 1, tag, tag, *(c + 1)))
        f.write("$EndElements\n")


def write_inp(path, verts, cells, mat=3):
    with open(path, "w") as f:
        f.write("%d %d 0 0 0\n" % (len(verts), len(cells)))
        for k, v in enumerate(verts):
            f.write("%d %.17g %.17g %.17g\n" % (k + 1, *v))
        for k, c in enumerate(_ccw(cells)):
            f.write("%d %d quad %d %d %d %d\n" % (k + 1, mat, *(c + 1)))


def write_vtk(path, verts, cells):
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nsphere\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write("POINTS %d double\n" % len(verts))
        for v in verts:
            f.write("%.17g %.17g %.17g\n" % tuple(v))
        f.write("CELLS %d %d\n" % (len(cells), 5 * len(cells)))
        for c in _ccw(cells):
            f.write("4 %d %d %d %d\n" % tuple(c))
        f.write("CELL_TYPES %d\n" % len(cells) + "9\n" * len(cells))


def write_obj(path, verts, cells):
    with open(path, "w") as f:
        f.write("# sphere\no body\n")
        for v in verts:
            f.write("v %.17g %.17g %.17g\n" % tuple(v))
        f.write("usemtl skin\n")
        for c in _ccw(cells):
            f.write("f %d %d//1 %d/2/3 %d\n" % tuple(c + 1))


WRITERS = {"msh": write_msh, "inp": write_inp, "vtk": write_vtk, "obj": write_obj}


def _plain(cfg):
    """A config as the JSON round trip leaves it (tuples become lists)."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _same_mesh(a, b):
    for field in ("vertices", "cells", "material_id", "flip_normal"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", sorted(WRITERS))
def test_readers_match_jax(fmt, tmp_path):
    mesh = create_sphere(refinements=1)
    path = str(tmp_path / f"sphere.{fmt}")
    WRITERS[fmt](path, mesh.vertices, mesh.cells)
    got = io_t.read_mesh(path)
    _same_mesh(io_j.read_mesh(path), got)
    _same_mesh(getattr(io_j, f"read_{fmt}")(path), getattr(io_t, f"read_{fmt}")(path))
    # the file holds the mesh it was written from
    np.testing.assert_array_equal(got.vertices, mesh.vertices)
    np.testing.assert_array_equal(got.cells, mesh.cells)
    forced = io_t.read_mesh(path, force_material=0)
    assert not forced.material_id.any()
    _same_mesh(io_j.read_mesh(path, force_material=0), forced)


def test_numpy_and_native_readers_agree(tmp_path, monkeypatch):
    """`read_mesh` takes the native parser where it builds and the numpy
    readers where it does not: the same arrays either way."""
    import bemstokes_tpu_torch._native as native

    mesh = create_sphere(refinements=1)
    for fmt in ("msh", "inp"):
        path = str(tmp_path / f"sphere.{fmt}")
        WRITERS[fmt](path, mesh.vertices, mesh.cells)
        first = io_t.read_mesh(path)
        monkeypatch.setattr(native, "read_mesh_native", lambda *a: None)
        _same_mesh(first, io_t.read_mesh(path))
        monkeypatch.undo()


def test_reader_rejects_unknown_formats(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        io_t.read_mesh(str(tmp_path / "sphere.stl"))
    with pytest.raises(NotImplementedError, match="iges"):
        io_t.read_mesh(str(tmp_path / "flagellum.iges"))


PRM = """
subsection BEMProblem<3>
  set Total number of frames = 12
  set Time interval between frames = 0.25
  set Grid = Real
  set Force Pole to be used = Point
  set Force Pole Point Setting = 0.5, 0, -1
  set Use no slip kernel = true   # Blake
  set Wall 0 bool = true
  set Wall 0 spans = 10,0,10
  set Wall center position wall 0 = 0,-2,0
  set Wall 0 type = no_slip
  set Flip normal Wall 0 = true
  set Initial quaternion value q[0] = 0.5
  set Consider rigid displacement y to move the swimmer = true
  set Gmres restart evert = 40
  set Input path to grid = ./grids/
  set Input grid format = inp
  set Cylinder Heigth = 3.5
  set Singular quadrature order = 7
end
subsection Solver
  set Max steps = 300
  set Tolerance = 1e-8
end
subsection Finite Element Stokes
  set Finite element space = FESystem<2,3>[FE_Q<2,3>(2)^3]
end
subsection Internal Quadrature
  set Quadrature order = 6
end
subsection FlagellarGeometryHandler
  set Number of turns for the spiral = 3
  set Flagellar Amplitude = 0.4
end
"""


def test_parse_prm_matches_jax():
    cj, ct = cio_j.parse_prm(PRM), cio_t.parse_prm(PRM)
    assert isinstance(ct, cfg_t.ProblemConfig) and isinstance(ct.walls[0], cfg_t.WallConfig)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    assert (ct.n_frames, ct.solver.gmres_restart, ct.fe_degree, ct.quadrature.order) == (12, 40, 2, 3)
    assert ct.walls[0].enabled and ct.walls[0].flip_normal and ct.flagellum_params["Nlambda"] == 3.0
    assert cio_t.PRM_MAP.keys() == cio_j.PRM_MAP.keys()
    assert {k: v[0] for k, v in cio_t.PRM_MAP.items()} == {k: v[0] for k, v in cio_j.PRM_MAP.items()}


def test_parameter_files_load_in_either_package(tmp_path):
    cj = cio_j.parse_prm(PRM)
    cj.assembly_backend = "gather"
    ct = cfg_t.from_dict(dataclasses.asdict(cj))
    cio_j.save_config(cj, str(tmp_path / "j.json"))
    cio_t.save_config(ct, str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_text() == (tmp_path / "t.json").read_text()
    (tmp_path / "p.prm").write_text(PRM)
    for name in ("j.json", "t.json"):
        lj = cio_j.load_config(str(tmp_path / name))
        lt = cio_t.load_config(str(tmp_path / name))
        assert isinstance(lt, cfg_t.ProblemConfig) and isinstance(lt.solver, cfg_t.SolverConfig)
        assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
        assert _plain(lt) == _plain(ct)
        assert lt.walls[0].enabled and lt.initial_quaternion == ct.initial_quaternion
    assert dataclasses.asdict(cio_t.load_config(str(tmp_path / "p.prm"))) == dataclasses.asdict(
        cio_j.load_config(str(tmp_path / "p.prm"))
    )


def test_cli_params_writes_the_template(tmp_path, capsys):
    path = str(tmp_path / "template.json")
    assert cli.main(["params", "-p", path]) == 0
    assert "wrote template" in capsys.readouterr().out
    assert _plain(cio_t.load_config(path)) == _plain(cfg_t.ProblemConfig())
    assert dataclasses.asdict(cio_j.load_config(path)) == dataclasses.asdict(cio_t.load_config(path))


def test_module_entry_point(tmp_path):
    """`python -m bemstokes_tpu_torch params` in a fresh interpreter."""
    path = str(tmp_path / "template.json")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run(
        [sys.executable, "-m", "bemstokes_tpu_torch", "params", "-p", path],
        cwd=repo, capture_output=True, text=True, timeout=300,
    )
    assert done.returncode == 0, done.stderr
    assert json.load(open(path))["n_frames"] == 120


def test_cli_convergence_names_its_roadmap_item(tmp_path, capsys):
    """The `convergence` command, which raised while `convergence.py` was
    not ported (the test keeps its name): on a gmsh file of
    create_sphere(0) refined onto the unit sphere, its printed table is
    the JAX package's `format_table` of the same study, character for
    character."""
    from bemstokes_tpu.convergence import convergence_study, format_table
    from bemstokes_tpu.problem import _resolve_manifold

    mesh = create_sphere(refinements=0)
    write_msh(tmp_path / "ball_0.msh", mesh.vertices, mesh.cells)
    cfg = ProblemConfig(
        input_grid_path=str(tmp_path) + os.sep,
        input_grid_base_name="ball_",
        input_grid_format="msh",
        n_cycles=2,
        body_manifold="sphere",
    )
    params = tmp_path / "p.json"
    cio_j.save_config(cfg, str(params))
    assert cli.main(["convergence", "-p", str(params), "-o", str(tmp_path), "--device", "cpu"]) == 0
    printed = capsys.readouterr().out.strip()
    # what the JAX package's `convergence` command computes from cfg
    rows = convergence_study(
        io_j.read_mesh(str(tmp_path / "ball_0.msh"), dim=3, force_material=0),
        3,
        (0.3, 0.3, 0.3),
        n_cycles=cfg.n_cycles,
        manifold=_resolve_manifold(cfg),
        fe_degree=cfg.fe_degree,
        map_degree=cfg.map_degree,
        quad_order=cfg.quadrature.order,
        sing_order=cfg.quadrature.singular_order,
    )
    assert printed == format_table(rows)
    assert len(printed.splitlines()) == 3


# ---- a gait read from frame mesh files ----------------------------------------


def _write_gait(folder, fmt="msh", frames=3):
    """Frames 0..frames-1 of a sphere that grows into a pear along x (fore
    and aft differ, so the stroke swims): one topology, moving nodes."""
    mesh = create_sphere(refinements=1)
    os.makedirs(folder, exist_ok=True)
    for k in range(frames):
        scale = 1.0 + 0.08 * k * mesh.vertices[:, :1]
        WRITERS[fmt](os.path.join(folder, f"gait_{k}.{fmt}"), mesh.vertices * scale, mesh.cells)


def _gait_cfg(folder, fmt="msh", **kw):
    return ProblemConfig(
        grid_type="Real",
        n_frames=3,
        time_step=0.1,
        input_grid_path=str(folder) + os.sep,
        input_grid_base_name="gait_",
        input_grid_format=fmt,
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        **kw,
    )


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("backend", ["gather", "jax"])
def test_cli_run_matches_jax_simulation(backend, tmp_path):
    _write_gait(tmp_path / "grids")
    cfg = _gait_cfg(tmp_path / "grids")
    sj = SimJ(cfg, str(tmp_path / "jax"))
    hj = sj.run(0, 2)
    params = str(tmp_path / "params.json")
    cio_t.save_config(
        dataclasses.replace(cfg_t.from_dict(dataclasses.asdict(cfg)), assembly_backend=backend), params
    )
    out = str(tmp_path / "torch")
    assert cli.main(["run", "-p", params, "--device", "cpu", "0", "2", "-o", out]) == 0
    used = cio_t.load_config(os.path.join(out, "used_parameters_3d.json"))
    assert used.assembly_backend == backend and used.input_grid_base_name == "gait_"
    for h in hj:
        k = h["frame"]
        wj = StateJ.load(os.path.join(sj.out, f"state_{k}.npz"))
        wt = StateT.load(os.path.join(out, f"state_{k}.npz"))
        assert wj.frame == wt.frame == k
        assert np.max(np.abs(wj.rotation - wt.rotation)) <= TOL
        assert np.max(np.abs(wj.displacements - wt.displacements)) <= TOL * max(
            1.0, np.max(np.abs(wj.displacements))
        )
        zj = np.load(os.path.join(sj.out, f"result_{k}.npz"))
        zt = np.load(os.path.join(out, f"result_{k}.npz"))
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert _rel(zt[key], zj[key]) <= TOL, key
        assert np.abs(zj["rigid_velocities"]).max() > 1e-3  # the gait swims
        assert os.path.exists(os.path.join(out, f"stokes_{k}.vtu"))
    # a state file of either package loads in the other
    assert StateT.load(os.path.join(sj.out, "state_1.npz")).frame == 1
    assert StateJ.load(os.path.join(out, "state_1.npz")).frame == 1
    # compose reads the run's dumps
    assert cli.main(["compose", "-p", params, "--device", "cpu", "0", "2", "-o", out]) == 0
    mean_t = np.loadtxt(os.path.join(out, "mean_velocities_stroke.txt"))
    assert _rel(mean_t, sj.compose(0, 2)) <= TOL


def test_frame_mesh_gait_with_anisotropy_removal(tmp_path):
    """`remove_tria_anisotropies` cuts elongated quads of the frame-0 mesh
    and replays the cuts on later frames (UCD files, through
    `SwimmerSimulation`)."""
    mesh = create_sphere(refinements=1)
    os.makedirs(tmp_path / "grids")
    for k in range(3):
        # elongated along x, the fore end growing
        scale = np.array([3.0, 1.0, 1.0]) * (1.0 + 0.08 * k * mesh.vertices[:, :1])
        write_inp(str(tmp_path / "grids" / f"gait_{k}.inp"), mesh.vertices * scale, mesh.cells)
    cfg = _gait_cfg(tmp_path / "grids", fmt="inp", remove_tria_anisotropies=True)
    sj = SimJ(cfg, str(tmp_path / "jax"))
    st = SimT(cfg_t.from_dict(dataclasses.asdict(cfg)), str(tmp_path / "torch"), device="cpu")
    assert st.mesh.n_cells == sj.mesh.n_cells > mesh.n_cells
    np.testing.assert_array_equal(st.mesh.cells, sj.mesh.cells)
    hj, ht = sj.run(0, 2), st.run(0, 2)
    for a, b in zip(hj, ht):
        assert a["iterations"] == b["iterations"]
        assert np.abs(a["rigid_velocities"]).max() > 1e-3
        assert _rel(b["rigid_velocities"], a["rigid_velocities"]) <= TOL


def test_cli_default_device_is_the_card(tmp_path):
    """Without `--device cpu` the command runs on the CUDA card, and fails
    where there is none."""
    _write_gait(tmp_path / "grids", frames=2)
    params = str(tmp_path / "params.json")
    cio_t.save_config(cfg_t.from_dict(dataclasses.asdict(_gait_cfg(tmp_path / "grids"))), params)
    argv = ["run", "-p", params, "0", "1", "-o", str(tmp_path / "out")]
    if torch.cuda.is_available():
        assert cli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            cli.main(argv)


def test_cli_run_profile_writes_a_trace(tmp_path, capsys):
    """`run --profile DIR --device cpu` traces the frame loop with
    torch.profiler into DIR/trace.json (a Chrome trace whose events name the
    frame loop's operators), writes the frames' files as a plain run does,
    and the per-phase timer table still prints."""
    _write_gait(tmp_path / "grids", frames=2)
    params = str(tmp_path / "params.json")
    cio_t.save_config(cfg_t.from_dict(dataclasses.asdict(_gait_cfg(tmp_path / "grids"))), params)
    out, prof = str(tmp_path / "out"), str(tmp_path / "prof")
    argv = ["run", "-p", params, "--device", "cpu", "0", "1", "-o", out, "--profile", prof]
    assert cli.main(argv) == 0
    assert os.listdir(prof) == ["trace.json"]
    with open(os.path.join(prof, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(name.startswith("aten::") for name in names)
    assert os.path.exists(os.path.join(out, "result_0.npz"))
    assert "Assemble + LAC Solve" in capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["msh", "inp"])
def test_load_frame_mesh_matches_jax(fmt, tmp_path):
    """`problem.load_frame_mesh(cfg, frame)` reads the frame file that the
    JAX package's function reads, to the same arrays."""
    from bemstokes_tpu.problem import load_frame_mesh as load_j
    from bemstokes_tpu_torch.problem import load_frame_mesh as load_t

    _write_gait(tmp_path / "grids", fmt=fmt)
    cfg = _gait_cfg(tmp_path / "grids", fmt=fmt)
    cfg_port = cfg_t.from_dict(dataclasses.asdict(cfg))
    for frame in (0, 2):
        mj, mt = load_j(cfg, frame), load_t(cfg_port, frame)
        for key in ("vertices", "cells", "material_id"):
            np.testing.assert_array_equal(getattr(mt, key), getattr(mj, key))
    assert not np.array_equal(load_t(cfg_port, 0).vertices, load_t(cfg_port, 2).vertices)


def test_port_names_the_jax_packages_module_names():
    """`from bemstokes_tpu_torch.ops import assemble_rows` and
    `fem.geometry.make_tables`: the port's `ops` names every name of the
    JAX package's `ops`, and `make_tables` gives the JAX package's tables."""
    import bemstokes_tpu.ops as ops_j
    import bemstokes_tpu_torch.ops as ops_t
    from bemstokes_tpu.fem.geometry import make_tables as tables_j
    from bemstokes_tpu_torch.fem.geometry import QuadratureTables, make_tables
    from bemstokes_tpu_torch.fem.quadrature import gauss_quad
    from bemstokes_tpu_torch.ops import assemble_rows
    from bemstokes_tpu_torch.ops.assemble import assemble_rows as rows

    assert assemble_rows is rows
    assert set(ops_j.__all__) <= set(ops_t.__all__)
    assert all(hasattr(ops_t, name) for name in ops_t.__all__)
    pts, wts = gauss_quad(3)
    tt, tj = make_tables(2, 2, 1, pts, wts), tables_j(2, 2, 1, pts, wts)
    assert isinstance(tt, QuadratureTables)
    for key in ("points", "weights", "phi_map", "dphi_map", "phi_fe"):
        np.testing.assert_array_equal(getattr(tt, key), getattr(tj, key))
    assert tt.phi_map.shape == (9, 9) and tt.phi_fe.shape == (9, 4)
