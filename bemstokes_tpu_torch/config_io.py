"""Parameter-file IO: load/save `ProblemConfig` from JSON (native format) or
from reference-style deal.II `.prm` files, so existing BEMStokes parameter
files drive this framework unchanged.

The `.prm` grammar (reference `declare_parameters`/`parse_parameters`,
`source/bem_stokes.cc:208-494`, deal2lkit ParameterAcceptor):

    subsection <Name>
      set <Parameter name> = <value>   # comment
    end

Parameter names are mapped 1:1 to config fields by the PRM_MAP tables below;
the reference's typos ("Monolithic resolurion strategy", "Gmres restart
evert", "Cylinder Heigth") are preserved as accepted spellings.

A copy of `bemstokes_tpu/config_io.py` (that package cannot be imported
without importing jax) over the port's `config.py`, whose fields are the JAX
package's: a `.json` or `.prm` file written for either package loads in the
other.  `tests/test_torch_host_layer.py` pins it to its original.
"""

from __future__ import annotations

import dataclasses
import json
import re

from .config import (
    ProblemConfig,
    SolverConfig,
    QuadratureConfig,
    WallConfig,
    CylinderConfig,
    WallRefinementConfig,
)


def _to_bool(s: str) -> bool:
    return s.strip().lower() in ("true", "1", "yes", "on")


def _to_floats(s: str) -> tuple:
    return tuple(float(x) for x in s.replace(";", ",").split(","))


def _to_bools(s: str) -> tuple:
    return tuple(_to_bool(x) for x in s.split(","))


# reference parameter name -> (dotted config path, converter)
PRM_MAP = {
    "Total number of frames": ("n_frames", int),
    "Delta between frames": ("delta_frame", int),
    "Time interval between frames": ("time_step", float),
    "Grid": ("grid_type", str),
    "Velocity to be used": ("velocity_type", str),
    "Path to velocity": ("input_velocity_path", str),
    "Velocity basename": ("squirming_velocity_basename", str),
    "Force Pole to be used": ("force_pole", str),
    "Force Pole Point Setting": ("force_arbitrary_point", _to_floats),
    "Imposed Component for Non Real Simulation": ("imposed_component", int),
    "Monolithic resolurion strategy": ("monolithic", _to_bool),
    "Monolithic resolution strategy": ("monolithic", _to_bool),
    "Use a direct resolution strategy": ("solver.solve_directly", _to_bool),
    "Use alpha for the internal problem": ("use_internal_alpha", _to_bool),
    "Consider rigid rotations": ("consider_rigid_rotations", _to_bool),
    "Consider rigid displacement to move the swimmer": (
        "consider_rigid_displacements",
        _to_bool,
    ),
    "Time Integration": ("time_integration", str),
    "Reflect the kernel": ("reflect_kernel", _to_bool),
    "Use no slip kernel": ("no_slip_kernel", _to_bool),
    "Impose a torque on the flagellum": ("solve_with_torque", _to_bool),
    "Impose a spherical head to the bacterium": ("spherical_head", _to_bool),
    "Use state from previous frame": ("use_previous_state", _to_bool),
    "Input path to grid": ("input_grid_path", str),
    "Input grid base name": ("input_grid_base_name", str),
    "Input grid format": ("input_grid_format", str),
    "Singular quadrature kind": ("quadrature.singular_type", str),
    "Singular quadrature order": ("quadrature.singular_order", int),
    "Type of preconditioner to be used": ("solver.preconditioner_type", str),
    "Use a bandwith preconditioner": ("solver.bandwith_preconditioner", _to_bool),
    "Bandwith for the preconditioner": ("solver.bandwith", int),
    "Gmres restart evert": ("solver.gmres_restart", int),
    "Gmres restart every": ("solver.gmres_restart", int),
    "Create a bounding box": ("create_box", _to_bool),
    "First wall index to create the box": ("first_index_box", int),
    "Cylindrical wall creation": ("cylinder.create", _to_bool),
    "Cylindrical wall import": ("cylinder.import_mesh", _to_bool),
    "Cylinder Apply Manifold descriptor": ("cylinder.apply_manifold", _to_bool),
    "Cylinder flip normal": ("cylinder.flip_normal", _to_bool),
    "Cylinder Radius": ("cylinder.radius", float),
    "Cylinder Heigth": ("cylinder.height", float),
    "Cylinder Height": ("cylinder.height", float),
    "Cylinder axis orientation": ("cylinder.direction", _to_floats),
    "Cylinder point on axis": ("cylinder.point_on_axis", _to_floats),
    "Cylinder Wall type": ("cylinder.wall_type", str),
    "Cylinder mesh name": ("cylinder.mesh_filename", str),
    "Wall gradual wall refinement": ("wall_refinement.gradual", _to_bool),
    "Wall Refinement Threshold": ("wall_refinement.threshold", float),
    "Distance for wall refinement": ("wall_refinement.distance_from_center", float),
    "Refinement Center For Wall Refinement": ("wall_refinement.center", _to_floats),
    "Internal flagellum generation and handling": ("use_flagellum_handler", _to_bool),
    "Impose a rotation for flagellum shape using the first rotation mode": (
        "imposed_rotation_as_flagellum_shape",
        _to_bool,
    ),
    "Impose a translation for flagellum shape using the first translation mode": (
        "imposed_translation_as_flagellum_shape",
        _to_bool,
    ),
    "Angle to rotate the imposed stuff": ("angle_for_imposed_stuff", float),
    "Build the sphere inside the code": ("build_sphere_in_code", _to_bool),
    "Refinement applied to sphere built inside the code": (
        "internal_sphere_refinements",
        int,
    ),
    "Number of cycles": ("n_cycles", int),
    "Number of convergence iterations": ("num_convergence_cycles", int),
    "Perform 2 sphere analysis": ("two_spheres", _to_bool),
    "Distance for the 2 sphere analysis": ("spheres_distance", float),
    "Print extra debug information": ("extra_debug_info", _to_bool),
    "Scaling for monolithic assembling": ("assemble_scaling", float),
    "Squirmer change the geometry during the stroke": (
        "squirmer_change_geometry",
        _to_bool,
    ),
    "Save matrices as txt files": ("print_matrices", _to_bool),
    "Galerkin Resolution Strategy": ("galerkin", _to_bool),
    "Apply a correction for rigid rotations": ("rotation_correction", _to_bool),
    "Load and save refinement history in the code": (
        "remove_tria_anisotropies",
        _to_bool,
    ),
    "Number of subdivisions": ("n_subdivisions", int),
    "Apply iges manifold to frame tria": ("apply_iges_to_frame", _to_bool),
    "Apply iges manifold to reference tria": (
        "apply_iges_to_reference",
        _to_bool,
    ),
}

# deal.II SolverControl subsection "Solver" (reference `:470-472`)
PRM_MAP_SOLVER = {
    "Max steps": ("solver.max_steps", int),
    "Tolerance": ("solver.tolerance", float),
    "Reduction": ("solver.tolerance", float),
}

# FlagellarGeometryHandler subsection (`source/flagellar_geometry_handler.cc:26-35`)
PRM_MAP_FLAGELLUM = {
    "Number of turns for the spiral": "Nlambda",
    "Length over x axis": "Lx",
    "Flagellar Amplitude": "alpha",
    "Flagellar wave number": "k",
    "Reduction parameter": "ke",
    "Head Flagellum Separation": "delta_head_flagellum",
    "Flagellum cross section radius": "a",
}

_WALL_RE = re.compile(
    r"^(?:Wall (\d+) (bool|spans|type)"
    r"|Wall center position wall (\d+)"
    r"|Flip normal Wall (\d+))$"
)
_QUAT_RE = re.compile(r"^Initial quaternion value q\[(\d)\]$")
_RIGID_AXIS_RE = re.compile(
    r"^Consider rigid displacement ([xyz]) to move the swimmer$"
)
_FE_RE = re.compile(r"FE_Q<\d(?:,\d)?>\((\d+)\)")

N_WALLS = 8


def _set_path(obj, path: str, value):
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    setattr(obj, parts[-1], value)


def parse_prm(text: str, dim: int = 3) -> ProblemConfig:
    """Parse reference-style `.prm` text into a ProblemConfig."""
    cfg = ProblemConfig(dim=dim)
    walls = [WallConfig(enabled=False) for _ in range(N_WALLS)]
    quat = list(cfg.initial_quaternion)
    axes = list(cfg.rigid_displacement_axes)
    flag_params: dict = {}
    section: list[str] = []

    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        low = line.lower()
        if low.startswith("subsection"):
            section.append(line[len("subsection") :].strip())
            continue
        if low == "end":
            if section:
                section.pop()
            continue
        if not low.startswith("set "):
            continue
        key, _, val = line[4:].partition("=")
        key, val = key.strip(), val.strip()
        sec = section[-1] if section else ""

        if "FlagellarGeometryHandler" in sec and key in PRM_MAP_FLAGELLUM:
            flag_params[PRM_MAP_FLAGELLUM[key]] = float(val)
            continue
        if sec == "Solver" and key in PRM_MAP_SOLVER:
            path, conv = PRM_MAP_SOLVER[key]
            _set_path(cfg, path, conv(val))
            continue
        if sec.startswith("Finite Element") and key == "Finite element space":
            m = _FE_RE.search(val)
            if m:
                deg = int(m.group(1))
                if "Mapping" in sec:
                    cfg.map_degree = deg
                else:
                    cfg.fe_degree = deg
            continue
        if sec == "Internal Quadrature" and key == "Quadrature order":
            cfg.quadrature.order = max(1, (int(val) + 1) // 2)
            continue

        m = _WALL_RE.match(key)
        if m:
            if m.group(1) is not None:
                i, what = int(m.group(1)), m.group(2)
                if what == "bool":
                    walls[i].enabled = _to_bool(val)
                elif what == "spans":
                    walls[i].span = _to_floats(val)
                else:
                    walls[i].wall_type = val
            elif m.group(3) is not None:
                walls[int(m.group(3))].position = _to_floats(val)
            else:
                walls[int(m.group(4))].flip_normal = _to_bool(val)
            continue
        m = _QUAT_RE.match(key)
        if m:
            quat[int(m.group(1))] = float(val)
            continue
        m = _RIGID_AXIS_RE.match(key)
        if m:
            axes["xyz".index(m.group(1))] = _to_bool(val)
            continue
        if key in PRM_MAP:
            path, conv = PRM_MAP[key]
            _set_path(cfg, path, conv(val))

    cfg.initial_quaternion = tuple(quat)
    cfg.rigid_displacement_axes = tuple(axes)
    cfg.walls = tuple(walls)
    if flag_params:
        cfg.use_flagellum_handler = True
        cfg.flagellum_params = flag_params
    return cfg


# ---------------------------------------------------------------------------
# JSON (native) round-trip
# ---------------------------------------------------------------------------

def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> ProblemConfig:
    d = dict(d)
    sub = {
        "quadrature": QuadratureConfig,
        "solver": SolverConfig,
        "cylinder": CylinderConfig,
        "wall_refinement": WallRefinementConfig,
    }
    for k, cls in sub.items():
        if k in d and isinstance(d[k], dict):
            d[k] = cls(**d[k])
    if "walls" in d:
        d["walls"] = tuple(
            WallConfig(**w) if isinstance(w, dict) else w for w in d["walls"]
        )
    for k in ("force_arbitrary_point", "initial_quaternion", "rigid_displacement_axes"):
        if k in d and isinstance(d[k], list):
            d[k] = tuple(d[k])
    return ProblemConfig(**d)


def load_config(path: str, dim: int = 3) -> ProblemConfig:
    """Load a config from `.json` (native) or `.prm` (reference format)."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        return config_from_dict(json.loads(text))
    return parse_prm(text, dim=dim)


def save_config(cfg: ProblemConfig, path: str):
    """Write the fully-expanded config (the analog of the reference's
    `used_parameters_*.prm` echo, `source/main.cc:34-37`)."""
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2, default=str)
