"""Configuration tree — the dataclass replacement for the reference's
deal2lkit `.prm` parameter system (reference `declare_parameters`,
`source/bem_stokes.cc:208-494`).  Field names track the reference parameters;
defaults match the reference's declared defaults.

A copy of `bemstokes_tpu/config.py` (that package cannot be imported without
importing jax).  The torch port accepts every field, so a JAX config converts
with `from_dict(dataclasses.asdict(cfg))`; fields that only select a TPU code
path are read by nothing in the port and say so below.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WallConfig:
    enabled: bool = False
    wall_type: str = "no_slip"  # no_slip|free_surface|do_nothing|dirichlet|neumann
    position: tuple = (0.0, 5.0, 0.0)
    span: tuple = (10.0, 0.0, 10.0)  # 0 entry = wall-normal axis; -1 = infinite
    flip_normal: bool = False


@dataclasses.dataclass
class SolverConfig:
    tolerance: float = 1e-10
    max_steps: int = 1000
    gmres_restart: int = 100
    preconditioner_type: str = "Direct"  # AMG|ILU|Jacobi|SOR|SSOR|Direct
    solve_directly: bool = False
    bandwith_preconditioner: bool = False
    bandwith: int = 100
    refactor_iteration_trigger: int = 100
    # dtype of the Direct-preconditioner LU factors: "same" follows the
    # problem dtype; "float32" factors in f32 and applies the stale LU as a
    # preconditioner for f64 GMRES
    preconditioner_dtype: str = "same"
    # the JAX package's split-precision f64 GEMV threshold; unread by the
    # torch port, whose device has native f64 (every product is `A @ v`)
    split_f64_gemv_threshold: int = 8192


@dataclasses.dataclass
class QuadratureConfig:
    order: int = 4  # per-direction Gauss order on smooth panels
    singular_order: int = 5
    singular_type: str = "Mixed"  # Mixed|Duffy|Telles
    # adaptive two-level quadrature: dense pass at `order_far`, each node's
    # `near_panels` nearest panels upgraded to `order` by a gathered
    # correction pass (None = classic single-pass at `order`)
    order_far: int | None = None
    near_panels: int = 32
    # near-contact auto-promotion: when distinct surface components (or the
    # surface and its wall image under an image kernel) come closer than the
    # local panel diameter, automatically switch to the adaptive two-level
    # scheme with the near-pair order raised by `promote_boost` (the smooth
    # rule stops converging on quasi-singular near pairs; see
    # mesh/proximity.py and tests/test_near_contact.py).  Only acts when
    # `order_far` is None (an explicit adaptive config wins).  NOTE: the
    # decision is made ONCE from the construction-time mesh geometry; a
    # trajectory whose gait/drift closes a gap mid-run keeps its original
    # quadrature (re-construct the problem per regime, or set order_far
    # explicitly, for near-contact that develops over time).
    auto_promote: bool = True
    promote_boost: int = 4


@dataclasses.dataclass
class CylinderConfig:
    """Cylindrical wall parameters (reference `source/bem_stokes.cc:328-360`,
    built by `create_cylindrical_wall` `:887-1156`)."""

    create: bool = False
    import_mesh: bool = False
    apply_manifold: bool = True
    flip_normal: bool = False
    radius: float = 1.0
    height: float = 2.0  # reference spells it "Heigth"
    direction: tuple = (0.0, 0.0, 1.0)
    point_on_axis: tuple = (0.0, 0.0, 0.0)
    wall_type: str = "no_slip"
    mesh_filename: str = "cylinder"


@dataclasses.dataclass
class WallRefinementConfig:
    """Local wall refinement (reference `refine_walls`,
    `source/bem_stokes.cc:1478-1519`, applied in `read_domain` `:808`).

    The reference applies it unconditionally (the threshold test makes it a
    no-op on fine walls); here `enabled` gates the pass explicitly so coarse
    wall factories keep their configured resolution unless asked."""

    enabled: bool = False
    gradual: bool = False
    threshold: float = 1.0
    distance_from_center: float = 2.0
    center: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class ProblemConfig:
    dim: int = 3
    fe_degree: int = 1
    map_degree: int = 1
    n_frames: int = 120
    delta_frame: int = 1
    time_step: float = 0.1
    grid_type: str = "Real"  # Real|ImposedForce|Cube|Convergence|ImposedVelocity
    velocity_type: str = "FiniteDifference"  # FiniteDifference|Squirmer
    force_pole: str = "Origin"  # Baricenter|Origin|Point
    force_arbitrary_point: tuple = (1.0, 0.0, 0.0)
    imposed_component: int = 1
    assemble_scaling: float = 1.0
    monolithic: bool = True
    use_internal_alpha: bool = False
    # K solid-angle diagonal replacement (reference `:3044-3098`): "full"
    # forces full-row versor sums to identity like the reference — exact
    # only when the total boundary is closed; "component" restricts the row
    # sum to each node's own connected component (alpha = 1 closed, 1/2 open
    # flat walls), which stays exact with open resolved walls in the mesh
    alpha_row_sum: str = "full"  # full|component
    consider_rigid_rotations: bool = True
    consider_rigid_displacements: bool = False
    rigid_displacement_axes: tuple = (False, False, False)
    time_integration: str = "Forward"  # Forward|Heun
    initial_quaternion: tuple = (1.0, 0.0, 0.0, 0.0)
    reflect_kernel: bool = False  # free-surface image kernel
    no_slip_kernel: bool = False  # Blake image kernel
    solve_with_torque: bool = False
    use_previous_state: bool = False
    squirmer_change_geometry: bool = True
    input_grid_path: str = "../debug_grids/"
    input_grid_base_name: str = "sphere_mesh_3d_"
    input_grid_format: str = "msh"
    input_velocity_path: str = "../squirmer_vel/"
    squirming_velocity_basename: str = "squirming_velocity_"
    quadrature: QuadratureConfig = dataclasses.field(default_factory=QuadratureConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    walls: tuple = dataclasses.field(default_factory=tuple)  # of WallConfig
    create_box: bool = False
    first_index_box: int = 0
    cylinder: CylinderConfig = dataclasses.field(default_factory=CylinderConfig)
    wall_refinement: WallRefinementConfig = dataclasses.field(
        default_factory=WallRefinementConfig
    )
    # flagellum / bacterium modelling flags (reference `:216-218, 320-322, 453`)
    use_flagellum_handler: bool = False
    flagellum_params: dict = dataclasses.field(default_factory=dict)
    spherical_head: bool = False
    imposed_rotation_as_flagellum_shape: bool = False
    imposed_translation_as_flagellum_shape: bool = False
    # motor-torque balance value when solve_with_torque (the reference
    # hard-codes -2 at `source/bem_stokes.cc:3354`)
    imposed_motor_torque: float = -2.0
    angle_for_imposed_stuff: float = 0.0
    # built-in sphere generation (reference `:288-290`)
    build_sphere_in_code: bool = False
    internal_sphere_refinements: int = 3
    # convergence-study controls (reference `:210, 268`); NOTE
    # num_convergence_cycles is declared-but-dead in the reference too (its
    # `num_convergence_cycle` member has zero readers) — parsed for .prm
    # parity, `n_cycles` is the live control
    n_cycles: int = 4
    num_convergence_cycles: int = 3
    # two-sphere analysis (reference `:212-214`)
    two_spheres: bool = False
    spheres_distance: float = 2.2
    extra_debug_info: bool = False
    # dump the assembled operators as txt files each solve (reference
    # `print_matrices`, `source/bem_stokes.cc:3362-3430`: monolithic/V/K/
    # mass/normals into the working directory)
    print_matrices: bool = False
    # Galerkin double-integral assembly: the reference ships it gutted
    # ("just experimental ... not fit for real simulations",
    # `include/bem_stokes.h:230-233`; body commented out) — parsed for .prm
    # parity, enabling it raises
    galerkin: bool = False
    # declared-but-dead in the reference (its `rotation_correction` member
    # has zero readers) — parsed for .prm parity
    rotation_correction: bool = False
    # reference calls GridTools::remove_anisotropy on read meshes
    # (`source/bem_stokes.cc:662, 2305`): SwimmerSimulation applies
    # mesh.refine.remove_anisotropy (anisotropic cut_x/cut_y splits of
    # elongated quads) to the base mesh and replays the same cuts on every
    # frame mesh so the gait keeps one topology
    remove_tria_anisotropies: bool = False
    # extra VTU patch subdivisions (reference DataOut build_patches degree +
    # n_subdivisions, `:5219`); patches here always render at FE-degree
    # resolution (= the reference default n_subdivisions 0)
    n_subdivisions: int = 0
    # iges CAD manifolds are OCE-gated in the reference (`:532-578`); no CAD
    # kernel here (see mesh/io.py) — enabling either flag raises
    # NotImplementedError in StokesBEMProblem (like `galerkin`)
    apply_iges_to_frame: bool = False
    apply_iges_to_reference: bool = False
    # distributed (multi-device) frame solves; not ported yet (ROADMAP.md)
    distributed: bool = False
    distributed_devices: int | None = None  # None = all devices
    # matrix-free monolithic solve (matfree.py): the operators are never
    # formed, the GMRES matvec is the fused sweep (ops.matfree_node) plus the
    # sparse COO deltas, preconditioned by block-Jacobi diagonal blocks with
    # an exact Schur tail; overrides solve_directly and print_matrices
    matrix_free: bool = False
    matfree_block_nodes: int = 1024  # preconditioner diagonal-block size
    # keep the assembled V/K operators in each frame's result (needed by
    # the frozen-geometry fast path, the resistance strategy and
    # print_matrices).  False drops them from the pipeline's outputs
    # — at f64 production scale that is 5.4 GB of HBM residency the solve
    # does not need (the monolithic A carries everything)
    keep_operators: bool = True
    # JAX sweep backend override for the fused matvec; unread by the port
    matfree_backend: str | None = None
    # numerics
    dtype: str = "float64"
    row_tile: int = 32
    cell_chunk: int = 256
    # JAX assembly knobs, unread by the torch port: it always runs the
    # node-mode assembly (the K1 kernel on a CUDA tensor, its plain torch
    # version on a CPU tensor); mixed_precision_bulk raises there
    assembly_backend: str = "jax"
    mixed_precision_bulk: bool = False
    pallas_reduce: str = "gemm"
    # curved geometry: snap high-order mapping nodes onto an analytic body
    # manifold (none|sphere|spheroid|cylinder) — required to reach the 1e-6
    # sphere-drag validation target with map_degree >= 2
    body_manifold: str = "none"
    body_manifold_center: tuple = (0.0, 0.0, 0.0)
    body_manifold_radii: tuple = (2.0, 1.0, 1.0)  # spheroid semi-axes
    # exact manifold radius: map nodes snap onto the analytic surface; None
    # keeps the (approximate) mesh-file geometry with per-cell projection
    body_manifold_radius: float | None = 1.0


_NESTED = {
    "quadrature": QuadratureConfig,
    "solver": SolverConfig,
    "cylinder": CylinderConfig,
    "wall_refinement": WallRefinementConfig,
}


def from_dict(d: dict) -> ProblemConfig:
    """Rebuild a ProblemConfig from `dataclasses.asdict(cfg)` of this class
    or of the JAX package's (same field names), nested configs and walls
    included."""
    kw = dict(d)
    for name, cls in _NESTED.items():
        if isinstance(kw.get(name), dict):
            kw[name] = cls(**kw[name])
    kw["walls"] = tuple(
        w if isinstance(w, WallConfig) else WallConfig(**w)
        for w in kw.get("walls", ())
    )
    return ProblemConfig(**kw)
