"""The f32 matrix-free frame with the settings of the JAX package's capacity
run (`preconditioner_dtype="float32"`, `gmres_restart=25`, `tolerance=3e-5`,
`max_steps=200`), the port's against the JAX package's, on the CPU.

At 73,740 unknowns the port's f32 capacity frame stops at a true residual
of 3.7e-5, above its 3e-5 tolerance (`chip_smoke.py` phase 10); the JAX
package's record gives no true residual.  Here both packages solve the
same frame at a size both run: free-space sphere, `ImposedVelocity` along
x, `force_pole="Origin"`, `body_manifold="sphere"`, create_sphere(2) in
blocks of 32 nodes (4 blocks, as the capacity frame has 25).  Both must
converge, the port's true residual ||A x - b|| must be within the tolerance
of |b| and no worse than 1.5x the JAX package's, and the iteration counts
within 2 of each other (f32 rounding orders differ; at this size they are
equal).  `f32_capacity_frame` runs either package at any size: at
create_sphere(3) and (4) it gives the numbers in ROADMAP.md queue 3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

TOLERANCE = 3e-5


def capacity_config(block_nodes):
    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        body_manifold="sphere",
        matrix_free=True,
        matfree_block_nodes=block_nodes,
        dtype="float32",
        solver=SolverConfig(
            preconditioner_dtype="float32", gmres_restart=25, tolerance=TOLERANCE, max_steps=200
        ),
    )


def f32_capacity_frame(package, refinements, block_nodes):
    """One f32 matrix-free frame of `package` ("jax" or "torch", the port on
    the CPU): (iterations, converged, true residual / |b|)."""
    cfg = capacity_config(block_nodes)
    if package == "jax":
        prob = ProblemJ(fac_j.create_sphere(refinements=refinements), cfg)
        res = prob.solve_frame(prob.initial_euler(), jnp.zeros(3 * prob.n, jnp.float32))
    else:
        prob = ProblemT(
            fac_t.create_sphere(refinements=refinements), from_dict(dataclasses.asdict(cfg)), device="cpu"
        )
        res = result_to_numpy(prob.solve_frame(prob.initial_euler(), np.zeros(3 * prob.n, np.float32)))
    b_norm = float(np.linalg.norm(np.asarray(res["rhs"])))
    return res["iterations"], res["converged"], res["residual"] / b_norm


def test_f32_capacity_settings_converge_as_in_jax():
    it_j, conv_j, res_j = f32_capacity_frame("jax", 2, 32)
    it_t, conv_t, res_t = f32_capacity_frame("torch", 2, 32)
    assert conv_j and conv_t
    assert res_t <= TOLERANCE and res_t <= 1.5 * res_j, (res_t, res_j)
    assert abs(it_t - it_j) <= 2 and it_t > 5, (it_t, it_j)
