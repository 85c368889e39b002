"""The monolithic system's tail (`ops.monolithic.SaddleTail`), the bordered
Schur solve and the one LU apply (`la.direct`), on small seeded inputs in
f64 on the CPU:

- for every `grid_type`, with and without the motor-torque unknown and with
  and without hanging-node rows, the tail's `apply(head, x)` equals the
  JAX package's dense `build_monolithic_system` A @ x (constrained rows by
  its `apply_hanging_constraints_monolithic`) and its `rhs` the dense rhs,
  within 1e-14 of their largest entry; the port's dense build equals the
  JAX package's bit for bit;
- `bordered_solver` inverts a random [[A_s, C], [B, D]] within 1e-12;
- `lu_apply` on one vector, several columns and a batch of blocks gives
  `torch.linalg.lu_solve`'s bits, and `pivots_to_permutation` turns a batch
  of pivots into its permutations with one read back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bemstokes_tpu.mesh.constraints import (
    HangingConstraints as HangingJ,
    apply_hanging_constraints_monolithic as hanging_rows_j,
)
from bemstokes_tpu.ops.monolithic import build_monolithic_system as build_j, imposed_tail_vector as tail_j
from bemstokes_tpu_torch.config import ProblemConfig
from bemstokes_tpu_torch.la import direct
from bemstokes_tpu_torch.mesh.constraints import HangingConstraints, apply_hanging_constraints_monolithic
from bemstokes_tpu_torch.ops.monolithic import SaddleTail, build_monolithic_system
from bemstokes_tpu_torch.utils import timers
import torch_threads  # noqa: F401  (one torch thread a test process)

D, N, R = 3, 8, 6
DN = D * N
GRIDS = ("Real", "ImposedForce", "ImposedVelocity", "Convergence")
#: nodes 2 and 5 hang on the edges (0, 1) and (3, 4)
HANGING = dict(slaves=np.array([2, 5]), masters=np.array([[0, 1], [3, 4]]), weights=np.full((2, 2), 0.5))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(
        V=rng.normal(size=(DN, DN)),
        K=rng.normal(size=(DN, DN)),
        sel_V=rng.random(DN) < 0.6,
        tmp_N=rng.normal(size=(R, DN)),
        N_dual=rng.normal(size=(R, DN)),
        rhs_surface=rng.normal(size=DN),
        tmp_torque=rng.normal(size=DN),
        torque_dual=rng.normal(size=DN),
    )


@pytest.mark.parametrize("hanging", [False, True], ids=["free", "hanging"])
@pytest.mark.parametrize("torque", [False, True], ids=["no_torque", "torque"])
@pytest.mark.parametrize("grid", GRIDS)
def test_tail_apply_and_rhs_are_the_dense_system(grid, torque, hanging):
    cfg = ProblemConfig(
        grid_type=grid,
        solve_with_torque=torque,
        imposed_component=4,
        assemble_scaling=1.5,
        angle_for_imposed_stuff=0.3,
        extra_debug_info=True,
        imposed_motor_torque=-1.75,
    )
    inp = _inputs(GRIDS.index(grid) + 4 * torque + 8 * hanging)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    extra = dict(tmp_torque=j["tmp_torque"], torque_dual=j["torque_dual"]) if torque else {}
    A, rhs = build_j(
        j["V"], j["K"], j["sel_V"], j["tmp_N"], j["N_dual"], j["rhs_surface"],
        grid_type=grid,
        imposed_component=cfg.imposed_component,
        assemble_scaling=cfg.assemble_scaling,
        imposed_motor_torque=cfg.imposed_motor_torque,
        imposed_tail=tail_j(R, D, cfg.imposed_component, angle=cfg.angle_for_imposed_stuff, rotate=True),
        **extra,
    )
    hc = HangingConstraints(**HANGING)
    rows = torch.as_tensor(hc.flat_rows(N, D)) if hanging else None
    if hanging:
        A, rhs = hanging_rows_j(A, rhs, HangingJ(**HANGING), N, D)
    A, rhs = np.array(A), np.array(rhs)

    tail = SaddleTail.from_config(cfg, t["tmp_N"], t["N_dual"], t["tmp_torque"], t["torque_dual"], rows)
    assert tail.size == R + torque and tail.dn == DN
    x = torch.as_tensor(np.random.default_rng(1).normal(size=DN + tail.size))
    head = torch.as_tensor(A[:DN, :DN]) @ x[:DN]
    assert _rel(tail.apply(head, x), A @ x.numpy()) <= 1e-14
    assert _rel(tail.rhs(t["rhs_surface"]), rhs) <= 1e-14
    # the frozen re-solve's rhs: the surface rhs over a zero tail
    surface = inp["rhs_surface"].copy()
    if hanging:
        surface[hc.flat_rows(N, D)] = 0.0
    frozen = np.concatenate([surface, np.zeros(tail.size)])
    assert np.array_equal(tail.frozen_rhs(t["rhs_surface"]).numpy(), frozen)
    # the border is the dense system's, and so is the port's dense build
    C, B, Dc = (m.numpy() for m in tail.border())
    live = np.setdiff1d(np.arange(DN), rows.numpy()) if hanging else np.arange(DN)
    assert np.array_equal(C[live], A[live, DN:]) and not C[np.setdiff1d(np.arange(DN), live)].any()
    assert np.array_equal(B, A[DN:, :DN]) and np.array_equal(Dc, A[DN:, DN:])
    A_t, rhs_t = build_monolithic_system(
        t["V"], t["K"], t["sel_V"], t["tmp_N"], t["N_dual"], t["rhs_surface"],
        grid_type=grid,
        imposed_component=cfg.imposed_component,
        assemble_scaling=cfg.assemble_scaling,
        imposed_motor_torque=cfg.imposed_motor_torque,
        imposed_tail=tail.rhs_tail,
        **(dict(tmp_torque=t["tmp_torque"], torque_dual=t["torque_dual"]) if torque else {}),
    )
    if hanging:
        A_t, rhs_t = apply_hanging_constraints_monolithic(A_t, rhs_t, hc, N, D)
    assert np.array_equal(A_t.numpy(), A) and np.array_equal(rhs_t.numpy(), rhs)


@pytest.mark.parametrize("corner", ["generic", "velocity"])
def test_bordered_solver_inverts_the_bordered_matrix(corner):
    """[[A_s, C], [B, D]]^-1 from A_s's solve: a generic border, and the
    ImposedVelocity shape (zero rows B, D a multiple of the identity)."""
    rng = np.random.default_rng(3)
    m, T = 30, 7
    As = torch.as_tensor(rng.normal(size=(m, m)) + 4.0 * np.eye(m))
    C = torch.as_tensor(rng.normal(size=(m, T)))
    if corner == "generic":
        B, Dc = torch.as_tensor(rng.normal(size=(T, m))), torch.as_tensor(rng.normal(size=(T, T)))
    else:
        B, Dc = torch.zeros((T, m), dtype=torch.float64), 1.5 * torch.eye(T, dtype=torch.float64)
    M = torch.cat([torch.cat([As, C], dim=1), torch.cat([B, Dc], dim=1)])
    lu, piv = direct.lu_factor_dense(As)
    perm = direct.pivots_to_permutation(piv)
    apply = direct.bordered_solver(lambda v: direct.lu_apply(lu, perm, v), C, B, Dc)
    v = torch.as_tensor(rng.normal(size=m + T))
    assert _rel(apply(v), torch.linalg.solve(M, v)) <= 1e-12
    assert _rel(M @ apply(v), v) <= 1e-12


def _pivoting(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape))


@pytest.mark.parametrize(
    "lu_shape,b_shape",
    [((40, 40), (40,)), ((40, 40), (40, 5)), ((8, 24, 24), (8, 24, 1)), ((8, 24, 24), (8, 24, 7))],
    ids=["vector", "columns", "blocks", "block_columns"],
)
def test_lu_apply_is_lu_solve_bit_for_bit(lu_shape, b_shape):
    """One vector, several columns and a batch of blocks: the kept
    permutation's gather and the two triangular solves give
    `torch.linalg.lu_solve`'s bits on the CPU."""
    lu, piv = direct.lu_factor_dense(_pivoting(lu_shape, 11))
    perm = direct.pivots_to_permutation(piv)
    b = _pivoting(b_shape, 12)
    ref = torch.linalg.lu_solve(lu, piv, b[:, None] if b.ndim == 1 else b)
    out = direct.lu_apply(lu, perm, b)
    assert out.shape == b.shape
    assert torch.equal(out, ref[:, 0] if b.ndim == 1 else ref)
    assert torch.equal(direct.lu_solve_dense((lu, piv), b), out)


def test_batched_pivots_read_back_once():
    """A batch of pivots: one read back and one upload, each block's
    permutation that of its own pivots."""
    _, piv = torch.linalg.lu_factor(_pivoting((5, 16, 16), 13))
    timers.reset()
    perm = direct.pivots_to_permutation(piv)
    assert timers.counts["host syncs"] == 2
    assert perm.shape == piv.shape and perm.dtype == torch.long
    for k in range(5):
        assert torch.equal(perm[k], direct.pivots_to_permutation(piv[k]))
