"""`bemstokes_tpu_torch/flagella.py` against the JAX package's
`bemstokes_tpu/flagella.py`: the initial tube mesh is identical (a numpy
copy), and the three deformation maps and `euler_at_theta` agree to 1e-13
absolute on O(1..10) coordinates in f64 (sin, cos, exp and atan2 of the two
libraries differ by an ulp)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.flagella as fl_j
import bemstokes_tpu_torch.flagella as fl_t
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-13


def _tube(n_length=12, n_around=8, **params):
    mj = fl_j.create_initial_flagellum_mesh(fl_j.FlagellumConfig(**params), n_length, n_around)
    mt = fl_t.create_initial_flagellum_mesh(fl_t.FlagellumConfig(**params), n_length, n_around)
    return mj, mt


@pytest.mark.parametrize("params", [dict(), dict(Lx=5.0, a=0.2, delta_head_flagellum=0.3)])
def test_initial_mesh_identical(params):
    mj, mt = _tube(**params)
    assert np.array_equal(mj.vertices, mt.vertices)
    assert np.array_equal(mj.cells, mt.cells)
    assert np.array_equal(mj.material_id, mt.material_id)
    assert dataclasses.asdict(fl_j.FlagellumConfig(**params)) == dataclasses.asdict(
        fl_t.FlagellumConfig(**params)
    )


def _mask(n, partial):
    mask = np.ones(n)
    if partial:
        mask[::3] = 0.0
    return mask


@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("name", ["reference_spiral_euler", "reference_constant_spiral_euler"])
def test_deformation_maps_match_jax(name, partial):
    mj, mt = _tube()
    mask = _mask(mt.n_vertices, partial)
    out_j = getattr(fl_j, name)(jnp.asarray(mj.vertices), fl_j.FlagellumConfig(), jnp.asarray(mask))
    out_t = getattr(fl_t, name)(torch.as_tensor(mt.vertices), fl_t.FlagellumConfig(), torch.as_tensor(mask))
    assert np.max(np.abs(np.asarray(out_j) - out_t.numpy())) <= TOL
    moved = np.any(out_t.numpy() != mt.vertices, axis=1)
    assert moved.any() and not moved[mask == 0].any()


@pytest.mark.parametrize("theta", [0.0, 0.4, 2.0 * np.pi * 5 / 8])
def test_euler_at_theta_matches_jax(theta):
    mj, mt = _tube()
    mask = _mask(mt.n_vertices, True)
    ref_j = fl_j.reference_constant_spiral_euler(
        jnp.asarray(mj.vertices), fl_j.FlagellumConfig(), jnp.asarray(mask)
    )
    ref_t = fl_t.reference_constant_spiral_euler(
        torch.as_tensor(mt.vertices), fl_t.FlagellumConfig(), torch.as_tensor(mask)
    )
    out_j = fl_j.euler_at_theta(ref_j, theta, jnp.asarray(mask))
    out_t = fl_t.euler_at_theta(ref_t, theta, torch.as_tensor(mask))
    assert np.max(np.abs(np.asarray(out_j) - out_t.numpy())) <= TOL
    # a rotation about x: x and the distance from the axis are kept
    assert (out_t[:, 0] - ref_t[:, 0]).abs().max().item() <= 1e-15
    assert (out_t[:, 1:].norm(dim=1) - ref_t[:, 1:].norm(dim=1)).abs().max().item() <= 1e-13
