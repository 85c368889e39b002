"""`bemstokes_tpu_torch/kernels/images.py` against the JAX package's
`bemstokes_tpu/kernels/images.py`: every function, all three wall axes, the
same seeded numpy inputs, f64.  Tolerance 1e-13 relative to the largest
entry (the two packages round integer powers and sums in slightly different
orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.kernels.images as img_j
import bemstokes_tpu_torch.kernels.images as img_t
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-13


def _inputs(wall_axis, seed=0, shape=(5, 7)):
    """p, p_image (p with the wall component shifted by twice a positive
    height, as the assembly builds them) and unit normals."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape + (3,))
    h0 = rng.uniform(0.2, 3.0, size=shape)
    p_image = p.copy()
    p_image[..., wall_axis] += 2.0 * h0
    n = rng.normal(size=shape + (3,))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return p, p_image, n


def _close(a_j, a_t):
    a_j = np.asarray(a_j)
    a_t = a_t.numpy()
    assert a_j.shape == a_t.shape
    assert np.max(np.abs(a_j - a_t)) <= TOL * np.max(np.abs(a_j))


CASES = {
    "free_surface_G": lambda m, p, pI, n, w: m.free_surface_G(p, pI, w),
    "free_surface_G_col": lambda m, p, pI, n, w: m.free_surface_G(p, pI, w, sign_on="col"),
    "free_surface_W": lambda m, p, pI, n, w: m.free_surface_W(p, pI, w),
    "free_surface_W_col": lambda m, p, pI, n, w: m.free_surface_W(p, pI, w, sign_on="col"),
    "no_slip_wall_G": lambda m, p, pI, n, w: m.no_slip_wall_G(p, pI, w),
    "no_slip_wall_W": lambda m, p, pI, n, w: m.no_slip_wall_W(p, pI, w),
    "no_slip_wall_singular_GW": lambda m, p, pI, n, w: m.no_slip_wall_singular_GW(p, pI, n, w),
    "free_surface_G_Wn_G": lambda m, p, pI, n, w: m.free_surface_G_Wn(p, pI, n, w)[0],
    "free_surface_G_Wn_Wn": lambda m, p, pI, n, w: m.free_surface_G_Wn(p, pI, n, w)[1],
    "no_slip_wall_Wn": lambda m, p, pI, n, w: m.no_slip_wall_Wn(p, pI, n, w),
    "no_slip_wall_G_eps": lambda m, p, pI, n, w: m.no_slip_wall_G(p, pI, w, eps=1e-3),
    "no_slip_wall_Wn_eps": lambda m, p, pI, n, w: m.no_slip_wall_Wn(p, pI, n, w, eps=1e-3),
}


@pytest.mark.parametrize("wall_axis", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_image_function_matches_jax(name, wall_axis):
    p, pI, n = _inputs(wall_axis, seed=wall_axis)
    out_j = CASES[name](img_j, jnp.asarray(p), jnp.asarray(pI), jnp.asarray(n), wall_axis)
    out_t = CASES[name](
        img_t, torch.as_tensor(p), torch.as_tensor(pI), torch.as_tensor(n), wall_axis
    )
    _close(out_j, out_t)


@pytest.mark.parametrize("wall_axis", [0, 1, 2])
def test_image_point_matches_jax(wall_axis):
    x = np.random.default_rng(3).normal(size=(4, 6, 3))
    out_j = img_j.image_point(jnp.asarray(x), wall_axis, -1.7)
    out_t = img_t.image_point(torch.as_tensor(x), wall_axis, -1.7)
    assert np.array_equal(np.asarray(out_j), out_t.numpy())
    # the input is not modified in place
    assert np.array_equal(x, np.random.default_rng(3).normal(size=(4, 6, 3)))


@pytest.mark.parametrize("wall_axis", [0, 1, 2])
def test_fused_contractions_equal_rank3_forms(wall_axis):
    """W . n of the rank-3 kernels equals the fused forms (the identity the
    assembly relies on), within the port itself: 1e-13 relative."""
    p, pI, n = (torch.as_tensor(a) for a in _inputs(wall_axis, seed=10 + wall_axis))
    Wn = torch.einsum("...ijk,...k->...ij", img_t.no_slip_wall_W(p, pI, wall_axis), n)
    fused = img_t.no_slip_wall_Wn(p, pI, n, wall_axis)
    assert (Wn - fused).abs().max() <= TOL * fused.abs().max()
    Wn = torch.einsum("...ijk,...k->...ij", img_t.free_surface_W(p, pI, wall_axis), n)
    fused = img_t.free_surface_G_Wn(p, pI, n, wall_axis)[1]
    assert (Wn - fused).abs().max() <= TOL * fused.abs().max()
    G = img_t.free_surface_G(p, pI, wall_axis)
    assert (G - img_t.free_surface_G_Wn(p, pI, n, wall_axis)[0]).abs().max() <= TOL * G.abs().max()


def test_float32_follows_input_dtype():
    p, pI, n = (torch.as_tensor(a, dtype=torch.float32) for a in _inputs(1))
    assert img_t.no_slip_wall_G(p, pI, 1).dtype == torch.float32
    assert img_t.no_slip_wall_Wn(p, pI, n, 1).dtype == torch.float32
    assert img_t.free_surface_G_Wn(p, pI, n, 1)[1].dtype == torch.float32
