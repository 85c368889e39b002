"""The port's kernel derivatives, periodic kernels and hypersingular
tensor against the JAX package's, on the same seeded numpy separations,
f64:

- `kernels/autodiff.py` (`torch.func.jacfwd` under `torch.func.vmap`
  against `jax.jacfwd` under `jax.vmap`): `grad_stokeslet_G`,
  `grad_stresslet_W`, `stokeslet_pressure`, `stokeslet_stress`, 1e-13
  relative to the largest entry; the stress also against the closed form
  the port's `kernels/helpers.py` uses (the stresslet), 1e-13;
- `kernels/repeated.py`: `repeated_G`, `repeated_W`, `repeated_G_Wn`,
  1e-13 (sums of 2 n + 1 images in the same order);
- `kernels/stokeslet.py:hypersingular_L`, 1e-13, with and without eps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.kernels as kern_j
import bemstokes_tpu.kernels.autodiff as ad_j
import bemstokes_tpu.kernels.repeated as rep_j
import bemstokes_tpu_torch.kernels as kern_t
import bemstokes_tpu_torch.kernels.autodiff as ad_t
import bemstokes_tpu_torch.kernels.repeated as rep_t
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-13


def _p(shape=(4, 5), seed=0, dim=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape + (dim,)) + 0.3


def _close(a_j, a_t, tol=TOL):
    a_j = np.asarray(a_j)
    a_t = a_t.numpy()
    assert a_j.shape == a_t.shape
    assert np.max(np.abs(a_j - a_t)) <= tol * np.max(np.abs(a_j))


AUTODIFF = ("grad_stokeslet_G", "grad_stresslet_W", "stokeslet_pressure", "stokeslet_stress")


# the Stokeslet stress identity is stated in 3D (both docstrings)
@pytest.mark.parametrize(
    "name, dim", [(name, dim) for name in AUTODIFF for dim in (2, 3) if (name, dim) != ("stokeslet_stress", 2)]
)
def test_autodiff_matches_jax(name, dim):
    p = _p(seed=len(name), dim=dim)
    _close(getattr(ad_j, name)(jnp.asarray(p)), getattr(ad_t, name)(torch.as_tensor(p)))


def test_stokeslet_stress_is_the_stresslet():
    """The AD stress equals the closed form `kernels/helpers.py` uses for
    the exact traction trace."""
    p = torch.as_tensor(_p(seed=3))
    sig = ad_t.stokeslet_stress(p)
    W = kern_t.stresslet_W(p)
    assert torch.max(torch.abs(sig - W)) <= TOL * torch.max(torch.abs(W))


def test_grad_stokeslet_G_matches_central_difference():
    p = torch.as_tensor(_p(shape=(6,), seed=4) + 1.0)
    g = ad_t.grad_stokeslet_G(p)
    h = 1e-6
    for k in range(3):
        dp = torch.zeros(3, dtype=torch.float64)
        dp[k] = h
        fd = (kern_t.stokeslet_G(p + dp) - kern_t.stokeslet_G(p - dp)) / (2 * h)
        assert torch.max(torch.abs(g[..., k] - fd)) < 1e-7


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("name", ["repeated_G", "repeated_W", "repeated_G_Wn"])
def test_repeated_matches_jax(name, axis):
    p = _p(shape=(3, 4), seed=axis)
    n = _p(shape=(3, 4), seed=10 + axis)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    kw = dict(h=1.7, axis=axis, n_images=6)
    if name == "repeated_G_Wn":
        out_j = rep_j.repeated_G_Wn(jnp.asarray(p), jnp.asarray(n), **kw)
        out_t = rep_t.repeated_G_Wn(torch.as_tensor(p), torch.as_tensor(n), **kw)
        for a_j, a_t in zip(out_j, out_t):
            _close(a_j, a_t)
    else:
        _close(getattr(rep_j, name)(jnp.asarray(p), **kw), getattr(rep_t, name)(torch.as_tensor(p), **kw))


def test_repeated_G_is_the_image_sum():
    p = torch.tensor([0.3, 0.4, -0.2], dtype=torch.float64)
    G = rep_t.repeated_G(p, 2.0, axis=1, n_images=10)
    ref = sum(
        kern_t.stokeslet_G(p + torch.tensor([0.0, 2.0 * k, 0.0], dtype=torch.float64))
        for k in range(-10, 11)
    )
    torch.testing.assert_close(G, ref, rtol=1e-14, atol=1e-15)
    torch.testing.assert_close(G, G.T, rtol=0, atol=1e-15)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
@pytest.mark.parametrize("dim", [2, 3])
def test_hypersingular_L_matches_jax(dim, eps):
    p = _p(seed=dim, dim=dim)
    _close(kern_j.hypersingular_L(jnp.asarray(p), eps), kern_t.hypersingular_L(torch.as_tensor(p), eps))
    assert kern_t.hypersingular_L(torch.as_tensor(p)).shape == p.shape + (dim,) * 3
