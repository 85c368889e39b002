"""The torch Green's functions (bemstokes_tpu_torch.kernels) against the JAX
package's on the same seeded random points, f64: relative agreement 1e-14
of each output's max magnitude (both evaluate the same closed forms; only
the rounding of the elementwise ops can differ)."""

import numpy as np
import pytest
import torch

import bemstokes_tpu.kernels as kj
import bemstokes_tpu.kernels.helpers as hj
import bemstokes_tpu.kernels.stokeslet as sj
import bemstokes_tpu_torch.kernels as kt
import torch_threads  # noqa: F401  (one torch thread a test process)

RTOL = 1e-14


def _points(dim, n=257, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, dim)) * rng.uniform(0.05, 3.0, size=(n, 1))
    nrm = rng.normal(size=(n, dim))
    return p, nrm / np.linalg.norm(nrm, axis=1, keepdims=True)


def _close(a_jax, b_torch, rtol=RTOL):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * np.max(np.abs(a))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_stokeslet_and_stresslet(dim, eps):
    p, _ = _points(dim)
    _close(kj.stokeslet_G(p, eps), kt.stokeslet_G(torch.as_tensor(p), eps))
    _close(kj.stresslet_W(p, eps), kt.stresslet_W(torch.as_tensor(p), eps))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_fused_G_Wn_and_contract_normal(dim, eps):
    p, nrm = _points(dim, seed=1)
    Gj, Wnj = sj.stokeslet_G_Wn(p, nrm, eps)
    Gt, Wnt = kt.stokeslet_G_Wn(torch.as_tensor(p), torch.as_tensor(nrm), eps)
    _close(Gj, Gt)
    _close(Wnj, Wnt)
    # the fused form equals the stresslet contracted with the normal
    Wn_c = kt.contract_normal(kt.stresslet_W(torch.as_tensor(p), eps), torch.as_tensor(nrm))
    _close(kj.contract_normal(kj.stresslet_W(p, eps), nrm), Wn_c)
    _close(Wnj, Wn_c, rtol=1e-13)


@pytest.mark.parametrize("component", [0, 1, 2])
def test_impose_G_helpers(component):
    """The traction helper: JAX differentiates the Stokeslet, the port uses
    the closed-form stresslet it equals (1e-13: autodiff vs closed form)."""
    p, nrm = _points(3, n=64, seed=2)
    src = np.array([0.1, -0.2, 0.3])
    _close(
        hj.impose_G_as_velocity(p, src, component),
        kt.impose_G_as_velocity(torch.as_tensor(p), src, component),
    )
    _close(
        hj.impose_G_as_trace(p, nrm, src, component),
        kt.impose_G_as_trace(torch.as_tensor(p), torch.as_tensor(nrm), src, component),
        rtol=1e-13,
    )


def test_float32_follows_input_dtype():
    p, nrm = _points(3, seed=3)
    G, Wn = kt.stokeslet_G_Wn(torch.as_tensor(p, dtype=torch.float32), torch.as_tensor(nrm, dtype=torch.float32))
    assert G.dtype == Wn.dtype == torch.float32
    Gj, Wnj = sj.stokeslet_G_Wn(p, nrm)
    _close(Gj, G.double(), rtol=1e-6)
    _close(Wnj, Wn.double(), rtol=1e-6)
