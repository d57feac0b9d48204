"""Soft-DTW backward: the port's plain E-recursion (kernel E's plain version)
and the differentiable cost against the JAX package's scan, its Pallas
backward kernel in interpret mode, its custom VJP and the numpy oracle,
float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.ops import softdtw as jsd
from golfaction_tpu.ops.pallas import softdtw_kernel as jpk
from golfaction_tpu_torch.ops import launches_since
from golfaction_tpu_torch.ops import softdtw as tsd
from golfaction_tpu_torch.utils import profiling

GAMMA = 0.1
SHAPES = [(1, 1), (6, 6), (5, 12), (12, 5), (16, 9)]


def _D(seed, B, Ta, Tb, dim=8):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, Ta, dim)).astype(np.float32)
    b = rng.normal(size=(B, Tb, dim)).astype(np.float32)
    return tsd.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.parametrize("Ta,Tb", SHAPES)
def test_backward_plain_matches_jax_scan(Ta, Tb):
    D = _D(Ta * 13 + Tb, 3, Ta, Tb)
    R = tsd.wavefront(D, GAMMA)
    E = tsd.softdtw_backward_plain(D, R, GAMMA).numpy()
    for k in range(3):
        Dj = jnp.asarray(D[k].numpy())
        want = jsd._backward_scan(Dj, jsd._forward_scan(Dj, GAMMA), GAMMA)
        # rtol 1e-4: float32 products of up to Ta+Tb exponential weights.
        np.testing.assert_allclose(E[k], np.asarray(want), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("Ta,Tb", [(6, 6), (5, 12), (12, 5)])
def test_backward_plain_matches_pallas_kernel_interpreted(Ta, Tb):
    D = _D(100 + Ta * Tb, 3, Ta, Tb)
    R = tsd.wavefront(D, GAMMA)
    E = tsd.softdtw_backward_plain(D, R, GAMMA).numpy()
    Eskew = jpk._backward_batch(jpk.skew(jnp.asarray(D.numpy())), jpk.skew(jnp.asarray(R.numpy())),
                                GAMMA, interpret=True)
    want = np.asarray(jpk.unskew(Eskew, Ta, Tb))
    np.testing.assert_allclose(E, want, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("Ta,Tb", SHAPES)
def test_backward_plain_matches_numpy_oracle(Ta, Tb):
    D = _D(Ta + 7 * Tb, 2, Ta, Tb)
    E = tsd.softdtw_backward(D, tsd.wavefront(D, GAMMA), GAMMA).numpy()
    for k in range(2):
        d = D[k].double().numpy()
        _, R = tsd.softdtw_reference(d, GAMMA)
        want = tsd.softdtw_grad_reference(d, R, GAMMA)
        np.testing.assert_array_equal(want, jsd.softdtw_grad_reference(d, R, GAMMA))
        # The oracle runs in float64 on a float64 table: rtol 1e-3 absorbs
        # the float32 table the port's recursion reads.
        np.testing.assert_allclose(E[k], want, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("Ta,Tb", SHAPES)
def test_cost_gradient_matches_jax_grad(Ta, Tb):
    D = _D(Ta * 5 + Tb, 3, Ta, Tb)
    g_out = torch.tensor([1.0, -2.0, 0.5])
    Dt = D.clone().requires_grad_()
    cost = tsd.softdtw_cost(Dt, GAMMA)
    (g,) = torch.autograd.grad((cost * g_out).sum(), Dt)

    def f(d):
        return (jax.vmap(lambda x: jsd.softdtw_cost(x, GAMMA))(d) * jnp.asarray(g_out.numpy())).sum()

    cj, gj = jax.value_and_grad(f)(jnp.asarray(D.numpy()))
    np.testing.assert_allclose(float((cost.detach() * g_out).sum()), float(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-7)


def test_cost_gradient_of_a_strided_view():
    D = _D(9, 2, 7, 5)
    Dt = D.transpose(1, 2).contiguous().requires_grad_()       # [2, 5, 7]
    (g,) = torch.autograd.grad(tsd.softdtw_cost(Dt.transpose(1, 2), GAMMA).sum(), Dt)
    E = tsd.softdtw_backward(D, tsd.wavefront(D, GAMMA), GAMMA)
    np.testing.assert_array_equal(g.numpy(), E.transpose(1, 2).numpy())


def test_gradient_is_a_soft_alignment():
    # E is the expected alignment: 1 at both corners, and for identical
    # sequences its mass sits on the diagonal.
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(1, 9, 4)).astype(np.float32))
    D = tsd.pairwise_sqdist(a, a)
    cost, E = tsd.softdtw_with_alignment(D, GAMMA)
    cj, Ej = jsd.softdtw_with_alignment(jnp.asarray(D[0].numpy()), GAMMA)
    np.testing.assert_allclose(float(cost[0]), float(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(E[0].numpy(), np.asarray(Ej), rtol=1e-4, atol=1e-7)
    assert E[0, 0, 0] == pytest.approx(1.0, rel=1e-4) and E[0, -1, -1] == 1.0
    assert (E[0].argmax(dim=1) == torch.arange(9)).all()


def test_hard_minimum_has_no_gradient():
    D = _D(0, 1, 4, 4)
    with pytest.raises(ValueError):
        tsd.softdtw_cost(D, 0.0)
    with pytest.raises(ValueError):
        tsd.softdtw_backward(D, tsd.wavefront(D, 0.0), 0.0)
    with pytest.raises(ValueError):
        tsd.softdtw_cost(D[0], GAMMA)


def test_backward_on_cpu_launches_nothing():
    D = _D(1, 2, 5, 6).requires_grad_()
    since = profiling.totals()
    tsd.softdtw_cost(D, GAMMA).sum().backward()
    launched = launches_since(since)
    assert (launched["softdtw_bwd"], launched["softdtw"]) == (0, 0)
    assert D.grad.shape == D.shape
