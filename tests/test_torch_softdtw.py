"""Soft-DTW and hard-DTW: the port's plain wavefront (kernel C's plain
version), masked cost, backtrack and warp against the numpy oracles and the
JAX package, float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu.ops import softdtw as jsd
from golfaction_tpu_torch.ops import softdtw as tsd


def _D(seed, B, Ta, Tb, dim=8):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, Ta, dim)).astype(np.float32)
    b = rng.normal(size=(B, Tb, dim)).astype(np.float32)
    return a, b, tsd.pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b))


def test_pairwise_sqdist_matches_jax():
    a, b, D = _D(0, 2, 7, 5)
    np.testing.assert_allclose(D.numpy(), np.asarray(jsd.pairwise_sqdist(a, b)),
                               rtol=1e-5, atol=1e-5)


SHAPES = [(1, 1), (6, 6), (5, 12), (12, 5), (16, 9)]


@pytest.mark.parametrize("Ta,Tb", SHAPES)
def test_cost_matches_oracle(Ta, Tb):
    _, _, D = _D(Ta * 31 + Tb, 2, Ta, Tb)
    R = tsd.wavefront(D, 0.1)
    for k in range(2):
        cost, Rref = tsd.softdtw_reference(D[k].double().numpy(), 0.1)
        np.testing.assert_allclose(float(R[k, -1, -1]), cost, rtol=1e-5)
        np.testing.assert_allclose(R[k].numpy(), Rref[1:, 1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("Ta,Tb", SHAPES)
def test_hard_path_matches_oracle(Ta, Tb):
    _, _, D = _D(Ta * 17 + Tb, 2, Ta, Tb)
    la = torch.full((2,), Ta, dtype=torch.int32)
    lb = torch.full((2,), Tb, dtype=torch.int32)
    path, length = tsd.dtw_path_masked(D, la, lb)
    for k in range(2):
        want = tsd.dtw_path_reference(D[k].numpy())
        n = int(length[k])
        assert n == len(want)
        np.testing.assert_array_equal(path[k, :n].numpy(), want)
        assert (path[k, n:] == -1).all()


def test_oracles_are_the_jax_packages():
    _, _, D = _D(3, 1, 6, 8)
    d = D[0].numpy()
    c, R = tsd.softdtw_reference(d, 0.1)
    cj, Rj = jsd.softdtw_reference(d, 0.1)
    assert c == cj and np.array_equal(R, Rj)
    np.testing.assert_array_equal(tsd.dtw_path_reference(d), jsd.dtw_path_reference(d))


@pytest.mark.parametrize("la,lb", [(16, 9), (11, 9), (4, 2), (1, 1), (16, 1)])
def test_masked_cost_and_path_match_jax(la, lb):
    _, _, D = _D(la * 7 + lb, 1, 16, 9)
    jD = jnp.asarray(D[0].numpy())
    want_cost = float(jsd.softdtw_cost_masked(jD, la, lb, 0.1))
    want_path, want_len = jsd.dtw_path_masked(jD, la, lb)
    lat = torch.tensor([la], dtype=torch.int32)
    lbt = torch.tensor([lb], dtype=torch.int32)
    got_cost = float(tsd.softdtw_cost_masked(D, lat, lbt, 0.1)[0])
    got_path, got_len = tsd.dtw_path_masked(D, lat, lbt)
    np.testing.assert_allclose(got_cost, want_cost, rtol=1e-5)
    assert int(got_len[0]) == int(want_len)
    np.testing.assert_array_equal(got_path[0].numpy(), np.asarray(want_path))


def test_hard_table_matches_jax():
    _, _, D = _D(9, 1, 10, 13)
    want = np.asarray(jsd._hard_forward(jnp.asarray(D[0].numpy())))
    np.testing.assert_allclose(tsd.wavefront(D, 0.0)[0].numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("length", [12, 20])
def test_warp_by_path_matches_jax(length):
    rng = np.random.default_rng(length)
    _, _, D = _D(length, 1, 12, 10)
    path, n = tsd.dtw_path_masked(D, torch.tensor([12]), torch.tensor([10]))
    path = path[0].numpy()
    if length < int(n[0]):
        n = torch.tensor([length])
    ref_vals = rng.normal(size=(10, 17, 3)).astype(np.float32)
    want = jsd.warp_by_path(jnp.asarray(ref_vals), jnp.asarray(path), int(n[0]), 16)
    got = tsd.warp_by_path(torch.from_numpy(ref_vals), torch.from_numpy(path), int(n[0]), 16)
    assert got.shape == (16, 17, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wavefront_on_cpu_launches_nothing():
    _, _, D = _D(1, 2, 5, 6)
    n0 = tsd.wavefront.launches
    tsd.wavefront(D, 0.1)
    assert tsd.wavefront.launches == n0


def test_batched_jax_scan_matches_port():
    _, _, D = _D(5, 3, 9, 7)
    want = np.asarray(jax.vmap(lambda d: jsd._forward_scan(d, 0.1))(jnp.asarray(D.numpy())))
    np.testing.assert_allclose(tsd.wavefront(D, 0.1).numpy(), want, rtol=1e-5, atol=1e-5)
