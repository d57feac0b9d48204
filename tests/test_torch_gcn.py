"""The skeleton GCN: the port's block tail (kernel B's plain version), its
module chain and the whole GCN against the JAX package's flax model and its
Pallas forward (interpret mode), float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu import graph as jgraph
from golfaction_tpu.models import gcn as jgcn
from golfaction_tpu.ops.pallas import gcn_kernel
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import graph as tgraph
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import gcn as tgcn
from golfaction_tpu_torch.ops import gcn_tail
from tests.torch_parity import sub_config, to_numpy

V = 17


def _inputs(seed, B, T, C, la):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, V, C)).astype(np.float32)
    valid = np.arange(T)[None, :] < np.asarray(la)[:, None]
    return x, valid


def test_adjacency_matches_jax():
    for strategy in ("spatial", "uniform"):
        np.testing.assert_array_equal(tgraph.build_adjacency(strategy),
                                      jgraph.build_adjacency(strategy))


# (C_in, C, T, la): T*V not a multiple of 8, clips shorter than T, a width
# change (projected residual), and dilations reaching past short clips.
BLOCKS = [(3, 16, 12, (12, 7)), (16, 32, 16, (16, 1)), (24, 24, 9, (5, 9)), (8, 64, 10, (10, 3))]


@pytest.mark.parametrize("cin,C,T,la", BLOCKS)
def test_block_tail_matches_flax_block(cin, C, T, la):
    jc = jcfg.GCNConfig(dropout=0.0, dtype="float32")
    A = jgraph.build_adjacency("spatial")
    block = jgcn.GCNBlock(C, jc, A, jnp.float32)
    x, valid = _inputs(C + T, len(la), T, cin, la)
    params = block.init(jax.random.key(C), jnp.asarray(x), jnp.asarray(valid))
    want = np.asarray(block.apply(params, jnp.asarray(x), jnp.asarray(valid)))

    port = tgcn.GCNBlock(cin, C, sub_config(tcfg.GCNConfig, jc), A)
    port.load_state_dict(weights.gcn_block_state_dict(to_numpy(params)["params"]))
    port.sgc._wbig = port.sgc.wbig()
    port.tail = port.pack()
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    la_t = vt.sum(1).to(torch.int32)
    with torch.no_grad():
        chain = port(xt, vt, fused=False).numpy()
        fused = port(xt, vt, la=la_t, fused=True).numpy()
    np.testing.assert_allclose(chain, want, atol=1e-4)
    np.testing.assert_allclose(fused, want, atol=1e-4)
    assert not fused[~valid].any()                         # padded frames stay zero


GCNS = [dict(block_channels=(8, 16), temporal_branches=((3, 1), (3, 2))),
        dict(block_channels=(16, 32))]


def _gcn_pair(kw, T, la, seed=0):
    jc = jcfg.GCNConfig(dropout=0.0, dtype="float32", **kw)
    model = jgcn.create_gcn_model(jc)
    x, valid = _inputs(seed, len(la), T, 3, la)
    params = model.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(valid))
    port = tgcn.ActionSegmentationGCN(sub_config(tcfg.GCNConfig, jc))
    port.load_state_dict(weights.gcn_state_dict(to_numpy(params)))
    port.prepare()
    return jc, model, params, port, x, valid


@pytest.mark.parametrize("kw", GCNS)
def test_gcn_logits_match_flax(kw):
    _, model, params, port, x, valid = _gcn_pair(kw, 14, (14, 9))
    want = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(valid)))
    xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
    with torch.no_grad():
        for fused in (False, True):
            got = port(xt, vt, fused=fused).numpy()
            np.testing.assert_allclose(got, want, atol=1e-3)


def test_pallas_forward_matches_port():
    jc, _, params, port, x, valid = _gcn_pair(GCNS[1], 12, (12, 8), seed=1)
    want = np.asarray(gcn_kernel.gcn_forward_pallas(params, jc, jnp.asarray(x),
                                                    jnp.asarray(valid), interpret=True))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(valid), fused=False).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_fused_forward_needs_prepare():
    port = tgcn.ActionSegmentationGCN(tcfg.GCNConfig(block_channels=(8,)))
    with pytest.raises(RuntimeError):
        port(torch.zeros(1, 4, V, 3), torch.ones(1, 4, dtype=torch.bool), fused=True)


def test_tail_on_cpu_launches_nothing():
    port = tgcn.ActionSegmentationGCN(tcfg.GCNConfig(block_channels=(8, 16)))
    port.prepare()
    n0 = gcn_tail.gcn_block_tail.launches
    with torch.no_grad():
        out = port(torch.ones(1, 8, V, 3), torch.ones(1, 8, dtype=torch.bool), fused=True)
    assert out.shape == (1, 8, 9)
    assert gcn_tail.gcn_block_tail.launches == n0


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_skeleton_matches_jax(masked):
    rng = np.random.default_rng(4)
    k = rng.uniform(0, 300, (2, 9, V, 3)).astype(np.float32)
    valid = np.arange(9)[None] < np.array([[9], [6]])
    jv = jnp.asarray(valid) if masked else None
    tv = torch.from_numpy(valid) if masked else None
    np.testing.assert_allclose(tgcn.normalize_skeleton(torch.from_numpy(k), tv).numpy(),
                               np.asarray(jgcn.normalize_skeleton(jnp.asarray(k), jv)),
                               rtol=1e-5, atol=1e-5)
    got, gs = tgcn.normalize_skeleton_clip(torch.from_numpy(k), tv, return_scale=True)
    want, ws = jgcn.normalize_skeleton_clip(jnp.asarray(k), jv, return_scale=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
