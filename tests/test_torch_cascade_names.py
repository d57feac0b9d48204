"""The JAX package's small public names that the cascade slice ports,
each against the JAX package on the CPU: graph.bone_pairs, types.Clip,
the one-pair and batched soft-DTW divergence, assemble_clip_batch and
Pipeline.init_params."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import graph as jgraph
from golfaction_tpu import types as jtypes
from golfaction_tpu.pipeline import orchestrator as jorch
from golfaction_tpu.train import losses as jlosses
from golfaction_tpu_torch import graph as tgraph
from golfaction_tpu_torch import types as ttypes
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
from golfaction_tpu_torch.train import losses as tlosses
from tests.torch_cascade_tree import TINY, jax_params
from tests.torch_parity import port_config, to_numpy


def test_bone_pairs_are_the_jax_packages():
    got, want = tgraph.bone_pairs(), jgraph.bone_pairs()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_clip_has_the_jax_fields_and_num_frames():
    assert ([f.name for f in dataclasses.fields(ttypes.Clip)]
            == [f.name for f in dataclasses.fields(jtypes.Clip)])
    frames = np.zeros((7, 8, 12, 3), np.uint8)
    boxes = np.ones((7, 4), np.float32)
    valid = np.arange(7) < 5
    got = ttypes.Clip(torch.from_numpy(frames), torch.from_numpy(boxes), torch.from_numpy(valid))
    want = jtypes.Clip(jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(valid))
    assert got.num_frames == want.num_frames == 7 and got.fps == want.fps == 30.0


def _emb(rng, *shape):
    e = rng.normal(size=shape).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_softdtw_divergence_one_pair_and_batch_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _emb(rng, 11, 6), _emb(rng, 9, 6)
    got = tlosses.softdtw_divergence(torch.from_numpy(a), torch.from_numpy(b), 0.1)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(jlosses.softdtw_divergence(
        jnp.asarray(a), jnp.asarray(b), 0.1)), rtol=1e-5, atol=1e-6)
    A, B = _emb(rng, 3, 10, 6), _emb(rng, 3, 10, 6)
    ta = torch.from_numpy(A).requires_grad_()
    got = tlosses.softdtw_divergence_batch(ta, torch.from_numpy(B), 0.1)
    want = np.asarray(jlosses.softdtw_divergence_batch(jnp.asarray(A), jnp.asarray(B), 0.1))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    got.sum().backward()
    assert torch.isfinite(ta.grad).all()


@pytest.mark.parametrize("n_clips,n", [(1, 3), (3, 3), (2, 5)])
def test_assemble_clip_batch_matches_jax(n_clips, n):
    rng = np.random.default_rng(n)
    clips = [rng.integers(0, 255, (4, 6, 8, 3), dtype=np.uint8) for _ in range(n_clips)]
    got = torch_orch.assemble_clip_batch(clips, n)
    want = np.asarray(jorch.assemble_clip_batch(clips, n))
    assert got.dtype == want.dtype and got.shape == want.shape == (n, 4, 6, 8, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("refine", [False, True])
def test_init_params_has_the_jax_trees_and_is_what_the_pipeline_loads(refine):
    jc = dataclasses.replace(TINY, refine=dataclasses.replace(TINY.refine, enabled=refine))
    cfg = port_config(jc)
    pipe = torch_orch.Pipeline(cfg, device="cpu", seed=3)
    got = pipe.init_params(3)
    assert sorted(got) == sorted(["pose", "gcn", "align", "error"] + ["refine"] * refine)
    for name, sd in got.items():
        live = pipe.models[name].state_dict()
        assert all(torch.equal(sd[k], live[k]) for k in sd), name
    want = to_numpy(jax_params(jc, seed=3))
    got_trees = weights.to_flax(got)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(shapes(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {f"{prefix}{k}": tuple(np.shape(v))})
        return out

    for name in got:
        assert shapes(got_trees[name]) == shapes(want[name]), name
    other = pipe.init_params(4)
    assert not torch.equal(other["gcn"]["head1.weight"], got["gcn"]["head1.weight"])
    if refine:
        assert float(got["refine"]["head.weight"].abs().max()) == 0.0
