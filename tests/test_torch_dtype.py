"""The models at their configured dtype: each port module with
dtype="bfloat16" against the flax module at bfloat16 (run op by op) on the
same seeded inputs and exported weights, narrow widths, on the CPU.

Limits (measured gaps in brackets, this file's inputs):
  * PoseNet heatmaps: max gap <= 3e-2 and mean gap <= 3e-3 of the largest
    heatmap value [1.2e-2, 6.6e-4]; layer by layer, each port layer given
    the flax layer's input differs from its output on at most 1% of the
    elements, by at most 1e-2 of the layer's largest value (one-ulp flips
    where the two sum in another order), while the float32 control differs
    on more than half of them;
  * GCN phase logits (the plain chain, which training runs): <= 1e-3
    [6.0e-8: the gates' sigmoid is JAX's, each step rounded]; the fused
    path at a bfloat16 config computes in float32 and equals
    gcn_forward_pallas (interpret mode) within the float32 limit 1e-3 of
    tests/test_torch_gcn.py;
  * error logits: <= 2e-2 [5.0e-3 without a reference, 2.3e-3 with: one
    one-ulp flip in a hidden product, carried through a 32-wide
    LayerNorm];
  * align embeddings: relative (Frobenius) gap <= 1e-2 [1.1e-7];
  * refiner keypoints: <= 2% of the largest correction [3.1e-5 px].
Each bfloat16 output differs from the float32 one of the same weights and
lies nearer flax's bfloat16 output than that float32 control does: its mean
gap at most 0.5 (pose [0.23]), 0.8 (error head [0.69, 0.20]) or 1e-3
(GCN, align, refiner [<= 2.7e-5]) times the control's.  A float32 config
computes exactly what the modules compute with the precision helpers
bypassed (unchanged to the bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golfaction_tpu import config as jcfg
from golfaction_tpu.models import align as jalign
from golfaction_tpu.models import error as jerror
from golfaction_tpu.models import gcn as jgcn
from golfaction_tpu.models import pose as jpose
from golfaction_tpu.models import refine as jrefine
from golfaction_tpu.ops.pallas import gcn_kernel
from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import align as talign
from golfaction_tpu_torch.models import error as terror
from golfaction_tpu_torch.models import gcn as tgcn
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import precision
from golfaction_tpu_torch.models import refine as trefine
from tests.torch_parity import flax_pose_layers, pose_layer_gaps, sub_config, to_numpy

B, T, V = 2, 16, 17
POSE = dict(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(1, 1, 1),
            stage_channels=(8, 16, 32), deconv_channels=(16, 16))
GCN = dict(block_channels=(8, 16), temporal_branches=((3, 1), (3, 2)), dropout=0.0)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    k = np.concatenate([rng.uniform(50, 400, (B, T, V, 2)), rng.uniform(0, 1, (B, T, V, 1))],
                       -1).astype(np.float32)
    valid = np.arange(T)[None] < np.array([[T], [11]])
    sk = np.asarray(jgcn.normalize_skeleton(jnp.asarray(k), jnp.asarray(valid)))
    return rng, k, valid, sk


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


def _pair(name, jmod, jsub, port_cls, tsub, args, seed, dtype, edit=None):
    """(flax output, port output at `dtype`, port output at float32) of one
    module with the same flax-initialized weights."""
    jc = jsub(dtype=dtype)
    model = jmod(jc)
    params = model.init(jax.random.key(seed), *[None if a is None else jnp.asarray(a)
                                                 for a in args])
    if edit is not None:
        params = edit(params)
    want = np.asarray(model.apply(params, *[None if a is None else jnp.asarray(a)
                                            for a in args]))
    sd = weights.from_flax({name: to_numpy(params)})[name]
    outs = []
    for dt in (dtype, "float32"):
        port = port_cls(sub_config(tsub, jsub(dtype=dt)))
        port.load_state_dict(sd)
        with torch.no_grad():
            outs.append(port(*_t(*args)).numpy())
    return want, outs[0], outs[1]


def _honoured(got16, got32, want, nearer):
    """The dtype is honoured: the bfloat16 output differs from the float32
    one and lies nearer flax's bfloat16, its mean gap at most `nearer`
    times the float32 control's."""
    assert np.abs(got16 - got32).max() > 1e-4 * max(np.abs(got32).max(), 1.0)
    gap16, gap32 = np.abs(got16 - want).mean(), np.abs(got32 - want).mean()
    assert gap16 <= nearer * gap32, (gap16, gap32)


def test_pose_bfloat16_matches_flax():
    x = np.random.default_rng(1).normal(size=(4, 64, 48, 3)).astype(np.float32)
    want, got, got32 = _pair("pose", jpose.create_pose_model,
                             lambda dtype: jcfg.PoseConfig(**POSE, dtype=dtype),
                             tpose.PoseNet, tcfg.PoseConfig, (x,), 0, "bfloat16")
    assert got.dtype == np.float32 and got.shape == (4, 17, 16, 12)
    peak = np.abs(want).max()
    gap = np.abs(got - want)
    assert gap.max() <= 3e-2 * peak and gap.mean() <= 3e-3 * peak, (gap.max(), gap.mean(), peak)
    _honoured(got, got32, want, nearer=0.5)


def test_pose_layers_round_as_flax():
    """Each port layer given the flax layer's input (flax op by op) equals
    its output but for one-ulp flips of another order of summation: at most
    1% of the elements, by at most 1e-2 of the layer's largest value; the
    float32 control differs on most of them."""
    x = np.random.default_rng(1).normal(size=(2, 64, 48, 3)).astype(np.float32)
    jc = jcfg.PoseConfig(**POSE, dtype="bfloat16")
    model = jpose.create_pose_model(jc)
    params = model.init(jax.random.key(0), jnp.asarray(x))
    port = tpose.PoseNet(sub_config(tcfg.PoseConfig, jc))
    port.load_state_dict(weights.from_flax({"pose": to_numpy(params)})["pose"])
    layers = flax_pose_layers(model, params, x)
    assert len(layers) == 2 + 3 * 6 + 2 * 2 + 1    # stem, blocks (projected), deconvs, final
    for path, differ, gap in pose_layer_gaps(port, layers, torch.bfloat16):
        assert differ <= 1e-2 and gap <= 1e-2, (path, differ, gap)
    for path, differ, _ in pose_layer_gaps(port, layers, torch.float32):
        assert differ > 0.5, (path, differ)


class _TrainingGCN(tgcn.ActionSegmentationGCN):
    """The GCN's plain chain at cfg.dtype: training mode, dropout 0."""

    def forward(self, x, valid):
        self.train()
        return super().forward(x, valid)


def test_gcn_chain_bfloat16_matches_flax():
    _, _, valid, sk = _inputs(2)
    want, got, got32 = _pair("gcn", jgcn.create_gcn_model,
                             lambda dtype: jcfg.GCNConfig(**GCN, dtype=dtype),
                             _TrainingGCN, tcfg.GCNConfig, (sk, valid), 1, "bfloat16")
    m = valid[..., None]
    np.testing.assert_allclose(got * m, want * m, atol=1e-3)
    _honoured(got * m, got32 * m, want * m, nearer=1e-3)


def test_gcn_inference_is_float32_at_a_bfloat16_config():
    """Reference behaviour (vii): the fused path and its plain reference
    compute in float32 whatever GCNConfig.dtype says, as gcn_forward_pallas
    does on the TPU."""
    _, _, valid, sk = _inputs(3)
    jc = jcfg.GCNConfig(**GCN, dtype="bfloat16")
    params = jgcn.create_gcn_model(jc).init(jax.random.key(2), jnp.asarray(sk),
                                            jnp.asarray(valid))
    want = np.asarray(gcn_kernel.gcn_forward_pallas(params, jc, jnp.asarray(sk),
                                                    jnp.asarray(valid), interpret=True))
    port = tgcn.ActionSegmentationGCN(sub_config(tcfg.GCNConfig, jc))
    port.load_state_dict(weights.gcn_state_dict(to_numpy(params)))
    port.prepare()
    m = valid[..., None]
    with torch.no_grad():
        for fused in (True, False):
            got = port(*_t(sk, valid), fused=fused).numpy()
            assert got.dtype == np.float32
            np.testing.assert_allclose(got * m, want * m, atol=1e-3)


@pytest.mark.parametrize("with_ref", [False, True])
def test_error_head_bfloat16_matches_flax(with_ref):
    rng, k, valid, _ = _inputs(4)
    logits = rng.normal(size=(B, T, 9)).astype(np.float32)
    ref = (k + rng.normal(0, 5, k.shape)).astype(np.float32) if with_ref else None
    aux = np.concatenate([rng.normal(0, 4, (B, T, V, 2)), rng.uniform(0, 3, (B, T, V, 1)),
                          rng.uniform(0, 6, (B, T, V, 1))], -1).astype(np.float32)
    want, got, got32 = _pair(
        "error", jerror.create_error_model,
        lambda dtype: jcfg.ErrorConfig(hidden_dim=32, mode_features=True, dtype=dtype),
        terror.ErrorClassifier, tcfg.ErrorConfig, (k, logits, valid, ref, aux), 2,
        "bfloat16")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-2)
    _honoured(got, got32, want, nearer=0.8)


def test_align_encoder_bfloat16_matches_flax():
    _, _, valid, sk = _inputs(5)
    want, got, got32 = _pair(
        "align", jalign.create_align_model,
        lambda dtype: jcfg.AlignConfig(embed_dim=16, hidden_channels=(8, 16), dtype=dtype),
        talign.AlignEncoder, tcfg.AlignConfig, (sk, valid), 3, "bfloat16")
    assert got.dtype == np.float32
    assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)
    _honoured(got, got32, want, nearer=1e-3)


def test_refiner_bfloat16_matches_flax():
    rng, k, valid, _ = _inputs(6)

    def head(params):      # a trained-looking head in place of the zero one
        p = to_numpy(params)
        p["params"]["Dense_0"]["kernel"] = rng.normal(0, 0.3, (8, 2)).astype(np.float32)
        return jax.tree.map(jnp.asarray, p)

    want, got, got32 = _pair(
        "refine", jrefine.create_refine_model,
        lambda dtype: jcfg.RefineConfig(enabled=True, block_channels=(8, 8), dtype=dtype),
        trefine.KeypointRefiner, tcfg.RefineConfig, (k, valid), 4, "bfloat16", edit=head)
    moved = np.abs(want - k).max()
    assert moved > 1.0
    np.testing.assert_allclose(got, want, atol=2e-2 * moved)
    _honoured(got, got32, want, nearer=1e-3)


def _plain(monkeypatch):
    """Bypass the precision helpers: every layer called as a float module."""
    for mod in (tgcn, terror, talign):
        monkeypatch.setattr(mod, "linear", lambda lin, x: lin(x))
    monkeypatch.setattr(precision.GroupNorm, "forward", torch.nn.GroupNorm.forward)

    def group_norm_act(x, gn, residual=None, residual_gn=None, residual_x=None):
        y = torch.nn.GroupNorm.forward(gn, x)
        if residual_x is not None:
            residual = torch.nn.GroupNorm.forward(residual_gn, residual_x)
        return torch.relu(y if residual is None else y + residual)

    monkeypatch.setattr(tpose, "group_norm_act", group_norm_act)


def _float32_outputs(seed):
    _, k, valid, sk = _inputs(seed)
    gen = torch.Generator().manual_seed(seed)
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(2, 64, 48, 3))
                         .astype(np.float32))
    kt, vt, st = _t(k, valid, sk)
    models = {
        "pose": tpose.PoseNet(tcfg.PoseConfig(**POSE, dtype="float32")),
        "gcn": tgcn.ActionSegmentationGCN(tcfg.GCNConfig(**GCN, dtype="float32")),
        "error": terror.ErrorClassifier(tcfg.ErrorConfig(hidden_dim=32, dtype="float32")),
        "align": talign.AlignEncoder(tcfg.AlignConfig(embed_dim=16, hidden_channels=(8, 16),
                                                      dtype="float32")),
        "refine": trefine.KeypointRefiner(tcfg.RefineConfig(enabled=True, dtype="float32")),
    }
    for m in models.values():
        weights.init_random(m, gen)
    torch.nn.init.normal_(models["refine"].head.weight, std=0.3, generator=gen)
    logits = torch.randn(B, T, 9, generator=gen)
    with torch.no_grad():
        gcn = models["gcn"]
        gcn.train()
        out = {"gcn_train": gcn(st, vt)}
        gcn.eval()
        gcn.prepare()
        out.update(pose=models["pose"](x), gcn_fused=gcn(st, vt),
                   gcn_plain=gcn(st, vt, fused=False),
                   error=models["error"](kt, logits, vt, kt + 1.0),
                   align=models["align"](st, vt), refine=models["refine"](kt, vt))
    return {name: v.numpy() for name, v in out.items()}


def test_float32_is_unchanged_to_the_bit(monkeypatch):
    got = _float32_outputs(7)
    _plain(monkeypatch)
    want = _float32_outputs(7)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_an_unknown_dtype_is_refused():
    with pytest.raises(ValueError, match="float16"):
        precision.compute_dtype("float16")
    with pytest.raises(ValueError):
        tpose.PoseNet(tcfg.PoseConfig(**POSE, dtype="float16"))
