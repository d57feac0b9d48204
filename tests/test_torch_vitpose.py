"""The port's ViTPose backbone (models/vit.py, `PoseConfig(backbone="vit")`)
against the plain reference `benchmark/reference/vitpose.py` (the
benchmark's own, at its configured precision: `Numerics()`) at tiny widths
on the CPU, its shapes at the published widths, its attention route, its
spans, the normal path through `Pipeline`, and the ResNet-only paths that
refuse it.  CPU, a few seconds; the card's checks are in
`test_torch_vitpose_cuda.py`.

Tolerances.  float32: the port and the reference differ only in how the
same float32 sums are ordered (torch's fused LayerNorm and matmul kernels
against written-out means and products), a few float32 ulps a layer, so
1e-5 of the heatmaps' peak.  bfloat16: both round at the same places (the
attention's probabilities too, as the card's fused kernels round them), and
the CPU's products sum in the same order, so equal to the bit there; on
the card the cuDNN, cuBLAS and flash-attention sums take other orders, and
one flipped bfloat16 rounding moves an element by an ulp (2^-8 of it), so
the cuda file allows 4 ulps of the peak.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import types, weights
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import pose_quant, precision, vit
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline, init_params
from golfaction_tpu_torch.utils import profiling
from benchmark.reference import vitpose as vitpose_ref

TINY_VIT = dict(backbone="vit", input_hw=(64, 48), heatmap_hw=(16, 12), vit_width=64,
                vit_depth=2, vit_heads=4, vit_mlp_width=256, deconv_channels=(32, 32))
TINY_SET = ["pose.backbone=vit", "pose.input_hw=(64,48)", "pose.heatmap_hw=(16,12)",
            "pose.vit_width=64", "pose.vit_depth=2", "pose.vit_heads=4",
            "pose.vit_mlp_width=256", "pose.deconv_channels=(32,32)",
            "gcn.block_channels=(16,32)", "error.hidden_dim=32",
            "align.hidden_channels=(16,32)", "align.embed_dim=16", "frame_batch=8"]
VIT_SPANS = ["pose.vit.embed", "pose.vit.blocks", "pose.vit.head"]


def seeded_pair(dtype: str, seed: int = 0):
    """The port's tiny ViT and the reference with the same seeded weights;
    the norms' scales and biases and the linear biases drawn off their
    defaults so that each is used."""
    cfg = tcfg.PoseConfig(**TINY_VIT, dtype=dtype)
    net = tpose.pose_net(cfg).eval()
    gen = torch.Generator().manual_seed(seed)
    weights.init_random(net, gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
        net.pos_embed.normal_(0.0, 0.5, generator=gen)
    ref = vitpose_ref.PoseNet(dataclasses.asdict(cfg)).eval()
    ref.load_state_dict(net.state_dict())
    return net, ref


def _crops(n=3, seed=1):
    return torch.randn(n, 64, 48, 3, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_port_matches_the_reference(dtype, tol, seed):
    net, ref = seeded_pair(dtype, seed)
    x = _crops(seed=seed + 7)
    with torch.no_grad():
        got, want = net(x), ref(x)
    assert got.dtype == torch.float32 and got.shape == (3, 17, 16, 12)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * peak, dtype
    # The bfloat16 net differs from the float32 one: the rounding is real.
    if dtype == "bfloat16":
        f32, _ = seeded_pair("float32", seed)
        with torch.no_grad():
            assert float((f32(x) - got).abs().max()) > 1e-3 * peak


def test_published_widths_token_grid_heatmaps_and_parameters():
    cfg = tcfg.PoseConfig(backbone="vit", dtype="float32", deconv_channels=(256, 256))
    assert vit.token_grid(cfg) == (16, 12)
    with torch.device("meta"):
        net = tpose.pose_net(cfg)
        out = net(torch.empty(2, 256, 192, 3))
    assert out.shape == (2, 17, 64, 48)
    assert net.pos_embed.shape == (1, 193, 1024) and len(net.blocks) == 24
    assert net.blocks[0].attn.heads == 16 and net.blocks[0].mlp.fc1.out_features == 4096
    assert [d.weight.shape[:2] for d in net.deconvs] == [(1024, 256), (256, 256)]
    head = ("deconvs.", "dgns.", "final.")
    sd = net.state_dict()
    assert sum(v.numel() for k, v in sd.items() if not k.startswith(head)) == 303_296_512
    assert sum(v.numel() for v in sd.values()) == 308_544_785
    with torch.device("meta"):
        assert set(sd) == set(vitpose_ref.PoseNet(dataclasses.asdict(cfg)).state_dict())


def test_the_class_row_is_added_to_every_token():
    net, _ = seeded_pair("float32")
    x = _crops(2)
    seen = []
    net.blocks[0].register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        net(x)
        patches = net.patch_embed(x.permute(0, 3, 1, 2))
        want = patches + net.pos_embed[:, 1:] + net.pos_embed[:, :1]
        assert torch.equal(seen[0], want)
        assert float((seen[0] - patches - net.pos_embed[:, 1:]).std(dim=1).max()) < 1e-5


@pytest.mark.parametrize("device,dtype,grad,route", [
    ("cuda", torch.bfloat16, False, "fused"),
    ("cuda", torch.bfloat16, True, "plain"),
    ("cuda", torch.float32, False, "plain"),
    ("cpu", torch.bfloat16, False, "plain"),
    ("cpu", torch.float32, True, "plain"),
])
def test_the_attention_route(device, dtype, grad, route):
    assert precision.attn_route(device, dtype, grad) == route


def test_the_plain_attention_is_softmax_of_scaled_scores():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 12, 16, generator=g, dtype=torch.float64).float()
               for _ in range(3))
    want = torch.nn.functional.scaled_dot_product_attention(q.double(), k.double(), v.double())
    assert torch.allclose(precision.attention(q, k, v).double(), want, atol=1e-6)
    got = precision.attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert got.dtype == torch.bfloat16
    # The fused kernels' rule: exp(s - max) rounded to bfloat16 before its
    # float32-summed product with v, divided by the unrounded sum, the
    # output rounded once.
    qd, kd, vd = (t.bfloat16().double() for t in (q, k, v))
    s = qd @ kd.transpose(-2, -1) / 4.0
    p = torch.exp(s - s.amax(-1, keepdim=True))
    want = (p.float().bfloat16().double() @ vd) / p.sum(-1, keepdim=True)
    assert torch.equal(got, want.float().bfloat16())
    # The probabilities' rounding is real: without it some outputs differ.
    unrounded = torch.nn.functional.scaled_dot_product_attention(qd, kd, vd)
    assert not torch.equal(got, unrounded.float().bfloat16())


def test_layer_norm_and_gelu_round_once():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(4)).bfloat16() * 3
    ln = torch.nn.LayerNorm(256, eps=1e-6)
    with torch.no_grad():
        ln.weight.normal_()
        ln.bias.normal_()
        want = torch.nn.functional.layer_norm(x.float(), (256,), ln.weight, ln.bias, 1e-6)
        assert torch.equal(precision.layer_norm(x, ln), want.bfloat16())
    gelu = torch.nn.functional.gelu                        # the ViT's, in float32 rounded once
    assert torch.equal(gelu(x), gelu(x.float()).bfloat16())


def _tiny_pipeline() -> Pipeline:
    cfg = tcfg.apply_overrides(tcfg.get_config(), TINY_SET)
    return Pipeline(cfg, device="cpu", seed=0)


def test_the_vit_spans_are_recorded_inside_pose_net():
    pipe = _tiny_pipeline()
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (2, 8, 48, 64, 3), dtype=torch.uint8, generator=g)
    boxes = torch.tensor([32.0, 24.0, 40.0, 44.0]).expand(2, 8, 4).contiguous()
    profiling.reset()
    try:
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]):
            pipe._pose_fn(frames, boxes)
        spans = profiling.recorded().spans
    finally:
        profiling.reset()
    by_id = {s.id: s for s in spans}
    nets = [s for s in spans if s.name == "pose.net"]
    assert len(nets) == 2                                  # 16 frames in micro-batches of 8
    inner = sorted((s for s in spans if s.name.startswith("pose.vit.")), key=lambda s: s.start_ns)
    assert [s.name for s in inner] == VIT_SPANS * 2
    assert all(by_id[s.parent].name == "pose.net" for s in inner)
    # The CPU computes its attention in torch ops, uncounted off the card.
    assert not [c for c in profiling.recorded().counts if c.name.startswith("attn_")]


def test_the_pipeline_runs_the_vit_end_to_end():
    pipe = _tiny_pipeline()
    assert isinstance(pipe.pose_model, vit.ViTPose)
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 256, (T, 48, 64, 3), dtype=np.uint8) for T in (6, 9)]
    boxes = [np.tile(np.float32([32, 24, 40, 44]), (T, 1)) for T in (6, 9)]
    a = pipe.analyze(clips[0], boxes=boxes[0])
    ref = types.Skeleton(keypoints=torch.as_tensor(a.keypoints), valid=torch.as_tensor(a.valid))
    out = pipe.analyze_batch(clips, boxes=boxes, reference=ref)
    for r, T in zip(out, (6, 9)):
        assert not isinstance(r, Exception), r
        kp = np.asarray(r.keypoints)
        assert kp.shape[-2:] == (17, 3) and np.isfinite(kp).all()
        assert np.asarray(r.valid).sum() == T


def _vit_state() -> dict:
    return tpose.pose_net(tcfg.PoseConfig(**TINY_VIT)).state_dict()


def _refusals():
    vit_cfg = tcfg.PoseConfig(**TINY_VIT)

    def int8():
        pose_quant.prepare_int8(tpose.pose_net(vit_cfg), torch.zeros(1, 64, 48, 3))

    def import_pose(tmp):
        from golfaction_tpu_torch import import_pose as ip
        pth = tmp / "w.pth"
        torch.save({}, pth)
        ip.main([str(pth), "--out", str(tmp / "out"), "--set", "pose.backbone=vit"])

    def quantize_eval(tmp):
        from golfaction_tpu_torch import quantize_eval as qe
        qe.load_pose_model("none", overrides=["backbone=vit"], device="cpu")

    def from_artifacts(tmp):
        Pipeline.from_artifacts("artifacts", overrides=["pose.backbone=vit"], device="cpu")

    return {
        "pose_tree": lambda tmp: weights.to_flax({"pose": _vit_state()}),
        "pose_state_dict": lambda tmp: weights.pose_state_dict(
            {"params": {"patch_embed": {"proj": {}}}}),
        "resnet_posenet": lambda tmp: tpose.PoseNet(vit_cfg),
        "pose_quant": lambda tmp: int8(),
        "import_pose": import_pose,
        "quantize_eval": quantize_eval,
        "from_artifacts": from_artifacts,
    }


@pytest.mark.parametrize("path", list(_refusals()))
def test_each_resnet_only_path_refuses_the_vit(path, tmp_path):
    with pytest.raises(ValueError, match=r"backbone"):
        _refusals()[path](tmp_path)


def test_the_defaults_build_the_resnet_as_before():
    cfg = tcfg.PoseConfig()
    assert cfg.backbone == "resnet"
    net = tpose.pose_net(cfg)
    assert type(net) is tpose.PoseNet
    keys = list(net.state_dict())
    assert keys[:2] == ["stem.weight", "gn0.weight"] and keys[-2:] == ["final.weight",
                                                                        "final.bias"]
    assert len(keys) == 71 and not any(k.startswith(("patch_embed", "pos_embed")) for k in keys)
    assert keys == list(init_params(tcfg.get_config(), 0)["pose"])
    # The flax converter's names and shapes, both ways.
    back = weights.pose_state_dict(weights.pose_tree(net.state_dict()))
    assert sorted(back) == sorted(keys)


def test_a_head_that_overshoots_the_heatmaps_is_refused():
    with pytest.raises(ValueError, match="3 deconvolutions from stride 16 overshoot"):
        tpose.pose_net(tcfg.PoseConfig(backbone="vit", vit_width=64, vit_depth=1, vit_heads=4))


@pytest.mark.parametrize("kw,match", [({"backbone": "swin"}, "pose.backbone='swin'"),
                                      ({"backbone": "vit", "vit_heads": 5}, "vit_heads=5")])
def test_a_bad_backbone_config_is_refused(kw, match):
    with pytest.raises(ValueError, match=match):
        tcfg.PoseConfig(**kw)
