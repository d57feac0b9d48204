"""Kernel G's plain version, routing and launch geometry, on the CPU.

`ops/group_norm.py`'s plain version is the op sequence the pose net ran
before G: `precision.group_norm` (flax's statistics in float32, rounded to
bfloat16), then `+ residual` and `F.relu` as separate torch ops.  It is
held to that sequence to the bit at every site of the shipped net, and the
net's CPU output with it.  The routing rule (G for bfloat16 on the card
with no gradient to record, the plain version under autograd) is tested as
a decision, which needs no card; the kernel itself is held to the plain
version on the card (tests/test_torch_group_norm_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import precision
from golfaction_tpu_torch.ops import group_norm as kernel_g
from golfaction_tpu_torch.ops import requant

# The 20 launches of one shipped pose-net call (23 GroupNorms: the three
# projection blocks' gn2 and gn3 share one launch): (site, H, W, C, epilogue),
# epilogue 0 relu, 1 identity residual then relu, 2 projection's GroupNorm
# then relu, at input 256 x 192.
SITES = ([("gn0", 128, 96, 64, 0)]
         + [(f"blocks.{b}.gn{g}", 64, 48, 64, m) for b in (0, 1) for g, m in ((1, 0), (2, 1))]
         + [(f"blocks.{2 * s + b}.gn{g}", 64 >> s, 48 >> s, 64 << s, m if b else 2 * (m > 0))
            for s in (1, 2, 3) for b in (0, 1) for g, m in ((1, 0), (2, 1))]
         + [("dgns.0", 16, 12, 256, 0), ("dgns.1", 32, 24, 128, 0), ("dgns.2", 64, 48, 128, 0)])
GROUP_NORMS = len(SITES) + sum(m == 2 for *_, m in SITES)


def _gn(C, gen):
    gn = precision.GroupNorm(min(32, C), C, eps=1e-6)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.3 * torch.randn(C, generator=gen))
        gn.bias.copy_(0.2 * torch.randn(C, generator=gen))
    return gn


def _act(N, H, W, C, gen, dtype=torch.bfloat16):
    """Conv-output-like activations: per-channel offsets and scales, NCHW
    with channels-last strides as the card's convolutions leave them."""
    x = torch.randn(N, H, W, C, generator=gen) * (0.5 + torch.rand(C, generator=gen)) \
        + 0.5 * torch.randn(C, generator=gen)
    return x.to(dtype).permute(0, 3, 1, 2)


def _old_group_norm(x, gn):
    """precision.group_norm's bfloat16 body before kernel G, as it was."""
    xl = x.movedim(1, -1)
    xg, mu, rstd = requant.group_stats(xl.float(), gn.num_groups)
    shape = (1, 1, gn.num_groups, -1)
    out = (xg - mu) * (rstd * gn.weight.reshape(shape)) + gn.bias.reshape(shape)
    return out.reshape(xl.shape).to(x.dtype).movedim(-1, 1)


def _old_site(x, gn, mode, r=None, gn3=None, x3=None):
    y = _old_group_norm(x, gn)
    if mode == 1:
        y = y + r
    elif mode == 2:
        y = y + _old_group_norm(x3, gn3)
    return F.relu(y)


def test_the_sites_are_the_shipped_nets():
    assert len(SITES) == 20 and GROUP_NORMS == 23
    assert sorted({m for *_, m in SITES}) == [0, 1, 2]


@pytest.mark.parametrize("site,H,W,C,mode", SITES, ids=[s[0] for s in SITES])
def test_plain_version_is_the_old_op_sequence(site, H, W, C, mode):
    gen = torch.Generator().manual_seed(H * C + mode)
    gn, gn3 = _gn(C, gen), _gn(C, gen)
    x, r = _act(2, H, W, C, gen), _act(2, H, W, C, gen)
    want = _old_site(x, gn, mode, r, gn3, r)
    kw = {1: {"residual": r}, 2: {"residual_gn": gn3, "residual_x": r}}.get(mode, {})
    with torch.inference_mode():
        got = precision.group_norm_act(x, gn, **kw)
        plain = kernel_g.group_norm_act(
            x.movedim(1, -1), gn.num_groups, gn.weight, gn.bias,
            residual=r.movedim(1, -1) if mode == 1 else None,
            x2=r.movedim(1, -1) if mode == 2 else None, weight2=gn3.weight, bias2=gn3.bias)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, want)
    assert torch.equal(plain, want.movedim(1, -1))
    # group_norm alone (no relu) is the old body too.
    with torch.inference_mode():
        assert torch.equal(precision.group_norm(x, gn), _old_group_norm(x, gn))
        assert torch.equal(precision.group_norm(x.movedim(1, -1), gn, channels_last=True),
                           _old_group_norm(x, gn).movedim(1, -1))


def _old_pose_forward(net, x):
    """PoseNet.forward as it was before kernel G: GroupNorm modules, then
    separate residual adds and ReLUs."""
    def gn(mod, t):
        if t.dtype == torch.float32:
            return F.group_norm(t, mod.num_groups, mod.weight, mod.bias, mod.eps)
        return _old_group_norm(t, mod)

    x = x.to(net.dt).permute(0, 3, 1, 2)
    x = F.relu(gn(net.gn0, net.stem(x)))
    x = F.max_pool2d(tpose._pad_same(x, 3, 2, float("-inf")), 3, 2)
    for blk in net.blocks:
        y = F.relu(gn(blk.gn1, blk.conv1(x)))
        y = gn(blk.gn2, blk.conv2(y))
        r = x if blk.proj is None else gn(blk.gn3, blk.proj(x))
        x = F.relu(y + r)
    for d, g in zip(net.deconvs, net.dgns):
        x = F.relu(gn(g, d(x)))
    return net.final(x).float()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_pose_net_cpu_output_is_unchanged(dtype):
    cfg = tcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(2, 2, 2),
                          stage_channels=(16, 32, 64), deconv_channels=(32, 32), dtype=dtype)
    net = tpose.PoseNet(cfg).eval()
    weights.init_random(net, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 64, 48, 3)).astype(np.float32))
    with torch.inference_mode():
        got, want = net(x), _old_pose_forward(net, x)
    assert got.shape == (2, 17, 16, 12)
    assert torch.equal(got, want)


def test_routing_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    assert precision.gn_route("cuda", bf16, False, False) == "kernel"
    assert precision.gn_route("cuda", bf16, False, True) == "kernel"
    assert precision.gn_route("cuda", bf16, True, False) == "plain"      # autograd records
    assert precision.gn_route("cpu", bf16, False, False) == "plain"
    assert precision.gn_route("cuda", f32, False, False) == "torch"
    assert precision.gn_route("cuda", f32, True, False) == "torch"
    assert precision.gn_route("cuda", f32, False, True) == "plain"


def test_a_training_forward_is_routed_to_the_plain_path(monkeypatch):
    """Every GroupNorm of a bfloat16 PoseNet forward records whether autograd
    is recording through it: with the parameters' gradients on (train_pose's
    forward) each one is, so a card tensor there takes the plain path; under
    inference_mode none is, so a card tensor there takes G."""
    seen = []
    real = precision.gn_route

    def spy(device_type, dtype, grad, channels_last):
        seen.append((dtype, grad))
        return real(device_type, dtype, grad, channels_last)

    monkeypatch.setattr(precision, "gn_route", spy)
    cfg = tcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(2, 2),
                          stage_channels=(16, 32), deconv_channels=(32,), dtype="bfloat16")
    net = tpose.PoseNet(cfg).train()
    x = torch.zeros(2, 64, 48, 3)
    net(x).square().mean().backward()
    sites = len(seen)
    assert sites == 1 + 4 + 4 + 1
    assert all(dt == torch.bfloat16 and grad for dt, grad in seen)
    assert all(real("cuda", dt, grad, False) == "plain" for dt, grad in seen)
    seen.clear()
    with torch.inference_mode():
        net.eval()(x)
    assert len(seen) == sites and not any(grad for _, grad in seen)
    assert all(real("cuda", dt, grad, False) == "kernel" for dt, grad in seen)


def test_cpu_tensors_count_nothing():
    from golfaction_tpu_torch.utils import profiling

    gen = torch.Generator().manual_seed(0)
    gn = _gn(16, gen)
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            precision.group_norm_act(_act(2, 4, 4, 16, gen), gn)
    assert not profiling.recorded().counts
    profiling.reset()


@pytest.mark.parametrize("N", [64, 40, 1])
@pytest.mark.parametrize("max_cluster", [16, 8])
def test_site_geometry(N, max_cluster):
    """Every row owned by one block, the block within the card's limits and
    its threads tiling whole rows; rows beyond L2 staged (read once), the
    others in one wave of blocks at batch 64."""
    for _, H, W, C, mode in SITES:
        R, sources = H * W, 2 if mode == 2 else 1
        g = kernel_g.launch_geometry(N, R, C, min(32, C), sources, max_cluster=max_cluster)
        owned = np.zeros(R, np.int64)
        for rank in range(g.cluster):
            r0 = min(R, rank * g.rpb)
            owned[r0:min(R, r0 + g.rpb)] += 1
        assert (owned == 1).all()
        assert 1 <= g.cluster <= max_cluster and g.cluster & (g.cluster - 1) == 0
        assert g.smem <= kernel_g.MAX_SMEM
        assert g.threads == (C // 8) * g.rpi <= 1024 and g.threads >= 256
        assert not g.staged or g.smem >= sources * g.rpb * C * 2
        if sources * N * R * C * 2 > kernel_g.REREAD_L2_SHARE * kernel_g.H100_L2_BYTES:
            assert g.staged, "rows beyond L2 are read once"
        elif N == 64:
            assert g.cluster == 2, "one wave: 128 blocks on 132 SMs"


def test_forced_and_unstaged_geometry():
    g = kernel_g.launch_geometry(64, 12288, 64, 32, 1, cluster=2)
    assert g.cluster == 2 and not g.staged and g.rpb == 6144
    big = kernel_g.launch_geometry(8, 384 * 288 // 4, 64, 32, 1, max_cluster=8)
    assert not big.staged and big.cluster == 8          # read twice where nothing stages


def test_mean_factor_is_torchs():
    """The factor torch's CUDA mean multiplies a sum by: float(outputs) /
    float(elements) in float32, which is not 1 / count once the element
    count passes 2**24."""
    assert kernel_g.mean_factor(2, 48, 512, 32) == float(np.float32(1 / (48 * 16)))
    f = kernel_g.mean_factor(64, 12288, 64, 32)
    assert f == float(np.float32(64 * 32) / np.float32(64 * 12288 * 64))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    gen = torch.Generator().manual_seed(0)
    gn = _gn(16, gen)
    x = _act(2, 4, 4, 16, gen).movedim(1, -1)
    with pytest.raises(ValueError, match="not both"):
        kernel_g.group_norm_act(x.to("meta"), 16, gn.weight, gn.bias, residual=x, x2=x)
    gn3 = precision.GroupNorm(8, 16)
    with pytest.raises(ValueError, match="groups"):
        precision.group_norm_act(x.movedim(-1, 1), gn, residual_gn=gn3,
                                 residual_x=x.movedim(-1, 1))
