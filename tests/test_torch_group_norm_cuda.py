"""Kernel G (csrc/group_norm.cu) on the card: against its plain version at
every site of the shipped pose net, through the net, its counter, and the
training forward that must not reach it.

Every test needs a CUDA device and skips without one; on a machine with the
card (the conftest imports JAX, which that machine lacks):

    python -m pytest tests/test_torch_group_norm_cuda.py -q --noconftest

Limits: G sums the statistics in another order than torch's reductions, so
a group's mean or rstd may differ in its last float32 bit, and the rounded
GroupNorm then differs by one bfloat16 ulp where that bit tips a rounding:
one ulp at the largest term of the GroupNorm's sum (where (x - mean) *
rstd * gamma and beta cancel, the result is small and that ulp is the
terms', not the result's), and after a residual add one more ulp of the
output, for the add's own rounding (`term_ulp`); bit-equal on at least
99.9% of the elements at every site."""

import copy
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import precision
from golfaction_tpu_torch.ops import _kernels, requant
from golfaction_tpu_torch.ops import group_norm as kernel_g
from golfaction_tpu_torch.utils import profiling
from tests.test_torch_group_norm import SITES   # the shipped net's 20 launch sites

pytestmark = pytest.mark.cuda

BIT_EQUAL = 0.999


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel G has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _site_inputs(N, H, W, C, seed, dev):
    """Conv-output-like bfloat16 activations [N, H, W, C] (per-channel
    offsets and scales) for x, the residual and the shortcut, and the
    GroupNorms' float32 weights and biases."""
    gen = torch.Generator().manual_seed(seed)

    def act():
        x = torch.randn(N, H, W, C, generator=gen) * (0.5 + torch.rand(C, generator=gen)) \
            + 0.5 * torch.randn(C, generator=gen)
        return x.to(dev, torch.bfloat16)

    def vec(scale, shift):
        return (shift + scale * torch.randn(C, generator=gen)).to(dev)

    return act(), act(), act(), vec(0.3, 1.0), vec(0.2, 0.0), vec(0.3, 1.0), vec(0.2, 0.0)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |v| (float32 values)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp(min=2.0 ** -126))) - 7)


def term_ulp(x, groups, weight, bias, residual=None, x2=None, weight2=None, bias2=None,
             relu=True) -> torch.Tensor:
    """The gap a last-bit change of a group's mean or rstd may leave: one
    bfloat16 ulp at the largest term of each GroupNorm's sum ((x - mean) *
    rstd * gamma, beta, the rounded result), and after a residual add one
    more at the output, for the add's own rounding: a one-ulp flip of the
    GroupNorm lands a sum of two bfloat16 values on the other side of a tie
    of that rounding, two ulps of the output from the plain version's."""
    def gn_ulp(t, w, b):
        xg, mu, rstd = requant.group_stats(t.float(), groups)
        shape = (1, 1, groups, -1)
        prod = ((xg - mu) * (rstd * w.reshape(shape))).abs()
        scale = torch.maximum(prod, b.reshape(shape).abs()).reshape(t.shape)
        return _ulp(scale.maximum(kernel_g.group_norm_plain(t, groups, w, b).float().abs()))

    allowed = gn_ulp(x, weight, bias)
    if x2 is not None:
        allowed = allowed + gn_ulp(x2, weight2, bias2)
    if residual is not None or x2 is not None:
        want = kernel_g.group_norm_act_plain(x, groups, weight, bias, residual, x2, weight2,
                                             bias2, relu)
        allowed = allowed + _ulp(want.float())
    return allowed


def site_gap(got, args) -> dict:
    """Kernel G's output `got` against the plain version on `args` (the
    wrapper's positional arguments): the share bit-equal, the largest gap
    over what `term_ulp` allows (at most 1), and the largest absolute gap."""
    want = kernel_g.group_norm_act_plain(*args)
    gap = (got.float() - want.float()).abs()
    return {"bit_equal": float((got == want).float().mean()),
            "gap_over_allowed": float((gap / term_ulp(*args)).max()),
            "max_abs_err": float(gap.max())}


def _site_gap(N, H, W, C, mode, seed, dev):
    x, r, x2, w, b, w2, b2 = _site_inputs(N, H, W, C, seed, dev)
    args = (x, min(32, C), w, b, r if mode == 1 else None, x2 if mode == 2 else None, w2, b2)
    n0 = kernel_g.group_norm_act.launches
    got = kernel_g.group_norm_act(*args)
    torch.cuda.synchronize()
    assert kernel_g.group_norm_act.launches == n0 + 1
    return got, site_gap(got, args)


@pytest.mark.parametrize("N", [64, 40, 1])
@pytest.mark.parametrize("site,H,W,C,mode", SITES, ids=[s[0] for s in SITES])
def test_kernel_matches_plain_at_every_site(dev, N, site, H, W, C, mode):
    got, gap = _site_gap(N, H, W, C, mode, H * C + N + mode, dev)
    assert got.shape == (N, H, W, C) and got.dtype == torch.bfloat16 and got.is_contiguous()
    print(f"{site} N={N}: {gap}")
    assert gap["gap_over_allowed"] <= 1.0, "more than one bfloat16 ulp a rounding off"
    assert gap["bit_equal"] >= BIT_EQUAL


def test_two_runs_give_the_same_bits(dev):
    x, r, x2, w, b, w2, b2 = _site_inputs(64, 128, 96, 64, 5, dev)
    a = kernel_g.group_norm_act(x, 32, w, b)
    c = kernel_g.group_norm_act(x, 32, w, b)
    assert torch.equal(a, c)


def test_kernel_geometry_agrees_with_python(dev):
    layout = _kernels.bind("group_norm", "group_norm_layout", "iiiiip")
    buf = (ctypes.c_int * 3)()
    max_cluster, sms, l2 = kernel_g.card_limits(dev)
    props = torch.cuda.get_device_properties(dev)
    assert max_cluster in (8, 16) and (sms, l2) == (props.multi_processor_count,
                                                    props.L2_cache_size)
    for N in (64, 40, 1):
        for _, H, W, C, mode in SITES:
            for mc in (max_cluster, 8):
                g = kernel_g.launch_geometry(N, H * W, C, min(32, C), 2 if mode == 2 else 1,
                                             mc, sms, l2)
                assert layout(C, min(32, C), mode, g.rpb, int(g.staged),
                              ctypes.cast(buf, ctypes.c_void_p)) == 0
                assert (buf[0], buf[1], buf[2]) == (g.threads, g.rpi, g.smem)


def test_a_forced_unstaged_layout_matches_plain(dev):
    """The re-read path (a run too large to stage) at the stem's shape."""
    x, _, _, w, b, _, _ = _site_inputs(8, 128, 96, 64, 9, dev)
    geo = kernel_g.launch_geometry(8, 128 * 96, 64, 32, 1, cluster=2)
    assert not geo.staged
    out = torch.empty_like(x)
    kernel_g.launch(out, geo, x, 32, w, b)
    torch.cuda.synchronize()
    gap = site_gap(out, (x, 32, w, b))
    assert gap["gap_over_allowed"] <= 1.0 and gap["bit_equal"] >= BIT_EQUAL


def test_layouts_the_kernel_does_not_take_raise(dev):
    gn = precision.GroupNorm(32, 64).to(dev)
    x = torch.randn(2, 64, 8, 8, device=dev).to(torch.bfloat16)      # contiguous NCHW
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            precision.group_norm_act(x, gn)
        with pytest.raises(ValueError, match="multiple of 8"):
            kernel_g.group_norm_act(torch.zeros(2, 4, 4, 12, device=dev, dtype=torch.bfloat16),
                                    4, gn.weight[:12], gn.bias[:12])


def _shipped_net(dev, seed=0):
    net = tpose.PoseNet(tcfg.PoseConfig(dtype="bfloat16")).eval()
    weights.init_random(net, torch.Generator().manual_seed(seed))
    return net.to(dev)


def _crops(n, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, 256, 192, 3)).astype(np.float32)).to(dev)


def test_shipped_net_counts_23_group_norms_a_call(dev):
    net, crops = _shipped_net(dev), _crops(64, 1, dev)
    profiling.reset()
    n0 = kernel_g.group_norm_act.launches
    with torch.inference_mode():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            net(crops)
            torch.cuda.synchronize()
    counts = {}
    for c in profiling.recorded().counts:
        counts[c.name] = counts.get(c.name, 0) + c.n
    profiling.reset()
    assert kernel_g.group_norm_act.launches == n0 + 20
    assert counts == {"gn_kernel": 23}


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_shipped_net_heatmaps_through_kernel_match_plain(dev, monkeypatch, seed):
    """The shipped net's heatmaps with G at every site against the same net
    with the plain version at every site.  A one-ulp flip at a site moves
    the next convolution's sums, so the two differ by bfloat16 noise, held
    to the noise the port already carries in bfloat16: the same net's plain
    version on the CPU against the card's (other convolution algorithms,
    other orders of every sum)."""
    net, crops = _shipped_net(dev, seed), _crops(8, seed, dev)
    with torch.inference_mode():
        got = net(crops)
        with monkeypatch.context() as m:
            m.setattr(kernel_g, "group_norm_act", kernel_g.group_norm_act_plain)
            want = net(crops)
        cpu = copy.deepcopy(net).cpu()(crops.cpu())
    got, want = got.cpu(), want.cpu()
    peak = float(want.abs().max())

    def gaps(a, b):
        d = (a - b).abs()
        return float(d.max()) / peak, float(d.mean()) / peak

    (gap, mean_gap), (noise, mean_noise) = gaps(got, want), gaps(cpu, want)
    print(f"shipped net heatmaps, seed {seed}: G vs plain max {gap:.3e}, mean {mean_gap:.3e} "
          f"of the peak; plain on the CPU vs on the card max {noise:.3e}, mean {mean_noise:.3e}")
    assert bool(torch.isfinite(got).all())
    assert mean_gap <= mean_noise


def test_training_forward_takes_the_plain_path_and_its_gradients(dev):
    """A train_pose forward (autograd recording) at bfloat16 launches no G,
    and its gradients are those of the op sequence written out."""
    cfg = tcfg.PoseConfig(input_hw=(64, 48), heatmap_hw=(16, 12), stage_blocks=(2, 2, 2),
                          stage_channels=(16, 32, 64), deconv_channels=(32, 32),
                          dtype="bfloat16")
    net = tpose.PoseNet(cfg).to(dev).train()
    weights.init_random(net, torch.Generator().manual_seed(4))
    x = _crops(8, 4, dev)[:, :64, :48].contiguous()

    def grads(forward):
        net.zero_grad()
        forward(x).square().mean().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()}

    n0 = kernel_g.group_norm_act.launches
    got = grads(net)
    assert kernel_g.group_norm_act.launches == n0

    def gn(mod, t):
        out = kernel_g.group_norm_plain(t.movedim(1, -1), mod.num_groups, mod.weight, mod.bias)
        return out.movedim(-1, 1)

    def written_out(inp):
        h = F.relu(gn(net.gn0, net.stem(inp.to(net.dt).permute(0, 3, 1, 2))))
        h = F.max_pool2d(tpose._pad_same(h, 3, 2, float("-inf")), 3, 2)
        for blk in net.blocks:
            y = gn(blk.gn2, blk.conv2(F.relu(gn(blk.gn1, blk.conv1(h)))))
            h = F.relu(y + (h if blk.proj is None else gn(blk.gn3, blk.proj(h))))
        for d, g in zip(net.deconvs, net.dgns):
            h = F.relu(gn(g, d(h)))
        return net.final(h).float()

    torch.backends.cudnn.deterministic, was = True, torch.backends.cudnn.deterministic
    try:
        got, want = grads(net), grads(written_out)
    finally:
        torch.backends.cudnn.deterministic = was
    for k in want:
        assert torch.equal(got[k], want[k]), k
