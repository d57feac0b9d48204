"""The ViT pose net on the card: its attention takes a fused kernel and is
counted, the fused attention agrees with the plain one, and the tiny net
agrees with the plain reference (`benchmark/reference/vitpose.py`).

Every test needs a CUDA device and skips without one; on a machine with the
card (the conftest imports JAX, which that machine lacks):

    python -m pytest tests/test_torch_vitpose_cuda.py -q --noconftest

Limits: the fused kernels (flash, cuDNN, memory-efficient) round the
probabilities to bfloat16 before their product with v, as the plain
attention does, but against a running max over blocks of keys and with
the sums in another order, so an output element may tip to the
neighbouring bfloat16 value: 2 ulps of the output's largest magnitude.  Through the tiny net the products' sums on the card take other
orders than the reference's too, and each flipped rounding carries on into
the sums after it: 4 ulps of the heatmaps' peak (an element's own ulp
means little there: a heatmap value is a sum of terms near the peak's
size).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch.models import pose as tpose
from golfaction_tpu_torch.models import precision
from golfaction_tpu_torch.utils import profiling
from tests.test_torch_vitpose import TINY_VIT, seeded_pair

pytestmark = pytest.mark.cuda

ULP = 2.0 ** -8                         # bfloat16's spacing relative to a value


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused attention runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_the_fused_route_is_taken_and_counted(dev):
    cfg = tcfg.PoseConfig(**dict(TINY_VIT, vit_depth=3))
    net = tpose.pose_net(cfg).to(dev).eval()
    x = torch.randn(4, 64, 48, 3, device=dev)
    profiling.reset()
    try:
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            net(x)
            torch.cuda.synchronize(dev)
        counts = profiling.recorded().counts
    finally:
        profiling.reset()
    assert sum(c.n for c in counts if c.name == "attn_fused") == 3
    assert not [c for c in counts if c.name == "attn_plain"]
    names = {e.name for e in prof.events() if e.device_type.name == "CUDA"}
    assert any(("flash" in n or "fmha" in n or "sdpa" in n or "attention" in n.lower())
               for n in names), sorted(names)


def test_training_keeps_the_plain_attention_and_counts_it(dev):
    q, k, v = (torch.randn(2, 4, 12, 16, device=dev, dtype=torch.bfloat16, requires_grad=True)
               for _ in range(3))
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            o = precision.attention(q, k, v)
        counts = profiling.recorded().counts
    finally:
        profiling.reset()
    o.float().sum().backward()
    assert q.grad is not None
    assert [(c.name, c.n) for c in counts] == [("attn_plain", 1)]


@pytest.mark.parametrize("shape", [(64, 16, 192, 64), (4, 4, 12, 16)])
def test_the_fused_attention_agrees_with_the_plain_one(dev, shape):
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16() for _ in range(3))
    with torch.inference_mode():
        fused = precision.attention(q, k, v)
    plain = precision.attention(*(t.clone().requires_grad_() for t in (q, k, v))).detach()
    err = (fused.float() - plain.float()).abs().max()
    assert float(err) <= 2 * ULP * float(plain.float().abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_the_tiny_net_matches_the_reference_on_the_card(dev, seed):
    net, ref = seeded_pair("bfloat16", seed)
    net, ref = net.to(dev), ref.to(dev)
    x = torch.randn(8, 64, 48, 3, generator=torch.Generator().manual_seed(seed + 7)).to(dev)
    with torch.inference_mode():
        got, want = net(x), ref(x)
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 4 * ULP * peak
