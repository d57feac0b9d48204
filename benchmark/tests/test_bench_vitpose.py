"""The vitpose_l configuration: its reference module's counts, a tiny cell
built, weighted and judged through the harness, the file's statement of
the port's configuration, and the new metrics' readers."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import check, system
from benchmark import run as bench
from benchmark.reference import nets, pose_reference, vitpose
from benchmark.reference.pipeline import Reference
from benchmark.tests.conftest import load, tiny_pipeline, tiny_traffic

TINY_VIT = {"backbone": "vit", "vit_width": 64, "vit_depth": 2, "vit_heads": 4,
            "vit_mlp_width": 256, "deconv_channels": [32, 32]}
METRICS = ("pose_net_mfu", "attn_roofline", "attn_fused_share", "vit_host_ms_per_request")


def tiny_vitpose() -> dict:
    """vitpose_l at tiny widths: 64 x 48 crops (4 x 3 tokens), width 64,
    2 blocks of 4 heads, MLP 256, heatmaps 16 x 12."""
    conf = tiny_pipeline(load("configs", "vitpose_l"))
    conf["pipeline"]["pose"].update(TINY_VIT)
    conf["overrides"] += [f"pose.{k}={tuple(v) if isinstance(v, list) else v}"
                          for k, v in TINY_VIT.items()]
    return conf


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_the_file_names_the_vitpose_reference():
    assert pose_reference(load("configs", "vitpose_l")) is vitpose


def test_pose_flops_match_flop_counter_at_tiny_widths():
    p = dict(tiny_vitpose()["pipeline"]["pose"], dtype="float32")
    net = vitpose.PoseNet(p, nets.Numerics())
    assert vitpose.token_grid(p) == (4, 3)
    assert vitpose.pose_flops(p) == _flops(lambda: net(torch.zeros(1, 64, 48, 3)))


def test_pose_flops_at_the_published_widths():
    # 123.1 GFLOP a crop: 24 blocks of 4.98 GFLOP, the patch embedding, the head.
    p = load("configs", "vitpose_l")["pipeline"]["pose"]
    assert vitpose.pose_flops(p) == 123_137_949_696
    assert vitpose.token_grid(p) == (16, 12)


def test_attn_bytes_flops_at_a_micro_batch():
    assert vitpose.attn_bytes_flops(64, 192, 1024) == (100_663_296, 9_663_676_416)
    # Its FLOPs are the two products of one attention, as FlopCounterMode counts them.
    attn = vitpose.Attention(1024, 16)
    with_attn = _flops(lambda: attn(torch.zeros(1, 192, 1024), nets.Numerics()))
    dense = 2 * 192 * 1024 * 3 * 1024 + 2 * 192 * 1024 * 1024
    assert with_attn - dense == vitpose.attn_bytes_flops(1, 192, 1024)[1]


def test_a_tiny_cell_builds_weights_the_vit_and_is_judged_correct():
    conf = tiny_vitpose()
    s = bench.Session(conf, tiny_traffic(), 2 ** 33 + 21, "cpu")
    from golfaction_tpu_torch.models.vit import ViTPose
    assert isinstance(s.pipe.pose_model, ViTPose)
    ref_keys = set(vitpose.PoseNet(conf["pipeline"]["pose"]).state_dict())
    assert set(s.state["pose"]) == ref_keys == set(s.pipe.pose_model.state_dict())
    assert "pos_embed" in ref_keys and "blocks.1.attn.qkv.weight" in ref_keys
    s.warm_up()
    s.measure(0.3, False)
    numbers = s.judge([(d.item, d.out) for d in s.picked()])
    ok, shown = check.verdict(numbers, conf["limits"])
    assert ok, shown
    # The control's lower precision reaches the ViT's products.
    low = Reference(conf, s.state, "cpu", lowp=True)
    x = torch.randn(2, 64, 48, 3, generator=torch.Generator().manual_seed(0))
    full = Reference(conf, s.state, "cpu")
    with torch.no_grad():
        assert not torch.equal(low.pose_net(x), full.pose_net(x))


def test_the_file_states_every_key_it_checks():
    from golfaction_tpu_torch.config import apply_overrides, get_config

    conf = load("configs", "vitpose_l")
    cfg = apply_overrides(get_config(conf["preset"]), conf["overrides"])
    assert cfg.pose.backbone == "vit" and cfg.pose.deconv_channels == (256, 256)
    assert system.check_config(cfg, conf["pipeline"]) == {}
    assert set(conf["limits"]) == set(check.NUMBERS) and conf["reduced"] == []


@pytest.mark.parametrize("name", METRICS)
def test_the_new_metrics_read_nothing_without_a_trace(name):
    import importlib

    run = bench.Run()
    run.stated = dict(load("configs", "vitpose_l")["pipeline"],
                      pose_reference="benchmark.reference.vitpose")
    run.peaks = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}
    assert importlib.import_module(f"benchmark.metrics.{name}").read(run) is None


def test_the_program_metrics_read_the_counters_and_spans():
    from benchmark import program_spans as ps
    from benchmark.metrics import attn_fused_share, vit_host_ms_per_request

    def span(name, self_us):
        s = ps.PSpan(name, 0.0, self_us, 0, None)
        s.self_us = self_us
        return s

    prog = ps.Program([span("pose.net", 10.0), span("pose.vit.blocks", 3000.0),
                       span("pose.vit.head", 1000.0)], {"attn_fused": 48, "attn_plain": 0},
                      0.0, 0.0)
    run = types.SimpleNamespace(trace=object(), traced=[1, 2], _program_spans=prog)
    assert attn_fused_share.read(run) == 100.0
    assert vit_host_ms_per_request.read(run) == pytest.approx(2.0)
    prog.counts = {"attn_fused": 1, "attn_plain": 3}
    assert attn_fused_share.read(run) == 25.0
    prog.spans = [span("pose.net", 10.0)]                  # a program without the ViT's spans
    assert vit_host_ms_per_request.read(run) is None


# Device activity names from a traced window of vitpose_l.resident_chunks on an
# H100 (torch 2.11, CUDA 12.8): the attention kernel of each fused backend
# (cuDNN's ran; flash's and the memory-efficient one's from a run of each
# alone), and the other names launched inside the pose span, cut to 88
# characters.
ATTENTION_NAMES = (
    "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_7_64x128x64_4x1x1_"
    "cga1x1x1_kernel0_0",
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128, 128, 4, false, "
    "false, cutlass::bfloat16_t, Flash_kernel_traits<64, 128, 128, 4, cutlass::b",
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<"
    "cutlass::bfloat16_t, cutlass::arch::Sm80, true, 64, 64, 64, true, true>::Params",
)
OTHER_POSE_NAMES = (
    'void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::nativ',
    'nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT',
    'nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN',
    'void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false',
    'void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(',
    'void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::Ten',
    'void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl(at::Ten',
    'void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloa',
    'void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_128x128_',
    'sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128',
    'sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize256x128',
    'Memset (Device)',
    'void (anonymous namespace)::group_norm_kernel<0>((anonymous namespace)::Args)',
    'void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_tn_align1>(cutlass_7',
    'void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, (cudnnKernelDataTyp',
    '(anonymous namespace)::crop_resize_normalize_kernel(unsigned char const*, float const*, ',
    'void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::nativ',
    '(anonymous namespace)::decode_kernel(float const*, float*, int, int)',
    'void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, st',
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous names',
    'void at::native::vectorized_elementwise_kernel<4, at::native::BUnaryFunctor<float, float',
    'void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::a',
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::',
    'void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, float',
    'void at::native::(anonymous namespace)::CatArrayBatchedCopy_vectorized<at::native::(anon',
    'Memcpy HtoD (Pageable -> Device)',
)


def test_the_attention_matcher_takes_the_fused_kernels_and_nothing_else():
    from benchmark.metrics import attn_roofline

    assert all(attn_roofline.is_attention(n) for n in ATTENTION_NAMES)
    assert not any(attn_roofline.is_attention(n) for n in OTHER_POSE_NAMES)


def test_attn_roofline_reads_the_least_time_over_the_kernels_time():
    from benchmark.metrics import attn_roofline

    p = load("configs", "vitpose_l")["pipeline"]["pose"]
    ops = [(ATTENTION_NAMES[0], 0.0, 50.0, "bench.pose"), (OTHER_POSE_NAMES[1], 0.0, 900.0,
                                                          "bench.pose"),
           (ATTENTION_NAMES[0], 0.0, 30.0, "bench.align")]
    trace = types.SimpleNamespace(device_seconds=lambda span, match: sum(
        d for n, _, d, s in ops if s == span and match(n)) * 1e-6)
    run = types.SimpleNamespace(trace=trace, traced=[types.SimpleNamespace(frames=3)],
                                stated=dict(load("configs", "vitpose_l")["pipeline"]),
                                peaks={"bf16_flops": 989e12, "hbm_bytes": 3.35e12})
    least = 24 * 3 * 4 * 192 * 1024 * 2 / 3.35e12                 # bytes-bound at 192 tokens
    assert p["vit_depth"] == 24
    assert attn_roofline.read(run) == pytest.approx(100.0 * least / 50e-6, rel=1e-12)
