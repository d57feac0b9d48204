"""Post-training int8 quantization of the pose model.

A training-free int8 inference path for `models.pose.PoseNet`:

  * weights: per-output-channel symmetric int8 (absmax / 127);
  * activations: per-tensor symmetric int8, scales calibrated as the absmax
    of each convolution's input over a few batches;
  * convolutions and transposed convolutions run int8 x int8 -> int32,
    exactly; GroupNorm, relu and the final 1x1 projection stay floating point.

Three forwards share the quantized weights and scales:

  * `pose_forward_int8`        GroupNorm on bfloat16 activations between
                               the integer convolutions;
  * `pose_forward_int8_fused`  every tensor between two convolutions is int8:
                               dequantize, GroupNorm, residual, relu and
                               requantize are one pass of ops.requant (kernel
                               F on the card), 20 calls a forward at the
                               default depth;
  * `pose_forward_int8_mixed`  int8 stem and early stages, bfloat16 tail.

Activations are channels last ([N, H, W, C]) as in the JAX package, so the
quantized graph is the same tensor for tensor.

The integer convolution, on the CPU and on the card alike: a strided view of
the zero-padded int8 input gathers the patches into a matrix [N*Ho*Wo,
kh*kw*Cin], and `torch._int_mm` multiplies it with the int8 weight matrix
[kh*kw*Cin, Cout] into int32 (the int8 tensor cores on the card; the sizes
are padded to what cuBLASLt takes).  The transposed convolution is the same
product over the zero-stuffed input with the 4x4 kernel as flax stores it.
PyTorch has no integer convolution on CUDA, and a float32 one is not exact:
127 * 127 * K passes 2^24 from K = 1041 and K reaches 3 * 3 * 512.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from golfaction_tpu_torch.models import precision
from golfaction_tpu_torch.models.pose import PoseNet, _same_pads
from golfaction_tpu_torch.ops import requant


def _scalar(v: float, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """A Python float as a 0-dim tensor on `like`'s device: a divisor that is
    a tensor on the device is divided by, a host scalar may be multiplied
    with as its reciprocal."""
    return torch.tensor(float(v), dtype=dtype, device=like.device)


def _groups(ch: int) -> int:
    return min(32, ch)


def conv_names(model: PoseNet) -> list[str]:
    """Names of every convolution of `model`, in forward order, the final
    1x1 projection last."""
    names = ["stem"]
    for i, blk in enumerate(model.blocks):
        names += [f"blocks.{i}.conv1", f"blocks.{i}.conv2"]
        if blk.proj is not None:
            names.append(f"blocks.{i}.proj")
    names += [f"deconvs.{d}" for d in range(len(model.deconvs))]
    return names + ["final"]


# ---------------------------------------------------------------------------
# Calibration and weight quantization
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate(model: PoseNet, crops: torch.Tensor) -> dict:
    """Per-convolution activation scales from calibration crops [N, H, W, 3]
    (normalized floats): {conv name: absmax of its input / 127}, the absmax
    taken over all crops, 16 at a time."""
    record: dict[str, float] = {}
    modules = dict(model.named_modules())
    handles = []
    for name in conv_names(model):
        def hook(_m, args, name=name):
            record[name] = max(record.get(name, 0.0), float(args[0].abs().max()))
        handles.append(modules[name].register_forward_pre_hook(hook))
    try:
        step = max(min(16, crops.shape[0]), 1)
        for i in range(0, crops.shape[0], step):
            model(crops[i:i + step])
    finally:
        for h in handles:
            h.remove()
    return {k: v / 127.0 for k, v in record.items()}


def _q8(x: torch.Tensor, scale: float) -> torch.Tensor:
    """clamp(round(x / scale), -127, 127) as int8, in x's own float type."""
    return torch.round(x / _scalar(scale, x, x.dtype)).clamp(-127, 127).to(torch.int8)


def quantize_conv_weight(w: torch.Tensor, transposed: bool = False):
    """A Conv2d weight [O, I, kh, kw] (or a ConvTranspose2d weight [I, O, kh,
    kw]) -> (int8 matrix [kh*kw*I, O], scales [O]), per-output-channel symmetric.  The matrix rows run (kh, kw, I) over the
    kernel as flax stores it."""
    w = w.detach().float()
    if transposed:                      # back to flax's unflipped [kh, kw, I, O]
        hwio = w.flip(2, 3).permute(2, 3, 0, 1)
    else:
        hwio = w.permute(2, 3, 1, 0)
    s = hwio.abs().amax(dim=(0, 1, 2)).clamp(min=1e-8) / _scalar(127.0, w)
    q = torch.round(hwio / s).clamp(-127, 127).to(torch.int8)
    return q.reshape(-1, q.shape[-1]).contiguous(), s


@torch.no_grad()
def quantize_weights(model: PoseNet) -> dict:
    """{conv name: (int8 weight matrix, scales [O])} for every convolution but
    the final 1x1 projection, which stays float."""
    modules = dict(model.named_modules())
    return {name: quantize_conv_weight(modules[name].weight,
                                       transposed=name.startswith("deconvs."))
            for name in conv_names(model)[:-1]}


def prepare_int8(model: PoseNet, calib_crops: torch.Tensor):
    """One-call post-training quantization: (qweights, scales)."""
    return quantize_weights(model), calibrate(model, calib_crops)


# ---------------------------------------------------------------------------
# Exact integer convolutions (channels last)
# ---------------------------------------------------------------------------

def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, O] -> int32 [M, O].  The card's `_int_mm` wants
    M > 16 and K, O multiples of 8, and cuBLASLt on the H100 refuses M that is
    not a multiple of 32 when K < 128 and O >= 32: pad M to a multiple of 32
    and K, O to multiples of 8 with zeros, and cut the result."""
    M, K = a.shape
    O = b.shape[1]
    pm, pk, po = -M % 32, -K % 8, -O % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or po:
        b = F.pad(b, (0, po, 0, pk))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out[:M, :O] if (pm or po) else out


def _patches(xp: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Padded input [N, Hp, Wp, C] -> a view [N, Ho, Wo, k, k, C] of its k x k
    windows at `stride`."""
    xp = xp.contiguous()
    N, Hp, Wp, C = xp.shape
    Ho, Wo = (Hp - k) // stride + 1, (Wp - k) // stride + 1
    sN, sH, sW, sC = xp.stride()
    return xp.as_strided((N, Ho, Wo, k, k, C), (sN, stride * sH, stride * sW, sH, sW, sC))


def _pad_hw(x: torch.Tensor, k: int, stride: int, value=0) -> torch.Tensor:
    """flax SAME padding of [N, H, W, C] for a k x k window at `stride`."""
    ph = _same_pads(x.shape[1], k, stride)
    pw = _same_pads(x.shape[2], k, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


def _windows_matmul(xp: torch.Tensor, w_mat: torch.Tensor, k: int, stride: int):
    win = _patches(xp, k, stride)
    N, Ho, Wo = win.shape[:3]
    return _int_mm(win.reshape(N * Ho * Wo, -1), w_mat).reshape(N, Ho, Wo, w_mat.shape[1])


def conv_i8(x_i8: torch.Tensor, w_mat: torch.Tensor, k: int, stride: int = 1):
    """int8 [N, H, W, Cin] * int8 weight matrix -> int32 [N, Ho, Wo, Cout],
    SAME padding, exact."""
    return _windows_matmul(_pad_hw(x_i8, k, stride), w_mat, k, stride)


def deconv_i8(x_i8: torch.Tensor, w_mat: torch.Tensor):
    """The 4x4 stride-2 SAME transposed convolution, int8 -> int32 [N, 2H, 2W,
    Cout]: the input zero-stuffed to 2H-1, padded by 2, correlated with the
    kernel as it is."""
    N, H, W, C = x_i8.shape
    z = x_i8.new_zeros((N, 2 * H + 3, 2 * W + 3, C))
    z[:, 2:2 * H + 1:2, 2:2 * W + 1:2] = x_i8
    return _windows_matmul(z, w_mat, 4, 1)


def _max_pool(x: torch.Tensor, pad_value, k: int = 3, stride: int = 2):
    """SAME max pool of channels-last x, padded with `pad_value`."""
    return _patches(_pad_hw(x, k, stride, value=pad_value), k, stride).amax(dim=(3, 4))


def max_pool_i8(x_i8: torch.Tensor, k: int = 3, stride: int = 2):
    """SAME max pool on int8 [N, H, W, C] (padding value -128).  Monotone, so
    pooling after quantization is exact."""
    return _max_pool(x_i8, -128, k, stride)


# ---------------------------------------------------------------------------
# Floating-point pieces between the integer convolutions
# ---------------------------------------------------------------------------

# GroupNorm of bfloat16 channels-last x as flax computes it with dtype=bfloat16.
_gn16 = functools.partial(precision.group_norm, channels_last=True)


def _dequant16(y_i32, sx: float, s_w):
    return (y_i32.float() * (_scalar(sx, y_i32) * s_w)).to(torch.bfloat16)


def _conv16(x: torch.Tensor, conv: torch.nn.Module, k: int, stride: int = 1):
    """bfloat16 convolution of channels-last x with a float module's weight
    (SAME padding, no bias), bfloat16 out."""
    xp = _pad_hw(x.to(torch.bfloat16), k, stride).permute(0, 3, 1, 2)
    return F.conv2d(xp, conv.weight.to(torch.bfloat16), stride=stride).permute(0, 2, 3, 1)


def _stem16(model: PoseNet, qweights, scales, x):
    """Stem shared by the bfloat16-GroupNorm forwards: int8 7x7 convolution,
    GroupNorm, relu, max pool; bfloat16 [N, H/4, W/4, 64]."""
    w, s_w = qweights["stem"]
    y = _dequant16(conv_i8(_q8(x.float(), scales["stem"]), w, 7, 2), scales["stem"], s_w)
    y = F.relu(_gn16(y, model.gn0))
    return _max_pool(y, float("-inf"))


def _block_int8(blk, name: str, qweights, scales, x):
    """One ResBlock body with int8 convolutions and bfloat16 GroupNorm:
    (y, residual) before the closing add."""
    stride = blk.conv1.stride[0]
    w, s_w = qweights[f"{name}.conv1"]
    sx = scales[f"{name}.conv1"]
    y = F.relu(_gn16(_dequant16(conv_i8(_q8(x, sx), w, 3, stride), sx, s_w), blk.gn1))
    w, s_w = qweights[f"{name}.conv2"]
    sx = scales[f"{name}.conv2"]
    y = _gn16(_dequant16(conv_i8(_q8(y, sx), w, 3), sx, s_w), blk.gn2)
    residual = x
    if blk.proj is not None:
        w, s_w = qweights[f"{name}.proj"]
        sx = scales[f"{name}.proj"]
        residual = _gn16(_dequant16(conv_i8(_q8(x, sx), w, 1, stride), sx, s_w), blk.gn3)
    return y, residual


def _to_heatmaps(model: PoseNet, x: torch.Tensor) -> torch.Tensor:
    """The final 1x1 projection in float32 on channels-last x -> [N, K, h, w]."""
    return model.final(x.float().permute(0, 3, 1, 2)).float()


@torch.no_grad()
def pose_forward_int8(model: PoseNet, qweights: dict, scales: dict, x: torch.Tensor):
    """int8 inference forward.  x [B, H, W, 3] float -> heatmaps [B, K, h, w]."""
    x = _stem16(model, qweights, scales, x)
    for i, blk in enumerate(model.blocks):
        y, residual = _block_int8(blk, f"blocks.{i}", qweights, scales, x)
        x = F.relu(y + residual)
    for d, gn in enumerate(model.dgns):
        w, s_w = qweights[f"deconvs.{d}"]
        sx = scales[f"deconvs.{d}"]
        x = F.relu(_gn16(_dequant16(deconv_i8(_q8(x, sx), w), sx, s_w), gn))
    return _to_heatmaps(model, x)


@torch.no_grad()
def pose_forward_int8_mixed(model: PoseNet, qweights: dict, scales: dict, x: torch.Tensor,
                            int8_stages: int = 2):
    """int8 stem and the first `int8_stages` ResBlock stages, then the late
    stages, the deconv head and the final 1x1 in bfloat16."""
    stage_of = [i for i, nb in enumerate(model.cfg.stage_blocks) for _ in range(nb)]
    x = _stem16(model, qweights, scales, x)
    for i, blk in enumerate(model.blocks):
        if stage_of[i] < int8_stages:
            y, residual = _block_int8(blk, f"blocks.{i}", qweights, scales, x)
        else:
            stride = blk.conv1.stride[0]
            x = x.to(torch.bfloat16)
            y = F.relu(_gn16(_conv16(x, blk.conv1, 3, stride), blk.gn1))
            y = _gn16(_conv16(y, blk.conv2, 3), blk.gn2)
            residual = x
            if blk.proj is not None:
                residual = _gn16(_conv16(x, blk.proj, 1, stride), blk.gn3)
        x = F.relu(y + residual)
    x = x.permute(0, 3, 1, 2)
    for dc, gn in zip(model.deconvs, model.dgns):
        x = F.conv_transpose2d(x, dc.weight.to(torch.bfloat16), stride=2, padding=1)
        x = F.relu(_gn16(x.permute(0, 2, 3, 1), gn)).permute(0, 3, 1, 2)
    x = F.conv2d(x, model.final.weight.to(torch.bfloat16)) \
        + model.final.bias.to(torch.bfloat16)[:, None, None]
    return x.float()


@torch.no_grad()
def pose_forward_int8_fused(model: PoseNet, qweights: dict, scales: dict, x: torch.Tensor,
                            epilogue=requant.requant_epilogue):
    """int8 forward with fused epilogues (ops.requant): every tensor between
    two convolutions is int8, and each dequantize / GroupNorm / residual /
    relu / requantize chain is one call of `epilogue`.

    One numerical difference from `pose_forward_int8`: on identity-shortcut
    blocks the residual added here is the requantized int8 block input, there
    the bfloat16 activation before quantization.
    x [B, H, W, 3] float -> heatmaps [B, K, h, w]."""
    # The scale each int8 activation is written at: that of the convolution
    # that reads it next.
    block_in = [scales[f"blocks.{i}.conv1"] for i in range(len(model.blocks))]
    deconv_in = [scales[f"deconvs.{d}"] for d in range(len(model.deconvs))]
    after_block = block_in[1:] + deconv_in[:1]

    def sy(name):
        return _scalar(scales[name], x) * qweights[name][1]

    w, _ = qweights["stem"]
    y = conv_i8(_q8(x.float(), scales["stem"]), w, 7, 2)
    y = epilogue(y, sy("stem"), model.gn0.weight, model.gn0.bias, _groups(64),
                 relu=True, out_scale=block_in[0])
    h = max_pool_i8(y)

    for i, blk in enumerate(model.blocks):
        name = f"blocks.{i}"
        ch, stride = blk.conv2.out_channels, blk.conv1.stride[0]
        s_mid = scales[f"{name}.conv2"]
        y1 = conv_i8(h, qweights[f"{name}.conv1"][0], 3, stride)
        y1 = epilogue(y1, sy(f"{name}.conv1"), blk.gn1.weight, blk.gn1.bias, _groups(ch),
                      relu=True, out_scale=s_mid)
        y2 = conv_i8(y1, qweights[f"{name}.conv2"][0], 3)
        if blk.proj is not None:
            r = conv_i8(h, qweights[f"{name}.proj"][0], 1, stride)
            h = epilogue(y2, sy(f"{name}.conv2"), blk.gn2.weight, blk.gn2.bias, _groups(ch),
                         residual=r, res_scale=sy(f"{name}.proj"),
                         res_gamma=blk.gn3.weight, res_beta=blk.gn3.bias,
                         relu=True, out_scale=after_block[i])
        else:
            h = epilogue(y2, sy(f"{name}.conv2"), blk.gn2.weight, blk.gn2.bias, _groups(ch),
                         residual=h, res_scale=block_in[i],
                         relu=True, out_scale=after_block[i])

    for d, gn in enumerate(model.dgns):
        name = f"deconvs.{d}"
        last = d == len(model.dgns) - 1
        y = deconv_i8(h, qweights[name][0])
        h = epilogue(y, sy(name), gn.weight, gn.bias, _groups(gn.num_channels), relu=True,
                     out_scale=None if last else deconv_in[d + 1])
    return _to_heatmaps(model, h)
