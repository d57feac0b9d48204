"""Weights for both sides: the shipped flax checkpoints (`params/*.npz`)
converted to the networks' state dicts, or random state dicts drawn on the
device from a seed.

Layouts: Conv HWIO -> OIHW; ConvTranspose HWIO -> IOHW with the spatial
axes flipped; Dense IO -> OI; depthwise conv (k, 1, 1, ch) -> (ch, 1, k);
Conv1d (k, Cin, Cout) -> (Cout, Cin, k); norms scale -> weight.
"""

from __future__ import annotations

import os

import numpy as np
import torch

MODELS = ("pose", "gcn", "align", "error")


def load_npz(path: str) -> dict:
    """A flattened npz checkpoint ("params/Conv_0/kernel", ...) -> nested dict, float32."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            arr = data[key]
            node[parts[-1]] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    return tree.get("params", tree)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _seq(p: dict, prefix: str) -> list:
    out = []
    while f"{prefix}_{len(out)}" in p:
        out.append(f"{prefix}_{len(out)}")
    return out


def _conv(sd, name, node):
    sd[f"{name}.weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _dense(sd, name, node):
    sd[f"{name}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _norm(sd, name, node):
    sd[f"{name}.weight"] = _t(node["scale"])
    sd[f"{name}.bias"] = _t(node["bias"])


def pose_sd(p: dict) -> dict:
    sd: dict = {}
    _conv(sd, "stem", p["Conv_0"])
    _norm(sd, "gn0", p["GroupNorm_0"])
    for i, name in enumerate(_seq(p, "ResBlock")):
        b = p[name]
        _conv(sd, f"blocks.{i}.conv1", b["Conv_0"])
        _norm(sd, f"blocks.{i}.gn1", b["GroupNorm_0"])
        _conv(sd, f"blocks.{i}.conv2", b["Conv_1"])
        _norm(sd, f"blocks.{i}.gn2", b["GroupNorm_1"])
        if "Conv_2" in b:
            _conv(sd, f"blocks.{i}.proj", b["Conv_2"])
            _norm(sd, f"blocks.{i}.gn3", b["GroupNorm_2"])
    for i, name in enumerate(_seq(p, "ConvTranspose")):
        k = np.asarray(p[name]["kernel"])[::-1, ::-1]
        sd[f"deconvs.{i}.weight"] = _t(np.transpose(k, (2, 3, 0, 1)))
        _norm(sd, f"dgns.{i}", p[f"GroupNorm_{i + 1}"])
    _conv(sd, "final", p["Conv_1"])
    return sd


def gcn_sd(p: dict) -> dict:
    sd: dict = {}
    for i, name in enumerate(_seq(p, "GCNBlock")):
        b, pre = p[name], f"blocks.{i}."
        sgc = b["SpatialGraphConv_0"]
        sd[pre + "sgc.kernel"] = _t(sgc["kernel"])
        sd[pre + "sgc.edge_importance"] = _t(sgc["edge_importance"])
        _norm(sd, pre + "ln0", b["LayerNorm_0"])
        m = b["MultiBranchTemporalConv_0"]
        for j, n in enumerate(_seq(m, "Dense")):
            _dense(sd, pre + f"mbtc.dense.{j}", m[n])
        for j, n in enumerate(_seq(m, "LayerNorm")):
            _norm(sd, pre + f"mbtc.ln.{j}", m[n])
        for j, n in enumerate(_seq(m, "Conv")):
            k = np.asarray(m[n]["kernel"])[:, 0, 0, :]
            sd[pre + f"mbtc.conv.{j}.weight"] = _t(k.T[:, None, :])
        _dense(sd, pre + "ca.fc1", b["ChannelAtt_0"]["Dense_0"])
        _dense(sd, pre + "ca.fc2", b["ChannelAtt_0"]["Dense_1"])
        s = b["STJointAtt_0"]
        _dense(sd, pre + "stja.fused", s["Dense_0"])
        _norm(sd, pre + "stja.norm", s["LayerNorm_0"])
        _dense(sd, pre + "stja.t_fc", s["Dense_1"])
        _dense(sd, pre + "stja.v_fc", s["Dense_2"])
        if "Dense_0" in b:
            _dense(sd, pre + "proj", b["Dense_0"])
    _dense(sd, "head0", p["Dense_0"])
    _dense(sd, "head1", p["Dense_1"])
    return sd


def align_sd(p: dict) -> dict:
    sd: dict = {}
    _dense(sd, "mixer", p["Dense_0"])
    _norm(sd, "mixer_ln", p["LayerNorm_0"])
    dense_i = 1
    for i, name in enumerate(_seq(p, "Conv")):
        k = np.asarray(p[name]["kernel"])                    # [k, Cin, Cout]
        sd[f"convs.{i}.weight"] = _t(np.transpose(k, (2, 1, 0)))
        _norm(sd, f"lns.{i}", p[f"LayerNorm_{i + 1}"])
        if k.shape[1] != k.shape[2]:
            _dense(sd, f"projs.{i}", p[f"Dense_{dense_i}"])
            dense_i += 1
    _dense(sd, "embed", p[f"Dense_{dense_i}"])
    return sd


def error_sd(p: dict) -> dict:
    sd: dict = {}
    _dense(sd, "fc0", p["Dense_0"])
    _norm(sd, "ln0", p["LayerNorm_0"])
    _dense(sd, "fc1", p["Dense_1"])
    _norm(sd, "ln1", p["LayerNorm_1"])
    _dense(sd, "fc2", p["Dense_2"])
    return sd


_CONVERT = {"pose": pose_sd, "gcn": gcn_sd, "align": align_sd, "error": error_sd}


def from_artifacts(root: str) -> dict:
    """{model: state_dict} of `<root>/params/<model>.npz`."""
    return {m: _CONVERT[m](load_npz(os.path.join(root, "params", f"{m}.npz"))) for m in MODELS}


@torch.no_grad()
def random_state(modules: dict, seed: int, device) -> dict:
    """{model: state_dict} of random weights for `modules` {model: nn.Module}:
    normal(0, 1/fan_in) matrices and kernels, unit norm scales and edge
    importances, zero biases.  The normals come from one generator on
    `device` seeded with `seed`, in one draw."""
    specs = []
    for m, mod in modules.items():
        for name, p in mod.named_parameters():
            specs.append((m, name, tuple(p.shape)))
    total = sum(int(np.prod(s)) for _, _, s in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out: dict = {m: {} for m in modules}
    pos = 0
    for m, name, shape in specs:
        n = int(np.prod(shape))
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "edge_importance" or (len(shape) == 1 and leaf == "weight"):
            t = torch.ones(shape, device=device)
        elif leaf == "bias":
            t = torch.zeros(shape, device=device)
        else:
            fan_in = shape[1] if leaf == "kernel" else int(np.prod(shape[1:]))
            t = flat[pos:pos + n].reshape(shape) / fan_in ** 0.5
        pos += n
        out[m][name] = t
    return out
