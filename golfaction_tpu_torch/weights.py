"""Carry the JAX package's parameters over to the port's modules.

`from_flax(params_np)` takes the JAX parameter tree — {"pose", "gcn",
"align", "error", "refine"} of nested dicts of numpy arrays, as a restored
npz checkpoint or the JAX pipeline's exported params give it, each with or
without its top-level "params" key — and returns {name: state_dict} for
the port's PoseNet, ActionSegmentationGCN, AlignEncoder, ErrorClassifier
and KeypointRefiner.  Layouts:

  Conv            HWIO -> OIHW
  Dense           IO -> OI
  ConvTranspose   HWIO -> IOHW with the spatial axes flipped
  depthwise conv  (k, 1, 1, ch) -> (ch, 1, k)
  Conv1d          (k, Cin, Cout) -> (Cout, Cin, k)
  GroupNorm / LayerNorm   scale, bias -> weight, bias
  SpatialGraphConv        kernel [P, C, Co] and edge_importance [P, V, V]
                          as they are (folded into one matrix at load time)

`to_flax(state_dicts)` is the inverse: what the port trained goes back into
the JAX package's tree ({name: {"params": ...}} of numpy arrays), so that
`checkpoint.save_params_npz` writes a file the JAX package loads.

`quantized_from_flax(qweights, scales)` and `quantized_to_flax` carry the
int8 pose path's quantized weights ((w_i8 HWIO, s_w) per convolution, in the
JAX tree's names) and activation scales into models.pose_quant's form (int8
matrices [kh*kw*I, O] under the port's module names) and back.
"""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def init_random(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Fill a port module with random weights drawn from `gen` (a CPU
    generator): normal(0, 1/fan_in) matrices and kernels, unit norm scales
    and edge importances, zero biases."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "edge_importance" or (p.dim() == 1 and leaf == "weight"):
            p.fill_(1.0)
        elif leaf == "bias":
            p.zero_()
        else:
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            if leaf == "kernel":          # spatial graph conv [P, C, Co]
                fan_in = p.shape[1]
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _root(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def _conv(sd, name, node):
    sd[f"{name}.weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _deconv(sd, name, node):
    k = np.asarray(node["kernel"])[::-1, ::-1]
    sd[f"{name}.weight"] = _t(np.transpose(k, (2, 3, 0, 1)))


def _dense(sd, name, node):
    sd[f"{name}.weight"] = _t(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _norm(sd, name, node):
    sd[f"{name}.weight"] = _t(node["scale"])
    sd[f"{name}.bias"] = _t(node["bias"])


def _seq(p: dict, prefix: str) -> list[str]:
    """Flax auto-names `prefix_0, prefix_1, ...` present in `p`, in order."""
    out, i = [], 0
    while f"{prefix}_{i}" in p:
        out.append(f"{prefix}_{i}")
        i += 1
    return out


def pose_state_dict(tree: dict) -> dict:
    """The JAX package's pose tree (its ResNet) -> the port's PoseNet state dict."""
    p = _root(tree)
    if "Conv_0" not in p:
        raise ValueError(f"pose_state_dict: not a flax ResNet pose tree (pose.backbone='resnet'; "
                         f"the JAX package has no other): top-level keys {sorted(p)[:6]}")
    sd: dict = {}
    _conv(sd, "stem", p["Conv_0"])
    _norm(sd, "gn0", p["GroupNorm_0"])
    for i, blk in enumerate(_seq(p, "ResBlock")):
        b = p[blk]
        _conv(sd, f"blocks.{i}.conv1", b["Conv_0"])
        _norm(sd, f"blocks.{i}.gn1", b["GroupNorm_0"])
        _conv(sd, f"blocks.{i}.conv2", b["Conv_1"])
        _norm(sd, f"blocks.{i}.gn2", b["GroupNorm_1"])
        if "Conv_2" in b:
            _conv(sd, f"blocks.{i}.proj", b["Conv_2"])
            _norm(sd, f"blocks.{i}.gn3", b["GroupNorm_2"])
    for i, dc in enumerate(_seq(p, "ConvTranspose")):
        _deconv(sd, f"deconvs.{i}", p[dc])
        _norm(sd, f"dgns.{i}", p[f"GroupNorm_{i + 1}"])
    _conv(sd, "final", p["Conv_1"])
    return sd


def gcn_block_state_dict(b: dict) -> dict:
    """One flax GCNBlock subtree -> the port's GCNBlock state_dict."""
    sd: dict = {}
    sgc = b["SpatialGraphConv_0"]
    sd["sgc.kernel"] = _t(sgc["kernel"])
    sd["sgc.edge_importance"] = _t(sgc["edge_importance"])
    _norm(sd, "ln0", b["LayerNorm_0"])
    m = b["MultiBranchTemporalConv_0"]
    for j, name in enumerate(_seq(m, "Dense")):
        _dense(sd, f"mbtc.dense.{j}", m[name])
    for j, name in enumerate(_seq(m, "LayerNorm")):
        _norm(sd, f"mbtc.ln.{j}", m[name])
    for j, name in enumerate(_seq(m, "Conv")):
        k = np.asarray(m[name]["kernel"])                # [k, 1, 1, ch]
        sd[f"mbtc.conv.{j}.weight"] = _t(np.transpose(k[:, 0, 0, :], (1, 0))[:, None, :])
    _dense(sd, "ca.fc1", b["ChannelAtt_0"]["Dense_0"])
    _dense(sd, "ca.fc2", b["ChannelAtt_0"]["Dense_1"])
    s = b["STJointAtt_0"]
    _dense(sd, "stja.fused", s["Dense_0"])
    _norm(sd, "stja.norm", s["LayerNorm_0"])
    _dense(sd, "stja.t_fc", s["Dense_1"])
    _dense(sd, "stja.v_fc", s["Dense_2"])
    if "Dense_0" in b:
        _dense(sd, "proj", b["Dense_0"])
    return sd


def gcn_state_dict(tree: dict) -> dict:
    p = _root(tree)
    sd: dict = {}
    for i, blk in enumerate(_seq(p, "GCNBlock")):
        sd.update({f"blocks.{i}.{k}": v for k, v in gcn_block_state_dict(p[blk]).items()})
    _dense(sd, "head0", p["Dense_0"])
    _dense(sd, "head1", p["Dense_1"])
    return sd


def align_state_dict(tree: dict, hidden_channels) -> dict:
    p = _root(tree)
    sd: dict = {}
    _dense(sd, "mixer", p["Dense_0"])
    _norm(sd, "mixer_ln", p["LayerNorm_0"])
    dense_i = 1
    cin = hidden_channels[0]
    for i, ch in enumerate(hidden_channels):
        k = np.asarray(p[f"Conv_{i}"]["kernel"])         # [k, Cin, Cout]
        sd[f"convs.{i}.weight"] = _t(np.transpose(k, (2, 1, 0)))
        _norm(sd, f"lns.{i}", p[f"LayerNorm_{i + 1}"])
        if cin != ch:
            _dense(sd, f"projs.{i}", p[f"Dense_{dense_i}"])
            dense_i += 1
        cin = ch
    _dense(sd, "embed", p[f"Dense_{dense_i}"])
    return sd


def error_state_dict(tree: dict) -> dict:
    p = _root(tree)
    sd: dict = {}
    _dense(sd, "fc0", p["Dense_0"])
    _norm(sd, "ln0", p["LayerNorm_0"])
    _dense(sd, "fc1", p["Dense_1"])
    _norm(sd, "ln1", p["LayerNorm_1"])
    _dense(sd, "fc2", p["Dense_2"])
    return sd


def refine_state_dict(tree: dict) -> dict:
    p = _root(tree)
    sd: dict = {}
    for i, blk in enumerate(_seq(p, "GCNBlock")):
        sd.update({f"blocks.{i}.{k}": v for k, v in gcn_block_state_dict(p[blk]).items()})
    _dense(sd, "head", p["Dense_0"])
    return sd


def from_flax(params_np: dict) -> dict:
    """{model name: flax tree} -> {model name: torch state_dict}."""
    out = {}
    if "pose" in params_np:
        out["pose"] = pose_state_dict(params_np["pose"])
    if "gcn" in params_np:
        out["gcn"] = gcn_state_dict(params_np["gcn"])
    if "align" in params_np:
        ap = _root(params_np["align"])
        hidden = tuple(int(np.shape(ap[c]["kernel"])[2]) for c in _seq(ap, "Conv"))
        out["align"] = align_state_dict(params_np["align"], hidden)
    if "error" in params_np:
        out["error"] = error_state_dict(params_np["error"])
    if "refine" in params_np:
        out["refine"] = refine_state_dict(params_np["refine"])
    return out


# ---------------------------------------------------------------------------
# The way back: torch state_dicts -> flax trees
# ---------------------------------------------------------------------------

def _n(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _with_bias(sd, name, node):
    if f"{name}.bias" in sd:
        node["bias"] = _n(sd[f"{name}.bias"])
    return node


def _conv_out(sd, name):
    return _with_bias(sd, name, {"kernel": np.transpose(_n(sd[f"{name}.weight"]), (2, 3, 1, 0))})


def _deconv_out(sd, name):
    k = np.transpose(_n(sd[f"{name}.weight"]), (2, 3, 0, 1))
    return {"kernel": np.ascontiguousarray(k[::-1, ::-1])}


def _dense_out(sd, name):
    return _with_bias(sd, name, {"kernel": np.ascontiguousarray(_n(sd[f"{name}.weight"]).T)})


def _norm_out(sd, name):
    return {"scale": _n(sd[f"{name}.weight"]), "bias": _n(sd[f"{name}.bias"])}


def _count(sd, prefix: str) -> int:
    """How many `prefix.<i>.` groups a state_dict holds."""
    return len({k[len(prefix) + 1:].split(".")[0] for k in sd if k.startswith(prefix + ".")})


def _sub(sd, prefix: str) -> dict:
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def pose_tree(sd: dict) -> dict:
    """The port's ResNet pose state dict -> the JAX package's tree."""
    if "stem.weight" not in sd:
        kind = "a ViT (pose.backbone='vit')" if "patch_embed.proj.weight" in sd else "not a ResNet"
        raise ValueError(f"pose_tree: the state dict is {kind}; the JAX package's pose net, and "
                         f"so its tree, is the ResNet (pose.backbone='resnet')")
    p = {"Conv_0": _conv_out(sd, "stem"), "GroupNorm_0": _norm_out(sd, "gn0")}
    for i in range(_count(sd, "blocks")):
        b = {"Conv_0": _conv_out(sd, f"blocks.{i}.conv1"),
             "GroupNorm_0": _norm_out(sd, f"blocks.{i}.gn1"),
             "Conv_1": _conv_out(sd, f"blocks.{i}.conv2"),
             "GroupNorm_1": _norm_out(sd, f"blocks.{i}.gn2")}
        if f"blocks.{i}.proj.weight" in sd:
            b["Conv_2"] = _conv_out(sd, f"blocks.{i}.proj")
            b["GroupNorm_2"] = _norm_out(sd, f"blocks.{i}.gn3")
        p[f"ResBlock_{i}"] = b
    for i in range(_count(sd, "deconvs")):
        p[f"ConvTranspose_{i}"] = _deconv_out(sd, f"deconvs.{i}")
        p[f"GroupNorm_{i + 1}"] = _norm_out(sd, f"dgns.{i}")
    p["Conv_1"] = _conv_out(sd, "final")
    return {"params": p}


def gcn_block_tree(sd: dict) -> dict:
    """The port's GCNBlock state_dict -> one flax GCNBlock subtree."""
    m = {}
    for j in range(_count(sd, "mbtc.dense")):
        m[f"Dense_{j}"] = _dense_out(sd, f"mbtc.dense.{j}")
    for j in range(_count(sd, "mbtc.ln")):
        m[f"LayerNorm_{j}"] = _norm_out(sd, f"mbtc.ln.{j}")
    for j in range(_count(sd, "mbtc.conv")):
        w = _n(sd[f"mbtc.conv.{j}.weight"])                  # [ch, 1, k]
        m[f"Conv_{j}"] = {"kernel": np.ascontiguousarray(w[:, 0, :].T[:, None, None, :])}
    b = {"SpatialGraphConv_0": {"kernel": _n(sd["sgc.kernel"]),
                                "edge_importance": _n(sd["sgc.edge_importance"])},
         "LayerNorm_0": _norm_out(sd, "ln0"),
         "MultiBranchTemporalConv_0": m,
         "ChannelAtt_0": {"Dense_0": _dense_out(sd, "ca.fc1"),
                          "Dense_1": _dense_out(sd, "ca.fc2")},
         "STJointAtt_0": {"Dense_0": _dense_out(sd, "stja.fused"),
                          "LayerNorm_0": _norm_out(sd, "stja.norm"),
                          "Dense_1": _dense_out(sd, "stja.t_fc"),
                          "Dense_2": _dense_out(sd, "stja.v_fc")}}
    if "proj.weight" in sd:
        b["Dense_0"] = _dense_out(sd, "proj")
    return b


def gcn_tree(sd: dict) -> dict:
    p = {f"GCNBlock_{i}": gcn_block_tree(_sub(sd, f"blocks.{i}"))
         for i in range(_count(sd, "blocks"))}
    p["Dense_0"] = _dense_out(sd, "head0")
    p["Dense_1"] = _dense_out(sd, "head1")
    return {"params": p}


def align_tree(sd: dict) -> dict:
    p = {"Dense_0": _dense_out(sd, "mixer"), "LayerNorm_0": _norm_out(sd, "mixer_ln")}
    dense_i = 1
    for i in range(_count(sd, "convs")):
        k = _n(sd[f"convs.{i}.weight"])                      # [Cout, Cin, k]
        p[f"Conv_{i}"] = {"kernel": np.ascontiguousarray(np.transpose(k, (2, 1, 0)))}
        p[f"LayerNorm_{i + 1}"] = _norm_out(sd, f"lns.{i}")
        if f"projs.{i}.weight" in sd:
            p[f"Dense_{dense_i}"] = _dense_out(sd, f"projs.{i}")
            dense_i += 1
    p[f"Dense_{dense_i}"] = _dense_out(sd, "embed")
    return {"params": p}


def error_tree(sd: dict) -> dict:
    return {"params": {"Dense_0": _dense_out(sd, "fc0"), "LayerNorm_0": _norm_out(sd, "ln0"),
                       "Dense_1": _dense_out(sd, "fc1"), "LayerNorm_1": _norm_out(sd, "ln1"),
                       "Dense_2": _dense_out(sd, "fc2")}}


def refine_tree(sd: dict) -> dict:
    p = {f"GCNBlock_{i}": gcn_block_tree(_sub(sd, f"blocks.{i}"))
         for i in range(_count(sd, "blocks"))}
    p["Dense_0"] = _dense_out(sd, "head")
    return {"params": p}


_TO_FLAX = {"pose": pose_tree, "gcn": gcn_tree, "align": align_tree, "error": error_tree,
            "refine": refine_tree}


def to_flax(state_dicts: dict) -> dict:
    """{model name: torch state_dict} -> {model name: flax tree of numpy}."""
    return {name: _TO_FLAX[name](sd) for name, sd in state_dicts.items()}


# ---------------------------------------------------------------------------
# The int8 pose path's quantized weights and activation scales
# ---------------------------------------------------------------------------

_QCONV = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "proj"}
_QCONV_BACK = {v: k for k, v in _QCONV.items()}


def _port_conv_name(flax_name: str) -> str:
    """'Conv_0' | 'ResBlock_3/Conv_1' | 'ConvTranspose_0' | 'Conv_1' (the
    final projection) -> the port's module name."""
    if "/" in flax_name:
        blk, conv = flax_name.split("/")
        return f"blocks.{blk.split('_')[1]}.{_QCONV[conv]}"
    if flax_name.startswith("ConvTranspose_"):
        return f"deconvs.{flax_name.split('_')[1]}"
    return {"Conv_0": "stem", "Conv_1": "final"}[flax_name]


def _flax_conv_name(port_name: str) -> str:
    parts = port_name.split(".")
    if parts[0] == "blocks":
        return f"ResBlock_{parts[1]}/{_QCONV_BACK[parts[2]]}"
    if parts[0] == "deconvs":
        return f"ConvTranspose_{parts[1]}"
    return {"stem": "Conv_0", "final": "Conv_1"}[port_name]


def _kernel_size(port_name: str) -> int:
    leaf = port_name.split(".")[-1]
    if port_name.startswith("deconvs."):
        return 4
    return {"stem": 7, "conv1": 3, "conv2": 3, "proj": 1}[leaf]


def quantized_from_flax(qweights: dict, scales: dict):
    """The JAX int8 path's (qweights, scales), as numpy, -> the port's:
    {module name: (int8 matrix [kh*kw*I, O], float32 scales [O])} and
    {module name: float}."""
    flat = {}
    for name, entry in qweights.items():
        if isinstance(entry, dict):
            flat.update({f"{name}/{k}": v for k, v in entry.items()})
        else:
            flat[name] = entry
    q = {}
    for name, (w, s) in flat.items():
        w = np.array(w)
        q[_port_conv_name(name)] = (
            torch.from_numpy(w.reshape(-1, w.shape[-1])),
            torch.from_numpy(np.array(s, np.float32)))
    return q, {_port_conv_name(k): float(v) for k, v in scales.items()}


def quantized_to_flax(qweights: dict, scales: dict):
    """The inverse of `quantized_from_flax`: numpy (w_i8 HWIO, s_w) pairs in
    the JAX tree's nesting, and the scales under its names."""
    q: dict = {}
    for name, (w, s) in qweights.items():
        k = _kernel_size(name)
        w = w.detach().cpu().numpy()
        pair = (w.reshape(k, k, w.shape[0] // (k * k), w.shape[1]), _n(s))
        fname = _flax_conv_name(name)
        if "/" in fname:
            blk, conv = fname.split("/")
            q.setdefault(blk, {})[conv] = pair
        else:
            q[fname] = pair
    return q, {_flax_conv_name(k): float(v) for k, v in scales.items()}
