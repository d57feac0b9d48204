"""Shared helpers of the port's parity tests (tests/test_torch_*.py): carry a
JAX config and JAX parameters over to golfaction_tpu_torch."""

import dataclasses

import jax
import numpy as np

from golfaction_tpu_torch import config as tcfg
from golfaction_tpu_torch import weights

_SUB = {"pose": tcfg.PoseConfig, "gcn": tcfg.GCNConfig, "align": tcfg.AlignConfig,
        "error": tcfg.ErrorConfig, "refine": tcfg.RefineConfig, "mesh": tcfg.MeshConfig}

# JAX config fields that choose between two implementations of one function;
# the port runs one (its kernel) and has no such field.
_JAX_ONLY = {"pose": ("decode_impl",), "gcn": ("inference_impl",), None: ("preprocess_impl",)}


def _drop(d: dict, names) -> dict:
    return {k: v for k, v in d.items() if k not in names}


# Port fields the JAX package lacks (the pose net's backbone selector and the
# ViT's widths): a JAX config carries over with them at the port's defaults.
_PORT_ONLY = {"pose": ("backbone", "vit_width", "vit_depth", "vit_heads", "vit_mlp_width")}


def jax_config_dict(jax_cfg) -> dict:
    """dataclasses.asdict of a JAX PipelineConfig without its `*_impl` fields,
    with the port-only fields at the port's defaults: what the port's asdict
    of the same config must equal."""
    d = _drop(dataclasses.asdict(jax_cfg), _JAX_ONLY[None])
    for k in ("pose", "gcn"):
        d[k] = _drop(d[k], _JAX_ONLY[k])
    pose = dataclasses.asdict(tcfg.PoseConfig())
    d["pose"].update({k: pose[k] for k in _PORT_ONLY["pose"]})
    return d


def port_config(jax_cfg) -> tcfg.PipelineConfig:
    """The port's PipelineConfig with the same field values as a JAX one."""
    d = jax_config_dict(jax_cfg)
    subs = {k: cls(**d.pop(k)) for k, cls in _SUB.items()}
    return tcfg.PipelineConfig(**subs, **d)


def sub_config(cls, jax_sub):
    """Port counterpart of one JAX sub-config (PoseConfig, GCNConfig, ...)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(jax_sub).items() if k in names})


def to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def port_params(jax_params: dict) -> dict:
    """JAX pipeline params -> the port's {name: state_dict}."""
    return weights.from_flax(to_numpy(dict(jax_params)))


def flax_pose_layers(model, params, x) -> list:
    """[(path, input, output)] of every Conv, ConvTranspose and GroupNorm of
    a flax PoseNet run op by op (jax.disable_jit, so every value is rounded
    to the dtype the program states, as flax's semantics say), each as a
    float32 NHWC array of the layer's own values."""
    import flax.linen as nn
    import jax.numpy as jnp

    layers = []

    def record(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and isinstance(
                context.module, (nn.Conv, nn.ConvTranspose, nn.GroupNorm)):
            layers.append((context.module.scope.path,
                           np.asarray(args[0].astype(jnp.float32)),
                           np.asarray(out.astype(jnp.float32))))
        return out

    with jax.disable_jit(), nn.intercept_methods(record):
        model.apply(params, jnp.asarray(x))
    return layers


_RES_BLOCK = {"Conv_0": "conv1", "GroupNorm_0": "gn1", "Conv_1": "conv2", "GroupNorm_1": "gn2",
              "Conv_2": "proj", "GroupNorm_2": "gn3"}


def port_pose_layer(net, path):
    """The port PoseNet's module for a flax PoseNet module path."""
    name, idx = path[0].rsplit("_", 1)
    if name == "ResBlock":
        return getattr(net.blocks[int(idx)], _RES_BLOCK[path[1]])
    if name == "ConvTranspose":
        return net.deconvs[int(idx)]
    if name == "Conv":
        return net.stem if idx == "0" else net.final
    return net.gn0 if idx == "0" else net.dgns[int(idx) - 1]


def pose_layer_gaps(net, layers, dtype) -> list:
    """(path, share of elements that differ, largest gap over the layer's
    largest |value|) of each port layer given the flax layer's input at
    `dtype` (the port's modules compute at their input's dtype), against
    the flax layer's output."""
    import torch

    gaps = []
    for path, x, want in layers:
        mod = port_pose_layer(net, path)
        with torch.no_grad():
            got = mod(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).to(dtype))
        got = got.float().permute(0, 2, 3, 1).numpy()
        gap = np.abs(got - want)
        gaps.append(("/".join(path), float(np.mean(got != want)),
                     float(gap.max() / np.abs(want).max())))
    return gaps
