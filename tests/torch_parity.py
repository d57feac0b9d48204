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


def jax_config_dict(jax_cfg) -> dict:
    """dataclasses.asdict of a JAX PipelineConfig without its `*_impl` fields:
    what the port's asdict of the same config must equal."""
    d = _drop(dataclasses.asdict(jax_cfg), _JAX_ONLY[None])
    for k in ("pose", "gcn"):
        d[k] = _drop(d[k], _JAX_ONLY[k])
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
