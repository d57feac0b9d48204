"""Import externally trained PyTorch weights into the port's models: the
counterpart of the JAX package's `golfaction_tpu/train/import_weights.py`.

The reference implies trained weights but ships none; if MMPose-style
PyTorch checkpoints ever surface, this module loads them.  The port's
convolutions are already in PyTorch's layouts (Conv2d OIHW, ConvTranspose2d
IOHW, Linear OI), so no tensor is transposed: where the JAX importer
converts a layout (`_convert_kernel`), this one checks that the shapes are
equal.  Normalization layers transfer as affine parameters only: a
BatchNorm source's running statistics have no counterpart in this build's
GroupNorm, so they are skipped and reported, and the caller decides whether
a partial import is acceptable (typically followed by a short fine-tune).

Two ways in, each with a per-tensor report:

* `import_torch_state_dict` matches tensors by name, for a state dict
  written from the port's own modules (or renamed to them);
* `import_torch_pose` walks a pose checkpoint in its own (definition)
  order beside the port's PoseNet parameters in forward order
  (`pose_param_order`), as the JAX importer does, for a state dict whose
  names are foreign.

A difference from the JAX importer: given a ConvTranspose whose input and
output widths are equal, the JAX `_convert_kernel` takes the source's IOHW
kernel for an OIHW one (its first candidate fits the flax shape), so it
swaps the kernel's in and out axes and does not flip it; this importer
keeps the source's kernel as it is (ROADMAP reference behaviour (x)).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _to_tensor(v: Any) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.asarray(v))


def _load(model: torch.nn.Module, new: dict) -> None:
    sd = model.state_dict()
    with torch.no_grad():
        for name, t in new.items():
            sd[name].copy_(t.to(sd[name].dtype))


def import_torch_state_dict(model: torch.nn.Module, state_dict: Mapping[str, Any],
                            strict: bool = False) -> dict:
    """Load `state_dict`'s tensors into `model` by name, in place.

    Returns the report: `imported` (each {"param", "torch", "shape"}),
    `skipped` (the model's tensors with no source of that name),
    `shape_mismatch` (a source of that name but another shape; the model's
    tensor is kept), `unused_torch` (source names the model does not have;
    `num_batches_tracked` is left out) and `coverage` (imported over the
    model's tensors).  `strict=True` raises ValueError, loading nothing,
    when anything is skipped, mismatched or unused."""
    own = model.state_dict()
    sources = {k: _to_tensor(v) for k, v in state_dict.items()
               if not k.endswith("num_batches_tracked")}
    imported, skipped, mismatch, new = [], [], [], {}
    for name, dst in own.items():
        if name not in sources:
            skipped.append({"param": name, "shape": list(dst.shape)})
        elif tuple(sources[name].shape) != tuple(dst.shape):
            mismatch.append({"param": name, "shape": list(dst.shape),
                             "torch_shape": list(sources[name].shape)})
        else:
            new[name] = sources[name]
            imported.append({"param": name, "torch": name, "shape": list(dst.shape)})
    report = {"imported": imported, "skipped": skipped, "shape_mismatch": mismatch,
              "unused_torch": [k for k in sources if k not in own],
              "coverage": len(imported) / max(len(own), 1)}
    if strict and (skipped or mismatch or report["unused_torch"]):
        raise ValueError(
            f"strict import failed: {len(skipped)} skipped "
            f"{[s['param'] for s in skipped][:8]}, {len(mismatch)} of another shape "
            f"{[m['param'] for m in mismatch][:8]}, unused {report['unused_torch'][:8]}")
    _load(model, new)
    return report


def pose_param_order(cfg) -> list[tuple[str, tuple[str, ...]]]:
    """(the port's PoseNet parameter name, the flax param path) of every
    PoseNet parameter in FORWARD order, derived from the config as the JAX
    `pose_param_order` derives its flax paths (models/pose.py; update both
    together)."""
    order: list[tuple[str, tuple[str, ...]]] = []

    def conv(name, flax):
        order.append((f"{name}.weight", (*flax, "kernel")))

    def gn(name, flax):
        order.append((f"{name}.weight", (*flax, "scale")))
        order.append((f"{name}.bias", (*flax, "bias")))

    conv("stem", ("Conv_0",))
    gn("gn0", ("GroupNorm_0",))
    in_ch, rb = 64, 0
    for i, (blocks, ch) in enumerate(zip(cfg.stage_blocks, cfg.stage_channels)):
        for b in range(blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            base, flax = f"blocks.{rb}", f"ResBlock_{rb}"
            conv(f"{base}.conv1", (flax, "Conv_0"))
            gn(f"{base}.gn1", (flax, "GroupNorm_0"))
            conv(f"{base}.conv2", (flax, "Conv_1"))
            gn(f"{base}.gn2", (flax, "GroupNorm_1"))
            if in_ch != ch or stride != 1:            # projection shortcut
                conv(f"{base}.proj", (flax, "Conv_2"))
                gn(f"{base}.gn3", (flax, "GroupNorm_2"))
            in_ch = ch
            rb += 1
    # The deconv head, and the extra deconvs that reach the heatmap stride.
    cur_stride = 4 * 2 ** (len(cfg.stage_blocks) - 1) // (2 ** len(cfg.deconv_channels))
    target_stride = cfg.input_hw[0] // cfg.heatmap_hw[0]
    n_deconv = len(cfg.deconv_channels)
    while cur_stride > target_stride:
        n_deconv += 1
        cur_stride //= 2
    for j in range(n_deconv):
        conv(f"deconvs.{j}", (f"ConvTranspose_{j}",))
        gn(f"dgns.{j}", (f"GroupNorm_{1 + j}",))
    conv("final", ("Conv_1",))                        # the 1x1 projection has a bias
    order.append(("final.bias", ("Conv_1", "bias")))
    return order


def import_torch_pose(model: torch.nn.Module, state_dict: Mapping[str, Any], cfg,
                      strict: bool = True) -> dict:
    """Order-preserving import of a PyTorch pose checkpoint into the port's
    PoseNet `model`, in place.

    Walks the model's parameters in forward order (`pose_param_order`) and
    `state_dict` in its own order with two pointers: each parameter takes
    the next source tensor of its shape; a source tensor of another shape
    is skipped and reported.  BatchNorm running statistics and
    `num_batches_tracked` are left out before the walk.  Returns the report:
    `imported` (each {"param", "flax", "torch", "shape"}), `skipped_torch`
    (each {"torch", "reason", ...}) and `coverage`.  `strict=True` raises
    ValueError, loading nothing, when the sources run out before every
    parameter has one."""
    own = model.state_dict()
    order = pose_param_order(cfg)
    missing = [name for name, _ in order if name not in own]
    if missing:
        raise ValueError(f"the model has no parameters {missing[:8]}: it is not a PoseNet "
                         f"of this config")
    sources = [(k, _to_tensor(v)) for k, v in state_dict.items()
               if not k.endswith("num_batches_tracked")
               and "running_mean" not in k and "running_var" not in k]
    si = 0
    imported, skipped, new = [], [], {}
    for name, flax in order:
        shape = tuple(own[name].shape)
        found = False
        while si < len(sources):
            sk, sv = sources[si]
            if tuple(sv.shape) == shape:
                found = True
                break
            skipped.append({"torch": sk, "reason": "no conversion", "shape": list(sv.shape)})
            si += 1
        if not found:
            if strict:
                raise ValueError(f"ordered import exhausted sources at {name} "
                                 f"(flax {'/'.join(flax)})")
            continue
        new[name] = sources[si][1]
        imported.append({"param": name, "flax": "/".join(flax), "torch": sources[si][0],
                         "shape": list(shape)})
        si += 1
    report = {"imported": imported,
              "skipped_torch": skipped + [{"torch": k, "reason": "unused"}
                                          for k, _ in sources[si:]],
              "coverage": len(imported) / max(len(order), 1)}
    _load(model, new)
    return report
