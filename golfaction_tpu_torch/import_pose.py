"""Import a published PyTorch pose checkpoint into an artifacts tree: the
port's counterpart of the JAX package's `scripts/import_pose.py`.

Walks the checkpoint's tensors in their own (definition) order beside the
port's PoseNet parameters in forward order (`train/import_weights.
import_torch_pose`; a square ConvTranspose keeps the source's kernel, ROADMAP
reference behaviour (x)), then writes `<out>/params/pose.npz` (the JAX
package's layout, float32) and `<out>/pose_import_report.json`.  BatchNorm
statistics do not transfer into this GroupNorm model: follow with a short
fine-tune (`train_eval --skip gcn align error --pose-steps 500
--pose-init-from <out>/params/pose.npz`).  `--out` is required and may not
lie inside the repo's `artifacts/`.

    python -m golfaction_tpu_torch.import_pose weights.pth --out <dir>
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.train import import_weights


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pth", help="torch checkpoint (.pth / .pt)")
    ap.add_argument("--out", required=True, help="the tree to write (not inside artifacts/)")
    ap.add_argument("--pose-in-frames", type=int, default=1)
    ap.add_argument("--state-dict-key", default=None,
                    help="key holding the state_dict inside the checkpoint "
                         "(auto-tries 'state_dict' / 'model')")
    ap.add_argument("--lenient", action="store_true",
                    help="allow unmatched parameters (partial import)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override of the full_pipeline preset's pose net, e.g. "
                         "--set pose.stage_channels=(16,32,64) (repeatable)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Import, write the npz and the report; prints and returns the JAX
    script's last line (with the npz path as `checkpoint`)."""
    args = parse_args(argv)
    checkpoint.refuse_inside(args.out)
    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    if args.state_dict_key:
        sd = sd[args.state_dict_key]
    else:
        for key in ("state_dict", "model"):
            if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    cfg = cfg_mod.apply_overrides(cfg_mod.get_config("full_pipeline"),
                                  [f"pose.in_frames={args.pose_in_frames}", *args.set]).pose
    model = PoseNet(cfg)
    report = import_weights.import_torch_pose(model, sd, cfg, strict=not args.lenient)
    os.makedirs(os.path.join(args.out, "params"), exist_ok=True)
    ck = checkpoint.save_params_npz(os.path.join(args.out, "params", "pose.npz"),
                                    weights.to_flax({"pose": model.state_dict()})["pose"],
                                    dtype=np.float32)
    report_path = os.path.join(args.out, "pose_import_report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=1)
    line = {"checkpoint": ck, "coverage": report["coverage"],
            "imported": len(report["imported"]), "report": report_path}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
