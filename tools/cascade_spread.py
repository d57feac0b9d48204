"""How far two float32 runs of the cascade's training stages land apart on
the CPU when only the order of summation changes (torch's thread count).

Runs `cascade_finetune.train_stages` (2 refiner, 3 GCN and 3 error-head
steps, the smoke's `cascade_vs_cpu` counts) from the shipped weights at
float32 on one synthetic collection (the generator's keypoints of 4 clips
of 48 frames at 540x960 plus normal noise of 4 px, random aux, seed 1),
once at 8 threads and once at 1, and prints per stage the largest loss gap,
the largest per-tensor ||a - b|| / ||b||, the largest element gap over its
tensor's peak and the largest element gap in absolute terms: the yardstick
for the card-against-CPU gaps of the smoke.

    python tools/cascade_spread.py [--artifacts artifacts]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from golfaction_tpu_torch import cascade_finetune as cf  # noqa: E402
from golfaction_tpu_torch import checkpoint, weights  # noqa: E402
from golfaction_tpu_torch.pipeline.orchestrator import init_params  # noqa: E402
from golfaction_tpu_torch.train import data  # noqa: E402

FLOAT32 = [f"{m}.dtype=float32" for m in ("pose", "gcn", "align", "error", "refine")]


def synthetic_collection(n: int = 4, T: int = 48, hw=(540, 960), seed: int = 1) -> dict:
    samples = data.make_swing_batch(n, T, seed=550_000, image_hw=hw, fault_prob=0.5)
    rng = np.random.default_rng(seed)
    gt = np.stack([s.keypoints for s in samples])
    pred = gt.copy()
    pred[..., :2] += rng.normal(0, 4, pred[..., :2].shape).astype(np.float32)
    return {"pred_kpts": pred, "pred_aux": rng.uniform(0, 30, (n, T, 17, 4)).astype(np.float32),
            "labels": np.stack([s.phase_labels for s in samples]),
            "flags": np.stack([s.error_flags for s in samples]), "gt_keypoints": gt,
            "gt_progress": np.stack([s.progress for s in samples]),
            "gt_fault_defl": np.stack([s.fault_defl for s in samples])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="artifacts")
    a = ap.parse_args(argv)
    args = cf.parse_args(["--artifacts", a.artifacts, "--out", "unused", "--clips", "4",
                          "--aug", "16", "--frames", "48", "--hw", "540", "960", "--steps", "3",
                          "--error-steps", "3", "--refine-steps", "2",
                          *(x for s in FLOAT32 for x in ("--set", s))])
    cfg = cf.cascade_config(args)
    params = {**init_params(cfg, 0), **weights.from_flax(checkpoint.load_params(a.artifacts))}
    col = synthetic_collection()
    runs = []
    for threads in (8, 1):
        torch.set_num_threads(threads)
        runs.append(cf.train_stages(args, cfg, params, col, torch.device("cpu"),
                                    lambda name, t: time.perf_counter(), log=lambda m: None))
    (pa, la, _), (pb, lb, _) = runs
    out = {}
    for stage in ("refine", "gcn", "error"):
        gaps = [(pa[stage][k] - pb[stage][k], pb[stage][k]) for k in pb[stage]]
        out[stage] = {
            "loss_rel": max(abs(x - y) / abs(y) for x, y in zip(la[stage], lb[stage])),
            "param_rel": max(float(d.norm() / b.norm().clamp(min=1e-12)) for d, b in gaps),
            "param_max_rel": max(float(d.abs().max() / b.abs().max().clamp(min=1e-12))
                                 for d, b in gaps),
            "param_max_abs": max(float(d.abs().max()) for d, _ in gaps)}
    print(json.dumps({"threads": [8, 1], "device": "cpu", "stages": out}))
    return out


if __name__ == "__main__":
    main()
