"""Frames/s of the device program at both crop dtypes: the port's
counterpart of the JAX package's `scripts/bench_preprocess_dtype.py`.

`PipelineConfig.preprocess_dtype` sets the dtype of the pose pass's crops:
"float32" through kernel A, "bfloat16" through its bfloat16 variant, whose
rounding is that of the JAX package's bfloat16 separable warp (uint8 pixels
are exact in bfloat16; the interpolation weights, the row values and the
result round).  This times `Pipeline._core_fn` (crops, pose net, decode,
GCN, error head) both ways on the shipped weights and one synthetic 1080p
clip, and reports the keypoint gap between the two dtypes.  It writes
nothing.

    python -m golfaction_tpu_torch.bench_preprocess_dtype [--clips 2] [--frames 64]
        [--iters 5] [--artifacts artifacts] [--device cuda | --cpu]

The card is the default; without one the module raises unless `--cpu` (the
plain versions) is given.  Each dtype's time is the least of `--iters`
calls, each ended by a synchronize, after one call that is not timed.
Prints one JSON line: {"fps_f32", "fps_bf16", "speedup", "kpt_med_px",
"kpt_p99_px", "clips", "frames"}; the log goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch.config import get_config
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline, resolve_device
from golfaction_tpu_torch.train import data

VIDEO_HW = (1080, 1920)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def clip_inputs(clips: int, T: int, device) -> tuple:
    """One seed-0 clip rendered at 1080p (the JAX script's draws, in its
    order), broadcast to `clips` clips: frames [clips, T, H, W, 3] uint8,
    boxes [clips, T, 4], valid [clips, T], on `device`."""
    rng = np.random.default_rng(0)
    s = data.swing_keypoints(T, rng)
    s = data.place_in_image(s, VIDEO_HW, person_height_px=700, rng=rng)
    s = data.render_frames(s, VIDEO_HW, rng=rng)
    frames = torch.from_numpy(np.ascontiguousarray(s.frames)).to(device)
    boxes = torch.from_numpy(np.asarray(s.boxes, np.float32)).to(device)
    return (frames.expand(clips, *frames.shape).contiguous(),
            boxes.expand(clips, *boxes.shape).contiguous(),
            torch.ones((clips, T), dtype=torch.bool, device=device))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)
    T = args.frames
    cfg = dataclasses.replace(get_config("full_pipeline"), length_buckets=(T,))
    cfg = checkpoint.config_for_artifacts(cfg, args.artifacts)
    params = weights.from_flax(checkpoint.load_params(args.artifacts))
    frames, boxes, valid = clip_inputs(args.clips, T, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fps, kpts = {}, {}
    for dt in ("float32", "bfloat16"):
        pipe = Pipeline(dataclasses.replace(cfg, preprocess_dtype=dt), params, device=device)
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = pipe._core_fn(frames, boxes, valid)
            sync()
            log(f"[{dt}] first run {time.perf_counter() - t0:.1f}s")
            ts = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                out = pipe._core_fn(frames, boxes, valid)
                sync()
                ts.append(time.perf_counter() - t0)
        best = min(ts)
        fps[dt] = args.clips * T / best
        kpts[dt] = out["keypoints"].float().cpu().numpy()
        log(f"[{dt}] {fps[dt]:,.1f} fps ({best * 1e3:.1f} ms / {args.clips * T} frames)")

    d = np.abs(kpts["bfloat16"][..., :2] - kpts["float32"][..., :2])
    result = {
        "fps_f32": round(fps["float32"], 1),
        "fps_bf16": round(fps["bfloat16"], 1),
        "speedup": round(fps["bfloat16"] / fps["float32"], 3),
        "kpt_med_px": round(float(np.median(d)), 4),
        "kpt_p99_px": round(float(np.percentile(d, 99)), 3),
        "clips": args.clips, "frames": T,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
