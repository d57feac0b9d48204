"""Post-training int8 pose: accuracy and speed against the float model.

Calibrates on rendered swing crops, then reports PCK@0.05 of the float, int8,
fused-int8 and mixed (int8 stages 1-3) forwards on other rendered clips, and
the time of each forward over all evaluation crops.

    python -m golfaction_tpu_torch.quantize_eval --artifacts artifacts

runs on the card (CUDA events around each forward, median of 5 after a warm
call).  `--device cpu` runs the same program on the CPU with the kernels'
plain versions, where the times are host-clock times of the CPU and say
nothing about the card; a small size keeps that quick:

    python -m golfaction_tpu_torch.quantize_eval --device cpu --artifacts none \\
        --calib-clips 1 --eval-clips 2 --frames 4 --image-hw 128 192 \\
        --set "input_hw=(64,48)" --set "heatmap_hw=(16,12)" \\
        --set "stage_blocks=(1,1,1)" --set "stage_channels=(16,32,64)" \\
        --set "deconv_channels=(32,32)"

Without a pose checkpoint under `<artifacts>/params` the weights are random
(seeded) and the PCK values only show that the program runs.  One JSON line
goes to stdout, progress to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.models import pose_quant
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import affine, heatmap
from golfaction_tpu_torch.pipeline.orchestrator import resolve_device
from golfaction_tpu_torch.train import data, loops, metrics


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_pose_model(artifacts: str, overrides=(), seed: int = 0, device="cuda") -> PoseNet:
    """The pose model of an artifacts tree (in_frames read off its stem), or
    seeded random weights when the tree has no pose checkpoint."""
    cfg = cfg_mod.PoseConfig(in_frames=checkpoint.detect_pose_in_frames(artifacts))
    cfg = cfg_mod.apply_overrides(cfg, list(overrides))
    model = PoseNet(cfg)
    params = checkpoint.load_params(artifacts, names=("pose",))
    if "pose" in params:
        model.load_state_dict(weights.pose_state_dict(params["pose"]))
        _log(f"loaded pose params from {artifacts}")
    else:
        weights.init_random(model, torch.Generator().manual_seed(seed))
        _log("WARNING: no trained pose checkpoint; evaluating random weights")
    return model.to(device).eval()


def render_crops(model: PoseNet, n_clips: int, frames: int, seed: int, image_hw):
    """(crops [n*frames, h, w, 3*in_frames], ground-truth keypoints, boxes)
    of `n_clips` rendered swings, on the model's device."""
    cfg = model.cfg
    device = next(model.parameters()).device
    samples = data.make_swing_batch(n_clips, frames, seed=seed, image_hw=tuple(image_hw),
                                    render=True)
    crops, gts, boxes_all = [], [], []
    for s in samples:
        boxes = affine.box_to_center_scale(
            torch.from_numpy(np.ascontiguousarray(s.boxes, np.float32)).to(device),
            aspect_ratio=cfg.input_hw[1] / cfg.input_hw[0]).contiguous()
        crops.append(loops.pose_eval_crops(s.frames, boxes, cfg))
        gts.append(torch.from_numpy(s.keypoints).to(device))
        boxes_all.append(boxes)
    return torch.cat(crops), torch.cat(gts), torch.cat(boxes_all)


def pck_of(hm: torch.Tensor, cfg, boxes: torch.Tensor, gt: torch.Tensor,
           alpha: float = 0.05) -> float:
    """PCK@alpha of heatmaps decoded with the single-peak UDP decode (kernel
    D on the card) against ground-truth image keypoints."""
    kpts = heatmap.decode_heatmaps(hm, "udp")
    img = heatmap.keypoints_to_image(kpts, boxes, cfg.heatmap_hw, cfg.input_hw)
    bbox = torch.maximum(boxes[:, 2], boxes[:, 3])
    return float(metrics.pck(img, gt, bbox, alpha=alpha))


def forward_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` calls after a warm one: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def forwards(model: PoseNet, qweights: dict, scales: dict) -> dict:
    """{name: crops -> heatmaps} of the float model and every int8 variant."""
    out = {"float": lambda x: model(x),
           "int8": lambda x: pose_quant.pose_forward_int8(model, qweights, scales, x),
           "int8_fused": lambda x: pose_quant.pose_forward_int8_fused(model, qweights, scales, x)}
    for k in (1, 2, 3):
        out[f"mixed{k}"] = lambda x, k=k: pose_quant.pose_forward_int8_mixed(
            model, qweights, scales, x, int8_stages=k)
    return out


@torch.inference_mode()
def evaluate(model: PoseNet, calib_crops, eval_crops, gt, boxes, reps: int = 5) -> dict:
    """Calibrate and quantize, then PCK@0.05 and milliseconds of every forward
    over `eval_crops`, in the JAX script's result layout."""
    device = eval_crops.device
    qweights, scales = pose_quant.prepare_int8(model, calib_crops)
    pck, ms = {}, {}
    for name, fn in forwards(model, qweights, scales).items():
        pck[name] = pck_of(fn(eval_crops), model.cfg, boxes, gt)
        ms[name] = forward_ms(lambda fn=fn: fn(eval_crops), device, reps)
    return {
        "pck_float": pck["float"], "pck_int8": pck["int8"], "pck_int8_fused": pck["int8_fused"],
        "ms_float": ms["float"], "ms_int8": ms["int8"], "ms_int8_fused": ms["int8_fused"],
        "speedup": ms["float"] / ms["int8"], "speedup_fused": ms["float"] / ms["int8_fused"],
        "mixed": {str(k): {"ms": ms[f"mixed{k}"], "pck": pck[f"mixed{k}"],
                           "speedup": ms["float"] / ms[f"mixed{k}"]} for k in (1, 2, 3)},
        "crops": int(eval_crops.shape[0]),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--calib-clips", type=int, default=4)
    ap.add_argument("--eval-clips", type=int, default=6)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--image-hw", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="PoseConfig override, e.g. stage_blocks=(1,1,1)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_pose_model(args.artifacts, args.set, device=device)
    _log("rendering calibration + eval clips ...")
    calib_crops, _, _ = render_crops(model, args.calib_clips, args.frames, 660_000,
                                     args.image_hw)
    eval_crops, gt, boxes = render_crops(model, args.eval_clips, args.frames, 661_000,
                                         args.image_hw)
    _log("calibrating and evaluating ...")
    result = evaluate(model, calib_crops, eval_crops, gt, boxes)
    _log(f"forward {result['crops']} crops on {result['device']}: "
         f"float {result['ms_float']:.2f} ms | int8 {result['ms_int8']:.2f} ms | "
         f"int8-fused {result['ms_int8_fused']:.2f} ms")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
