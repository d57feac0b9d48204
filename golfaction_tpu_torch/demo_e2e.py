"""End-to-end evaluation of the shipped model through the port.

Renders held-out synthetic swing videos, runs the whole pipeline (video ->
crop -> pose -> decode -> GCN -> error head, plus the soft-DTW alignment
against a reference swing) with the trained weights of `--artifacts`, and
scores every output against the generator's ground truth with the port's
own `train/metrics.py`: PCK@0.05 through the whole video path, per-frame
phase accuracy and F1, fault detection on a stratified set (scored with
`error_thresholds.json`), alignment progress error, the two held-out scene
families, camera jitter with motion-energy against keypoint-refined boxes,
and a rendered side-by-side comparison video.  The arguments, seeds,
sections and JSON keys are those of the JAX package's `scripts/demo_e2e.py`.

    python -m golfaction_tpu_torch.demo_e2e --artifacts artifacts --out <dir>
        [--device cpu] [--set pose.dtype=float32 ...]

The photo-composite family renders real photos when matplotlib's sample
images are installed and value noise otherwise (train/data.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.pipeline import visualize
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.train import data, metrics


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _host(res):
    """(keypoints, phase labels, error probs) of an AnalysisResult as CPU tensors."""
    return res.keypoints.cpu(), res.phase_labels.cpu(), res.error_probs.cpu()


def _scores(res, sample, T: int):
    """(PCK@0.05, phase accuracy, phase F1) of one clip against its truth."""
    kpts, labels, _ = _host(res)
    bbox = torch.from_numpy(np.maximum(sample.boxes[:, 2], sample.boxes[:, 3]))
    pred = labels[:T]
    gt = torch.from_numpy(np.asarray(sample.phase_labels))
    return (float(metrics.pck(kpts[:T], torch.from_numpy(sample.keypoints), bbox, alpha=0.05)),
            float(metrics.phase_accuracy(pred, gt)),
            float(metrics.phase_f1(pred, gt, cfg_mod.NUM_PHASES)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--out", required=True, help="directory for e2e_metrics.json "
                                                 "and compare.mp4")
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--domain-clips", type=int, default=6,
                    help="clips per held-out scene family (0 disables)")
    ap.add_argument("--per-fault", type=int, default=10,
                    help="positive clips per fault in the stratified error eval")
    ap.add_argument("--jitter-clips", type=int, default=6,
                    help="camera-shake clips scoring motion-energy boxes against "
                         "keypoint-refined boxes (0 disables)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. --set pose.dtype=float32 (repeatable)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    T, hw = args.frames, tuple(args.hw)
    t_start = time.perf_counter()

    pipe = Pipeline.from_artifacts(
        args.artifacts, "full_pipeline", device=device,
        overrides=[f"video_hw={hw}", f"length_buckets=({T},)", *args.set])
    os.makedirs(args.out, exist_ok=True)
    cfg = pipe.cfg
    _log(f"loaded trained params from {args.artifacts} on {pipe.device} "
         f"(pose {cfg.pose.dtype}, gcn {cfg.gcn.dtype}, align {cfg.align.dtype}, "
         f"error {cfg.error.dtype})")

    # The main sections render from the training families only; transfer is
    # measured separately on the held-out families below.
    samples = data.make_swing_batch(args.clips, T, seed=990_000, image_hw=hw, render=True,
                                    fault_prob=0.5, scene_families=data.TRAIN_SCENE_FAMILIES)
    ref_sample = data.make_swing_batch(1, T, seed=991_000, image_hw=hw, render=True,
                                       fault_prob=0.0,
                                       scene_families=data.TRAIN_SCENE_FAMILIES)[0]
    ref_res = pipe.analyze(ref_sample.frames)
    ref_skel = pipe.extract_skeleton(ref_res)

    pcks, accs, f1s, prog_errs = [], [], [], []
    results = [pipe.analyze(s.frames, reference=ref_skel) for s in samples]
    for s, res in zip(samples, results):
        pck, acc, f1 = _scores(res, s, T)
        pcks.append(pck)
        accs.append(acc)
        f1s.append(f1)
        prog_errs.append(float(metrics.alignment_progress_error(
            res.alignment.path.cpu(), res.alignment.path_length.cpu(),
            torch.from_numpy(s.progress), torch.from_numpy(ref_sample.progress))))
    _log(f"[in-domain] PCK {np.mean(pcks):.4f} phase acc {np.mean(accs):.4f} "
         f"F1 {np.mean(f1s):.4f} progress err {np.mean(prog_errs):.4f}")

    # Fault detection on a stratified set: every fault represented.
    err_samples = data.make_fault_balanced_batch(
        args.per_fault, T, seed=993_000, image_hw=hw, render=True,
        clean=2 * args.per_fault, scene_families=data.TRAIN_SCENE_FAMILIES)
    err_pred = np.stack([_host(pipe.analyze(s.frames, reference=ref_skel))[2].numpy()
                         for s in err_samples])
    err_true = np.stack([s.error_flags for s in err_samples])
    thr = pipe.error_thresholds.cpu() if pipe.error_thresholds is not None else 0.5
    em = metrics.error_detection_metrics(torch.from_numpy(err_pred),
                                         torch.from_numpy(err_true), threshold=thr)
    _log(f"[errors] P {float(em['precision']):.4f} R {float(em['recall']):.4f} "
         f"F1 {float(em['f1']):.4f} over {len(err_samples)} clips")

    # The comparison video of the first clip.
    s0, r0 = samples[0], results[0]
    panels = visualize.render_comparison(
        s0.frames, r0.keypoints, ref_sample.frames, ref_res.keypoints, r0.alignment.path,
        int(r0.alignment.path_length), max_pairs=24)
    video_path = os.path.join(args.out, "compare.mp4")
    visualize.write_video(video_path, panels, fps=12)

    summary = {
        "clips": args.clips,
        "error_eval_clips": len(err_samples),
        "pck05_mean": float(np.mean(pcks)),
        "phase_acc_mean": float(np.mean(accs)),
        "phase_f1_mean": float(np.mean(f1s)),
        "error_detection": {k: float(v) for k, v in em.items()},
        "error_detection_per_fault": metrics.error_detection_per_fault(err_pred, err_true,
                                                                       thr),
        "align_progress_err_mean": float(np.mean(prog_errs)),
        "comparison_video": video_path,
    }

    # Scene families held out of all training: 2 (photo composite) and 3
    # (dusk lighting, striped shirt, warm cast, vignette; eval only).
    if args.domain_clips > 0:
        summary["unseen_domain"] = {}
        for fam, name in ((data.HELDOUT_SCENE_FAMILY, "photo_composite"),
                          (data.EVAL_ONLY_SCENE_FAMILY, "dusk")):
            dom = data.make_swing_batch(args.domain_clips, T, seed=994_000 + fam,
                                        image_hw=hw, render=True, fault_prob=0.5,
                                        scene_families=(fam,))
            sc = np.array([_scores(pipe.analyze(s.frames), s, T) for s in dom])
            summary["unseen_domain"][name] = {
                "clips": args.domain_clips,
                "pck05_mean": float(np.mean(sc[:, 0])),
                "phase_acc_mean": float(np.mean(sc[:, 1])),
                "phase_f1_mean": float(np.mean(sc[:, 2])),
            }
            _log(f"[domain:{name}] PCK {np.mean(sc[:, 0]):.4f} phase acc "
                 f"{np.mean(sc[:, 1]):.4f} F1 {np.mean(sc[:, 2]):.4f}")

    # Camera shake: motion-energy boxes against keypoint-refined boxes
    # (box_refine_stride=4).
    if args.jitter_clips > 0:
        jit = data.make_swing_batch(args.jitter_clips, T, seed=992_000, image_hw=hw,
                                    render=True, fault_prob=0.0, camera_jitter=0.03,
                                    scene_families=data.TRAIN_SCENE_FAMILIES)

        def pck_through(p):
            return float(np.mean([_scores(p.analyze(s.frames), s, T)[0] for s in jit]))

        pipe_r = Pipeline(dataclasses.replace(cfg, box_refine_stride=4),
                          {k: m.state_dict() for k, m in pipe.models.items()},
                          device=pipe.device)
        pck_motion, pck_refined = pck_through(pipe), pck_through(pipe_r)
        summary["jitter_eval"] = {
            "clips": args.jitter_clips,
            "camera_jitter": 0.03,
            "pck05_motion_boxes": pck_motion,
            "pck05_refined_boxes": pck_refined,
            "pck05_static_baseline": float(np.mean(pcks)),
        }
        _log(f"[jitter] PCK motion-boxes {pck_motion:.4f} vs refined {pck_refined:.4f} "
             f"(static baseline {np.mean(pcks):.4f})")
    with open(os.path.join(args.out, "e2e_metrics.json"), "w") as f:
        json.dump(summary, f, indent=2)
    _log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
