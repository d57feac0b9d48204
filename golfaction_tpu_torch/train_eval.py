"""Train the four models on the synthetic swing dataset and evaluate them: the
port's counterpart of the JAX package's `scripts/train_eval.py`, with its
flags, defaults, schedule and evaluation seeds.

The build's accuracy numbers (PCK@0.05, swing-phase accuracy and F1, fault
detection precision / recall / F1 with and without a reference, alignment
progress error) go into `<out>/metrics.json`, merged into what an earlier
run (e.g. another `--skip` pass) wrote there, with the keys of
`artifacts/metrics.json`.  The trained weights go into
`<out>/params/{pose,gcn,align,error}.npz` in the JAX package's layout at
float32 (the trained weights to the bit), not into Orbax step folders: the
port reads and writes npz only, and it refuses an `--out` that holds a step
folder, or one inside the repo's `artifacts/`.  `pose_meta.json` is not
written, as the JAX script does not write it (`checkpoint.save_pose_meta`).

On the card the pose crops (training and evaluation) go through kernel A,
the GCN evaluation's forward through kernel B, every alignment step through
kernels C and E, the alignment evaluation's hard path through kernel C and
the pose evaluation's single-peak decode through kernel D.  The GCN is
evaluated through its inference program (float32 at any `gcn.dtype`, as
`analyze` runs it); the other models at their config's dtype.  With
`--eval-only` the error head takes the feature width of the tree's
`error.npz` (the shipped head reads the secondary-mode block, given as
zeros here, as `analyze` does without heatmaps).

    python -m golfaction_tpu_torch.train_eval --steps 300 --out <dir>
    python -m golfaction_tpu_torch.train_eval --skip pose --steps 200 --out <dir>
        [--device cpu] [--set gcn.block_channels=(8,16) ...]
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

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN, normalize_skeleton
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import softdtw
from golfaction_tpu_torch.pipeline.orchestrator import resolve_device
from golfaction_tpu_torch.train import data, loops, metrics

MODELS = ("pose", "gcn", "align", "error")
#: The JAX script's evaluation seeds.
GCN_SEED, ERROR_SEED, REF_SEED, ALIGN_SEED_B, POSE_SEED = 777_000, 778_000, 779_000, 779_500, 780_000
#: The JAX script's frame size of the pose render pool and the pose
#: evaluation, and the clips pre-rendered into that pool.
POSE_HW = (540, 960)
POSE_POOL = 160


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--pose-steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--out", required=True,
                    help="folder of the new tree (not inside the repo's artifacts/)")
    ap.add_argument("--skip", nargs="*", default=[], choices=list(MODELS))
    ap.add_argument("--eval-clips", type=int, default=32)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override of the full_pipeline preset, e.g. "
                         "--set gcn.block_channels=(8,16) (repeatable)")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate <out>/params/<name>.npz")
    ap.add_argument("--arm-weight", type=float, default=3.0,
                    help="pose loss upweight for elbows/wrists (hips at half the boost)")
    ap.add_argument("--fast-frame-boost", type=float, default=3.0,
                    help="oversampling boost for high-wrist-travel (motion-blurred) pool frames")
    ap.add_argument("--pose-in-frames", type=int, default=1,
                    help="adjacent frames channel-concatenated as pose input (1 or 3)")
    ap.add_argument("--pool-fault-prob", type=float, default=0.5,
                    help="fault rate in the pose render pool")
    ap.add_argument("--fault-frame-boost", type=float, default=2.0,
                    help="oversampling boost for pool frames where an injected fault "
                         "displaced a joint")
    ap.add_argument("--fault-joint-boost", type=float, default=2.0,
                    help="heatmap-loss upweight for exactly the joints a fault displaced, "
                         "scaled by deflection")
    ap.add_argument("--pose-init-from", default=None,
                    help="params checkpoint to warm-start pose training from (fresh "
                         "optimizer): a .npz in the JAX package's layout, or a training "
                         "checkpoint of the port's trainers (torch.save); an Orbax folder "
                         "is refused")
    ap.add_argument("--pose-lr", type=float, default=1e-3,
                    help="pose learning rate (finetunes want ~3e-4)")
    ap.add_argument("--pose-sigma", type=float, default=2.0,
                    help="training-target heatmap gaussian sigma")
    ap.add_argument("--arm-wander", type=float, default=0.0,
                    help="smooth random elbow/wrist wander amplitude (body units, ~0.1) in "
                         "the pose render pool")
    return ap.parse_args(argv)


def model_configs(args) -> cfg_mod.PipelineConfig:
    """The full_pipeline preset with --set applied, its pose config at
    --pose-in-frames and --pose-sigma; with --eval-only the error head at the
    feature width of `<out>/params/error.npz`."""
    cfg = cfg_mod.apply_overrides(cfg_mod.get_config("full_pipeline"), args.set)
    cfg = dataclasses.replace(cfg, pose=dataclasses.replace(
        cfg.pose, in_frames=args.pose_in_frames, sigma=args.pose_sigma))
    if args.eval_only:
        aux = checkpoint.detect_error_aux(args.out)
        if aux is not None:
            cfg = dataclasses.replace(cfg, error=dataclasses.replace(cfg.error, **aux))
    return cfg


def load_model(cls, model_cfg, root: str, name: str, device) -> torch.nn.Module:
    """A `cls` model of `model_cfg` with the weights of `<root>/params/<name>.npz`."""
    tree = checkpoint.load_params(root, names=(name,))
    if name not in tree:
        raise FileNotFoundError(f"--eval-only: {root} has no params/{name}.npz")
    model = cls(model_cfg)
    model.load_state_dict(weights.from_flax(tree)[name])
    return model.to(device).eval()


# ---------------------------------------------------------------------------
# The held-out evaluations (the JAX script's blocks)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def eval_gcn(model: ActionSegmentationGCN, clips: int, frames: int, device) -> dict:
    """Phase accuracy and macro-F1 on `clips` held-out swings of seed 777_000,
    through the GCN's inference program (kernel B on the card)."""
    model.eval().prepare()
    samples = data.make_swing_batch(clips, frames, seed=GCN_SEED)
    sk, labels, valid = loops.build_gcn_batch(samples, device=device)
    pred = model(sk, valid).argmax(-1)
    return {"eval_acc": float(metrics.phase_accuracy(pred, labels, valid)),
            "eval_f1": float(metrics.phase_f1(pred, labels, cfg_mod.NUM_PHASES, valid))}


@torch.inference_mode()
def eval_error(model: ErrorClassifier, clips: int, frames: int, device) -> dict:
    """Fault detection (micro precision / recall / F1 at 0.5) on `clips`
    held-out swings of seed 778_000 (fault rate 0.5) from ground-truth
    keypoints and one-hot phases: `eval` without a reference, `eval_with_ref`
    with a clean reference of seed 779_000 warped on by ground-truth
    progress."""
    model.eval()
    samples = data.make_swing_batch(clips, frames, seed=ERROR_SEED, fault_prob=0.5)
    refs = data.make_swing_batch(clips, frames, seed=REF_SEED, fault_prob=0.0)
    out = {}
    for key, r in (("eval", None), ("eval_with_ref", refs)):
        sk, phase_logits, flags, valid, ref_warp = loops.build_error_batch(samples, r,
                                                                           device=device)
        probs = torch.sigmoid(model(sk, phase_logits, valid, ref_warp))
        out[key] = {k: float(v) for k, v in metrics.error_detection_metrics(probs, flags).items()}
    return out


def align_eval_pairs(n: int = 8, frames: int = 48):
    """The alignment evaluation's pairs: swing i of seed 779_000 + i at tempo
    warp -0.6 against swing i of seed 779_500 + i at +0.6."""
    return [(data.swing_keypoints(frames, np.random.default_rng(REF_SEED + i), tempo_warp=-0.6),
             data.swing_keypoints(frames, np.random.default_rng(ALIGN_SEED_B + i),
                                  tempo_warp=0.6))
            for i in range(n)]


@torch.inference_mode()
def eval_align(model: AlignEncoder, device) -> float:
    """Mean progress error along the hard-DTW path (one batched call: kernel C
    at gamma 0 on the card) over the eight tempo-warped pairs."""
    model.eval()
    pairs = align_eval_pairs()
    ka = torch.from_numpy(np.stack([a.keypoints for a, _ in pairs])).to(device)
    kb = torch.from_numpy(np.stack([b.keypoints for _, b in pairs])).to(device)
    valid = torch.ones(ka.shape[:2], dtype=torch.bool, device=device)
    ea = model(normalize_skeleton(ka, valid), valid)
    eb = model(normalize_skeleton(kb, valid), valid)
    path, length = softdtw.dtw_path(softdtw.pairwise_sqdist(ea, eb))
    errs = [float(metrics.alignment_progress_error(
        path[i], length[i], torch.from_numpy(a.progress).to(device),
        torch.from_numpy(b.progress).to(device))) for i, (a, b) in enumerate(pairs)]
    return float(np.mean(errs))


def pose_eval_samples(image_hw=POSE_HW):
    """The pose evaluation's four rendered clips of 8 frames (seed 780_000,
    the training scene families)."""
    return data.make_swing_batch(4, 8, seed=POSE_SEED, image_hw=tuple(image_hw), render=True,
                                 scene_families=data.TRAIN_SCENE_FAMILIES)


def eval_pose(model: PoseNet, pose_cfg: cfg_mod.PoseConfig, image_hw=POSE_HW) -> float:
    """PCK@0.05 through crop (kernel A) -> pose net -> single-peak UDP decode
    (kernel D) on the pose evaluation's clips (`loops.evaluate_pose`)."""
    model.eval()
    return loops.evaluate_pose(model, pose_cfg, pose_eval_samples(image_hw))


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def main(argv=None) -> dict:
    """Train (unless --eval-only) and evaluate every model not in --skip;
    write the npz checkpoints and merge metrics.json.  Prints the JAX
    script's summary (the metrics without the histories); returns
    {"metrics": the merged metrics, "seconds": {model: host seconds of its
    training and evaluation}}."""
    args = parse_args(argv)
    checkpoint.refuse_inside(args.out)
    if os.path.isdir(args.out):
        checkpoint.refuse_step_dirs(args.out)
    if args.pose_init_from:
        checkpoint.refuse_step_dir(args.pose_init_from)
    device = resolve_device("cpu" if args.cpu else args.device)
    cfg = model_configs(args)
    pdir = os.path.join(args.out, "params")
    os.makedirs(pdir, exist_ok=True)
    metrics_path = os.path.join(args.out, "metrics.json")
    results = {}
    if os.path.exists(metrics_path):
        with open(metrics_path) as f:
            results = json.load(f)
    t_start = time.time()
    seconds = {}
    tc = cfg_mod.TrainConfig(batch_size=args.batch_size, total_steps=args.steps,
                             warmup_steps=max(args.steps // 10, 1))

    def train_or_load(name, cls, model_cfg, train):
        """(model, history, checkpoint path): trained and written, or with
        --eval-only read back."""
        path = os.path.join(pdir, f"{name}.npz")
        if args.eval_only:
            return (load_model(cls, model_cfg, args.out, name, device),
                    results.get(name, {}).get("history", []), path)
        state, hist = train()
        checkpoint.save_params_npz(path, weights.to_flax({name: state.params})[name],
                                   dtype=np.float32)
        return state.model, hist, path

    def lap(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0

    log_every = max(args.steps // 10, 1)
    if "gcn" not in args.skip:
        t0 = time.perf_counter()
        if not args.eval_only:
            _log(f"[gcn] training {args.steps} steps ...")
        model, hist, ck = train_or_load("gcn", ActionSegmentationGCN, cfg.gcn, lambda: loops.train_gcn(
            cfg.gcn, tc, frames_per_clip=args.frames, log_every=log_every, device=device))
        if hist and not args.eval_only:
            _log(f"[gcn] loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
        ev = eval_gcn(model, args.eval_clips, args.frames, device)
        results["gcn"] = {"history": hist, **ev, "checkpoint": ck}
        _log(f"[gcn] eval phase acc={ev['eval_acc']:.4f} macro-F1={ev['eval_f1']:.4f}")
        lap("gcn", t0)

    if "error" not in args.skip:
        t0 = time.perf_counter()
        if not args.eval_only:
            _log(f"[error] training {args.steps} steps ...")
        model, hist, ck = train_or_load("error", ErrorClassifier, cfg.error, lambda: loops.train_error(
            cfg.error, tc, frames_per_clip=args.frames, log_every=log_every, device=device))
        ev = eval_error(model, args.eval_clips, args.frames, device)
        results["error"] = {"history": hist, **ev, "checkpoint": ck}
        _log(f"[error] eval {ev['eval']}")
        _log(f"[error] eval+ref {ev['eval_with_ref']}")
        lap("error", t0)

    if "align" not in args.skip:
        t0 = time.perf_counter()
        align_steps = max(args.steps // 2, 1)
        if not args.eval_only:
            _log(f"[align] training {align_steps} steps ...")
        al_tc = dataclasses.replace(tc, total_steps=align_steps,
                                    batch_size=max(args.batch_size // 2, 2))
        model, hist, ck = train_or_load("align", AlignEncoder, cfg.align, lambda: loops.train_align(
            cfg.align, al_tc, frames_per_clip=48, log_every=max(align_steps // 10, 1),
            device=device))
        err = eval_align(model, device)
        results["align"] = {"history": hist, "eval_progress_err": err, "checkpoint": ck}
        _log(f"[align] eval mean progress error {err:.4f}")
        lap("align", t0)

    if "pose" not in args.skip:
        t0 = time.perf_counter()
        pose_steps = args.pose_steps or max(args.steps // 2, 1)
        if not args.eval_only:
            _log(f"[pose] training {pose_steps} steps ...")
        pose_tc = dataclasses.replace(tc, total_steps=pose_steps, learning_rate=args.pose_lr)
        model, hist, ck = train_or_load("pose", PoseNet, cfg.pose, lambda: loops.train_pose(
            cfg.pose, pose_tc, image_hw=POSE_HW, clips_per_epoch=8,
            frames_per_clip=8, log_every=max(pose_steps // 10, 1), pool_clips=POSE_POOL,
            arm_weight=args.arm_weight, fast_frame_boost=args.fast_frame_boost,
            pool_fault_prob=args.pool_fault_prob, fault_frame_boost=args.fault_frame_boost,
            fault_joint_boost=args.fault_joint_boost, arm_wander=args.arm_wander,
            init_from=args.pose_init_from, device=device))
        pck = eval_pose(model, cfg.pose, POSE_HW)
        results["pose"] = {"history": hist, "eval_pck05": pck, "checkpoint": ck}
        _log(f"[pose] eval PCK@0.05 = {pck:.4f}")
        lap("pose", t0)

    results["wall_time_s"] = time.time() - t_start
    with open(metrics_path, "w") as f:
        json.dump(results, f, indent=2)
    _log(f"wrote {metrics_path} ({results['wall_time_s']:.0f}s)")
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "history"}
                      if isinstance(v, dict) else v for k, v in results.items()}, indent=2))
    return {"metrics": results, "seconds": seconds}


if __name__ == "__main__":
    main()
