"""Training loops for the four models.

Each model gets: a `build_*_batch` function (the synthetic generator's numpy
samples -> tensors on the training device), a loss function, and a `train_*`
function that runs AdamW steps under a warmup-cosine schedule and returns the final
state and a metrics history.  The trainers run on the card unless the caller
passes `device="cpu"`; a CUDA device that is not there raises.

On the card `build_pose_batch` crops through kernel A, and a
`train_align` step is one launch of the soft-DTW forward wavefront (kernel
C) and one of its backward (kernel E).  The GCN trains through the plain
module chain: its fused tail kernel is forward-only.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from golfaction_tpu_torch import checkpoint as ckpt_mod
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch import graph, weights
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN, normalize_skeleton
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.ops import affine, heatmap, preprocess
from golfaction_tpu_torch.pipeline.orchestrator import resolve_device
from golfaction_tpu_torch.train import data as data_mod
from golfaction_tpu_torch.train import losses, metrics
from golfaction_tpu_torch.utils.logging import TensorBoardScalars


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Any
    step: int = 0

    @property
    def params(self) -> dict:
        """The model's state_dict (see weights.to_flax for the way back to
        the JAX package's layout)."""
        return self.model.state_dict()


def warmup_cosine(step: int, warmup_steps: int, decay_steps: int) -> float:
    """Learning-rate factor at `step`: linear 0 -> 1 over `warmup_steps`,
    then a cosine to 0 at `decay_steps`, flat 0 after."""
    if step < warmup_steps:
        return step / warmup_steps
    span = decay_steps - warmup_steps
    c = min(step - warmup_steps, span)
    return 0.5 * (1.0 + math.cos(math.pi * c / span))


def make_optimizer(params, cfg: cfg_mod.TrainConfig):
    """AdamW (every parameter decayed) and its warmup-cosine schedule; the
    step numbered n (from 0) runs at `cfg.learning_rate * warmup_cosine(n)`."""
    opt = torch.optim.AdamW(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda n: warmup_cosine(n, cfg.warmup_steps, decay_steps))
    return opt, sched


def global_grad_norm(model) -> torch.Tensor:
    """L2 norm over every parameter's gradient."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in model.parameters() if p.grad is not None]))


def train_step(model, optimizer, scheduler, loss_fn: Callable, batch, step: int = 0) -> dict:
    """One optimizer step.  `loss_fn(model, batch, step)` -> (loss, aux dict);
    returns aux with the loss and the global gradient norm added."""
    optimizer.zero_grad(set_to_none=True)
    loss, aux = loss_fn(model, batch, step)
    loss.backward()
    aux["grad_norm"] = global_grad_norm(model)
    optimizer.step()
    scheduler.step()
    aux["loss"] = loss.detach()
    return aux


def _checkpoint_path(train_cfg: cfg_mod.TrainConfig, tag: str, step: int) -> str:
    return os.path.join(train_cfg.checkpoint_dir, tag, f"step_{step:08d}.pt")


def _run_training(model, loss_fn: Callable, batch_fn: Callable[[int], Any],
                  train_cfg: cfg_mod.TrainConfig, log_every: int,
                  aux_keys: tuple[str, ...] = (), resume_from: str | None = None,
                  checkpoint_tag: str | None = None):
    """Shared step loop with optional checkpoint/resume.

    resume_from: a checkpoint file previously written by this loop —
    restores model, optimizer, schedule and step, and continues to
    total_steps.  checkpoint_tag: when set, saves them under
    <train_cfg.checkpoint_dir>/<tag>/step_XXXXXXXX.pt every
    train_cfg.checkpoint_every steps.  Each history record carries the step,
    the loss, the gradient norm, `aux_keys`, and `seconds`: the host clock
    since the loop began, read after the record's values have come back
    from the device.  With `train_cfg.tb_logdir` each record but its step
    is mirrored into TensorBoard scalars at its step.
    """
    optimizer, scheduler = make_optimizer(model.parameters(), train_cfg)
    start_step = 0
    if resume_from:
        state = torch.load(resume_from, map_location=next(model.parameters()).device,
                           weights_only=True)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        start_step = int(state["step"])

    model.train()
    history = []
    tb = TensorBoardScalars(train_cfg.tb_logdir)
    t0 = time.perf_counter()
    try:
        for step in range(start_step, train_cfg.total_steps):
            aux = train_step(model, optimizer, scheduler, loss_fn, batch_fn(step), step)
            if step % log_every == 0 or step == train_cfg.total_steps - 1:
                rec = {"step": step, "loss": float(aux["loss"]),
                       "grad_norm": float(aux["grad_norm"])}
                rec.update({k: float(aux[k]) for k in aux_keys})
                rec["seconds"] = time.perf_counter() - t0
                history.append(rec)
                tb.log(step, **{k: v for k, v in rec.items() if k != "step"})
            if (checkpoint_tag and train_cfg.checkpoint_every > 0
                    and (step + 1) % train_cfg.checkpoint_every == 0):
                path = _checkpoint_path(train_cfg, checkpoint_tag, step + 1)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                            "scheduler": scheduler.state_dict(), "step": step + 1}, path)
    finally:
        tb.close()        # flush the buffered scalars even when a step raises
    model.eval()
    return TrainState(model, optimizer, scheduler, train_cfg.total_steps), history


def _new_model(cls, cfg, train_cfg: cfg_mod.TrainConfig, device):
    """A model of `cls` with random weights from the training seed, on `device`."""
    model = cls(cfg)
    weights.init_random(model, torch.Generator().manual_seed(train_cfg.seed))
    return model.to(device)


# ---------------------------------------------------------------------------
# Batches (numpy samples -> tensors on the device)
# ---------------------------------------------------------------------------

def _pose_boxes(raw_boxes: np.ndarray, pose_cfg: cfg_mod.PoseConfig, device) -> torch.Tensor:
    boxes = affine.box_to_center_scale(
        torch.from_numpy(np.ascontiguousarray(raw_boxes, np.float32)).to(device),
        aspect_ratio=pose_cfg.input_hw[1] / pose_cfg.input_hw[0])
    return boxes.contiguous()


def _context_crops(frames_np: np.ndarray, idx: np.ndarray, boxes: torch.Tensor,
                   pose_cfg: cfg_mod.PoseConfig) -> torch.Tensor:
    """Crops of frames `idx` of one clip, with the temporal context of
    `pose_cfg.in_frames`: the neighbours t-k..t+k (clamped at the clip's
    edges) are cropped with frame t's box and concatenated on the channel
    axis, as the pipeline's pose pass does.  One launch of kernel A per
    offset on the card."""
    half = pose_cfg.in_frames // 2
    groups = []
    for off in range(-half, half + 1):
        nidx = np.clip(idx + off, 0, len(frames_np) - 1)
        frames = torch.from_numpy(np.ascontiguousarray(frames_np[nidx])).to(boxes.device)
        groups.append(preprocess.crop_resize_normalize(frames, boxes, pose_cfg.input_hw))
    return groups[0] if len(groups) == 1 else torch.cat(groups, dim=-1)


def build_pose_batch(samples, pose_cfg: cfg_mod.PoseConfig, frame_stride: int = 4,
                     box_jitter: float = 0.0, jitter_rng=None,
                     full_frame_prob: float = 0.0, device="cuda"):
    """Rendered samples -> (crops, target heatmaps, weights) tensors.

    Takes every `frame_stride`-th frame of each rendered clip as an
    independent pose training example.  box_jitter > 0 randomly scales
    (1±j) and shifts (±j/2 of size) the person boxes so the model is robust
    to the runtime's estimated (not ground-truth) boxes.  full_frame_prob
    replaces that fraction of boxes with the WHOLE frame — the cold-start
    crop of a keypoint-seeded box refinement, which must work from a
    full-frame view before any box is known.
    """
    device = resolve_device(device)
    jitter_rng = jitter_rng or np.random.default_rng(0)
    crops, targets, wts = [], [], []
    for s in samples:
        if s.frames is None:
            raise ValueError("render=True required for pose batches")
        idx = np.arange(0, len(s.frames), frame_stride)
        raw_boxes = s.boxes[idx].copy()
        n = len(idx)
        if box_jitter > 0:
            raw_boxes[:, 2:] *= jitter_rng.uniform(1 - box_jitter, 1 + box_jitter, (n, 2))
            raw_boxes[:, :2] += (raw_boxes[:, 2:] * jitter_rng.uniform(
                -box_jitter / 2, box_jitter / 2, (n, 2)))
        if full_frame_prob > 0:
            H, W = s.frames.shape[1:3]
            ff = jitter_rng.uniform(size=n) < full_frame_prob
            raw_boxes[ff] = [W / 2.0, H / 2.0, float(W), float(H)]
        boxes = _pose_boxes(raw_boxes, pose_cfg, device)
        crops.append(_context_crops(s.frames, idx, boxes, pose_cfg))
        kpts = torch.from_numpy(s.keypoints[idx]).to(device)
        hm_kpts = heatmap.image_keypoints_to_heatmap(
            kpts, boxes, pose_cfg.heatmap_hw, pose_cfg.input_hw)
        t, w = heatmap.make_heatmap_targets(hm_kpts[..., :2], pose_cfg.heatmap_hw,
                                            pose_cfg.sigma)
        targets.append(t)
        wts.append(w)
    return torch.cat(crops), torch.cat(targets), torch.cat(wts)


def pose_eval_crops(frames_np, boxes: torch.Tensor, pose_cfg: cfg_mod.PoseConfig):
    """Inference-convention crops for stage-wise eval: frames [T, H, W, 3]
    uint8 (numpy) and aspect-matched boxes [T, 4] on the device -> crops
    [T, h, w, 3 * in_frames], the same multi-frame channel concatenation as
    the pipeline's pose pass."""
    return _context_crops(frames_np, np.arange(len(frames_np)), boxes.contiguous(), pose_cfg)


def heatmap_pck(hm: torch.Tensor, boxes: torch.Tensor, gt_kpts, pose_cfg: cfg_mod.PoseConfig,
                alpha: float = 0.05) -> float:
    """PCK@alpha of one clip's heatmaps [T, V, Hh, Wh], taken from crops with
    the aspect-matched boxes [T, 4]: single-peak UDP decode (kernel D on
    the card), mapped to image px, held to the ground truth [T, V, >=2] at
    alpha * max(box w, box h)."""
    kpts = heatmap.decode_heatmaps(hm, "udp")
    kpts_img = heatmap.keypoints_to_image(kpts, boxes, pose_cfg.heatmap_hw, pose_cfg.input_hw)
    bbox = torch.maximum(boxes[:, 2], boxes[:, 3])
    gt = torch.as_tensor(np.asarray(gt_kpts), device=hm.device)
    return float(metrics.pck(kpts_img, gt, bbox, alpha=alpha))


@torch.no_grad()
def evaluate_pose(model: PoseNet, pose_cfg: cfg_mod.PoseConfig, samples,
                  alpha: float = 0.05) -> float:
    """Stage-wise pose evaluation on rendered samples: PCK@alpha through the
    full preprocess -> pose -> single-peak UDP decode -> image-space path
    (`heatmap_pck`), mean over the clips.  Runs where the model's weights
    lie."""
    device = next(model.parameters()).device
    pcks = []
    for s in samples:
        boxes = _pose_boxes(s.boxes, pose_cfg, device)
        hm = model(pose_eval_crops(s.frames, boxes, pose_cfg))
        pcks.append(heatmap_pck(hm, boxes, s.keypoints, pose_cfg, alpha))
    return float(np.mean(pcks))


def _stack(samples, field: str, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([getattr(s, field) for s in samples])).to(device)


def build_gcn_batch(samples, device="cuda"):
    """Keypoint samples (same T) -> (skeletons_norm, labels, valid)."""
    device = resolve_device(device)
    kpts = _stack(samples, "keypoints", device)
    labels = _stack(samples, "phase_labels", device).long()
    valid = torch.ones(labels.shape, dtype=torch.bool, device=device)
    return normalize_skeleton(kpts, valid), labels, valid


def build_align_batch(samples_a, samples_b, device="cuda"):
    """Paired swings -> (sk_a, sk_b, prog_a, prog_b)."""
    device = resolve_device(device)
    ka = _stack(samples_a, "keypoints", device)
    kb = _stack(samples_b, "keypoints", device)
    va = torch.ones(ka.shape[:2], dtype=torch.bool, device=device)
    vb = torch.ones(kb.shape[:2], dtype=torch.bool, device=device)
    return (normalize_skeleton(ka, va), normalize_skeleton(kb, vb),
            _stack(samples_a, "progress", device), _stack(samples_b, "progress", device))


def build_error_batch(samples, references=None, device="cuda"):
    """-> (kpts RAW, phase_logits, flags, valid, ref_warp RAW | None).

    The error head consumes RAW keypoints (it clip-normalizes internally to
    keep global-drift fault signals).  references: optional list of clean
    reference swings (one per sample); each is warped onto its sample's
    timeline via ground-truth progress (data.progress_align_reference — the
    ground-truth version of the runtime DTW warp), raw, training the
    alignment-deviation features.
    """
    device = resolve_device(device)
    kpts = _stack(samples, "keypoints", device)
    labels = _stack(samples, "phase_labels", device).long()
    valid = torch.ones(labels.shape, dtype=torch.bool, device=device)
    # Train against ground-truth phases as sharp logits (the runtime feeds
    # the GCN's soft posteriors; one-hot is the asymptotic version).
    phase_logits = F.one_hot(labels, cfg_mod.NUM_PHASES).float() * 10.0
    flags = _stack(samples, "error_flags", device)
    ref_warp = None
    if references is not None:
        ref_warp = torch.from_numpy(np.stack([
            data_mod.progress_align_reference(s, r)
            for s, r in zip(samples, references)])).to(device)
    return kpts, phase_logits, flags, valid, ref_warp


# ---------------------------------------------------------------------------
# Losses of the four trainers: (model, batch, step) -> (loss, aux)
# ---------------------------------------------------------------------------

def pose_joint_weights(arm_weight: float, device) -> torch.Tensor:
    """Per-joint heatmap-loss weights: elbows and wrists at `arm_weight`,
    hips at half the boost (hip-fault deflections under-transfer too)."""
    jw = np.ones(len(graph.COCO_KEYPOINTS), np.float32)
    jw[[7, 8, 9, 10]] = arm_weight
    jw[[11, 12]] = 1.0 + 0.5 * (arm_weight - 1.0)
    return torch.from_numpy(jw).to(device)


# Each takes `mesh=` (a parallel.mesh.Mesh): the loss and the aux values are
# then this data shard's share of the global batch's (losses.py), as
# parallel.train_step.make_dp_train_step wants them.

def pose_loss(model, batch, step: int = 0, joint_weights=None, mesh=None):
    crops, targets, wts = batch
    if joint_weights is not None:
        wts = wts * joint_weights
    return losses.heatmap_mse(model(crops), targets, wts, mesh=mesh), {}


def gcn_loss(model, batch, step: int = 0, seed: int = 0, mesh=None):
    """Label-smoothed per-frame cross entropy.  In training mode the block
    dropout draws from a generator seeded by (seed, step), so the mask
    changes every step and a resumed run draws the same masks (for the local
    batch, with a mesh)."""
    sk, labels, valid = batch
    gen = None
    if model.training and model.cfg.dropout > 0:
        gen = torch.Generator(device=sk.device).manual_seed(seed * 1_000_003 + step)
    logits = model(sk, valid, generator=gen)
    loss = losses.phase_cross_entropy(logits, labels, valid, label_smoothing=0.05, mesh=mesh)
    acc = losses.batch_mean((logits.argmax(-1) == labels).float(), mesh)
    return loss, {"acc": acc}


def align_loss(model, batch, step: int = 0, mesh=None):
    sk_a, sk_b, prog_a, prog_b = batch
    va = torch.ones(sk_a.shape[:2], dtype=torch.bool, device=sk_a.device)
    vb = torch.ones(sk_b.shape[:2], dtype=torch.bool, device=sk_b.device)
    ea = model(sk_a, va)
    eb = model(sk_b, vb)
    div = losses.batch_mean(losses.softdtw_divergence_batched(ea, eb, model.cfg.gamma), mesh)
    tcc = losses.batch_mean(losses.alignment_contrastive(ea, eb, prog_a, prog_b), mesh)
    return div + 10.0 * tcc, {"sdtw_div": div.detach(), "tcc": tcc.detach()}


def error_loss(model, batch, step: int = 0, mesh=None):
    sk, phase_logits, flags, valid, ref_warp = batch
    logits = model(sk, phase_logits, valid, ref_warp)
    loss = losses.error_bce(logits, flags, mesh=mesh)
    acc = losses.batch_mean(((torch.sigmoid(logits) > 0.5).float() == flags).float(), mesh)
    return loss, {"acc": acc}


# ---------------------------------------------------------------------------
# Per-model trainers
# ---------------------------------------------------------------------------

def _load_pose_init(model: PoseNet, init_from: str) -> None:
    """Params-only warm start: a compact .npz in the JAX package's layout, or
    a training checkpoint of these trainers (its model weights only).  An
    Orbax checkpoint (a folder) is refused."""
    ckpt_mod.refuse_step_dir(init_from)
    if init_from.endswith(".npz"):
        sd = weights.pose_state_dict(ckpt_mod.restore_params_npz(init_from))
    else:
        sd = torch.load(init_from, map_location="cpu", weights_only=True)["model"]
    model.load_state_dict(sd)


def train_pose(
    pose_cfg: cfg_mod.PoseConfig,
    train_cfg: cfg_mod.TrainConfig,
    image_hw=(256, 320),
    clips_per_epoch: int = 4,
    frames_per_clip: int = 16,
    log_every: int = 20,
    resume_from: str | None = None,
    checkpoint_tag: str | None = None,
    pool_clips: int = 0,
    arm_weight: float = 1.0,
    fast_frame_boost: float = 0.0,
    pool_fault_prob: float | None = None,
    fault_frame_boost: float = 0.0,
    fault_joint_boost: float = 0.0,
    arm_wander: float = 0.0,
    init_from: str | None = None,
    device="cuda",
):
    """Pose training.  pool_clips > 0 pre-renders that many clips ONCE, crops
    them onto the device and samples batches from the pool each step —
    rendering is host numpy and far slower than a training step.

    Arm-fidelity knobs (the pose front attenuates fast-arm fault
    deflections):
      arm_weight > 1 upweights elbow/wrist heatmap loss (joints 7-10);
      fast_frame_boost > 0 oversamples pool frames by wrist travel (the
        motion-blurred downswing frames are rare under uniform sampling);
      pool_fault_prob overrides the pool's fault rate (faulty swings move
        arms OFF the canonical path — image-trust supervision);
      fault_frame_boost / fault_joint_boost oversample pool frames and
        upweight the heatmap loss of exactly the joints an injected fault
        displaced (SwingSample.fault_defl);
      arm_wander adds smooth random elbow/wrist wander to the pool clips.
    init_from: params-only warm start (fresh optimizer, step 0).
    """
    device = resolve_device(device)
    model = _new_model(PoseNet, pose_cfg, train_cfg, device)
    if init_from:
        _load_pose_init(model, init_from)
    jw = pose_joint_weights(arm_weight, device)

    def loss_fn(m, batch, step):
        return pose_loss(m, batch, step, joint_weights=jw)

    if pool_clips > 0:
        # Half the pool is rendered with camera shake so estimated-box /
        # moving-camera crops are in-distribution.
        half = pool_clips // 2
        fault_kw = {}
        if pool_fault_prob is not None:
            fault_kw = dict(fault_prob=pool_fault_prob, sev_range=(0.3, 1.0))
        if arm_wander > 0:
            fault_kw["arm_wander"] = arm_wander
        pool = data_mod.make_swing_batch(
            pool_clips - half, frames_per_clip, seed=train_cfg.seed,
            image_hw=image_hw, render=True,
            scene_families=data_mod.TRAIN_SCENE_FAMILIES, **fault_kw,
        ) + data_mod.make_swing_batch(
            half, frames_per_clip, seed=train_cfg.seed + 50_000,
            image_hw=image_hw, render=True, camera_jitter=0.02,
            scene_families=data_mod.TRAIN_SCENE_FAMILIES, **fault_kw,
        )
        jr = np.random.default_rng(train_cfg.seed + 31)
        pool_batches = [
            build_pose_batch([s], pose_cfg, frame_stride=1, box_jitter=0.25, jitter_rng=jr,
                             full_frame_prob=0.25, device=device)
            for s in pool
        ]
        crops = torch.cat([b[0] for b in pool_batches])
        targets = torch.cat([b[1] for b in pool_batches])
        wts = torch.cat([b[2] for b in pool_batches])

        # Fault deflection per pooled crop/joint, normalized so ~15 px of
        # displacement reaches full boost (an absolute scale keeps
        # small-but-real faults from being drowned by the largest ones).
        defl = np.concatenate([
            s.fault_defl if s.fault_defl is not None
            else np.zeros(s.keypoints.shape[:2], np.float32)
            for s in pool
        ])                                              # [N, V] px
        defl_unit = np.minimum(defl / 15.0, 2.0) / 2.0  # [N, V] in [0, 1]
        if fault_joint_boost > 0:
            wts = wts * torch.from_numpy(
                (1.0 + fault_joint_boost * defl_unit).astype(np.float32)).to(device)
        n = crops.shape[0]
        per_step = clips_per_epoch * max(frames_per_clip // 4, 1)

        # Sampling probabilities over pooled crops: uniform, optionally
        # boosted toward high-wrist-travel (motion-blurred) frames and
        # toward frames where an injected fault displaced any joint.
        travel = np.concatenate([
            np.linalg.norm(
                np.diff(s.keypoints[:, 9, :2], axis=0, prepend=s.keypoints[:1, 9, :2]),
                axis=-1)
            for s in pool
        ])
        p_sample = (1.0 + fast_frame_boost * travel / max(travel.max(), 1e-6)
                    + fault_frame_boost * defl_unit.max(axis=-1))
        p_sample /= p_sample.sum()

        # Horizontal-flip augmentation table: mirror the crop's W axis and
        # swap left/right joint channels (graph.FLIP_PAIRS).
        perm = np.arange(len(graph.COCO_KEYPOINTS))
        for a, b in graph.FLIP_PAIRS:
            perm[a], perm[b] = b, a
        perm = torch.from_numpy(perm).to(device)
        k_ms_rgb = (np.asarray(preprocess.IMAGENET_MEAN, np.float32)
                    / np.asarray(preprocess.IMAGENET_STD, np.float32))

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        def batch_fn(step):
            # Every draw below comes from this one stream, in this order.
            rng = np.random.default_rng(train_cfg.seed + 7919 * step)
            idx = torch.from_numpy(rng.choice(n, size=min(per_step, n), replace=False,
                                              p=p_sample)).to(device)
            c, t, w = crops[idx], targets[idx], wts[idx]
            if rng.uniform() < 0.5:
                k = c.shape[0] // 2  # flip the first half of the batch
                c = torch.cat([c[:k].flip(2), c[k:]])
                t = torch.cat([t[:k][:, perm].flip(-1), t[k:]])
                w = torch.cat([w[:k][:, perm], w[k:]])
            # Photometric domain randomization: per-crop color cast /
            # contrast / brightness / noise + random-erase clutter patches,
            # applied in normalized-crop space; the color cast is shared
            # across the temporal channel groups.
            B, H, W_, C = c.shape
            cast = np.tile(rng.uniform(0.6, 1.4, (B, 1, 1, 3)),
                           (1, 1, 1, C // 3)).astype(np.float32)
            contr = rng.uniform(0.65, 1.45, (B, 1, 1, 1)).astype(np.float32)
            bright = rng.normal(0, 0.32, (B, 1, 1, 1)).astype(np.float32)
            m = c.mean(dim=(1, 2, 3), keepdim=True)
            c = (c - m) * dev(contr * cast) + m + dev(bright)
            # Low-frequency multiplicative shading (lens vignette / uneven
            # lighting): per-crop linear gain field over the crop plane.
            # Crops are ImageNet-standardized (p - mean)/std, so a true
            # pixel-space gain p' = g*p maps to g*c + (g-1)*mean/std.
            yy = np.linspace(-0.5, 0.5, H, dtype=np.float32)[None, :, None, None]
            xx = np.linspace(-0.5, 0.5, W_, dtype=np.float32)[None, None, :, None]
            ga = rng.uniform(-0.5, 0.5, (B, 1, 1, 1)).astype(np.float32)
            gb = rng.uniform(-0.5, 0.5, (B, 1, 1, 1)).astype(np.float32)
            g = np.clip(1.0 + ga * yy + gb * xx, 0.4, 1.6)
            k_ms = np.tile(k_ms_rgb[None, None, None], (1, 1, 1, C // 3))
            c = c * dev(g) + dev((g - 1.0) * k_ms)
            sig = rng.uniform(0, 0.08, (B, 1, 1, 1)).astype(np.float32)
            c = c + dev(rng.normal(0, 1, tuple(c.shape)).astype(np.float32) * sig)
            mask = np.zeros((B, H, W_, 1), np.float32)
            colors = np.tile(rng.normal(0, 1, (B, 1, 1, 3)),
                             (1, 1, 1, C // 3)).astype(np.float32)
            for bi in range(B):
                for _ in range(int(rng.integers(0, 3))):  # 0-2 erase rects
                    eh = int(rng.uniform(0.08, 0.3) * H)
                    ew = int(rng.uniform(0.08, 0.3) * W_)
                    y0 = int(rng.integers(0, max(H - eh, 1)))
                    x0 = int(rng.integers(0, max(W_ - ew, 1)))
                    mask[bi, y0:y0 + eh, x0:x0 + ew] = 1.0
            mask_t = dev(mask)
            c = c * (1 - mask_t) + dev(colors) * mask_t
            return c, t, w
    else:
        def batch_fn(step):
            samples = data_mod.make_swing_batch(
                clips_per_epoch, frames_per_clip, seed=train_cfg.seed + step,
                image_hw=image_hw, render=True,
                scene_families=data_mod.TRAIN_SCENE_FAMILIES,
            )
            return build_pose_batch(samples, pose_cfg, device=device)

    return _run_training(model, loss_fn, batch_fn, train_cfg, log_every,
                         resume_from=resume_from, checkpoint_tag=checkpoint_tag)


def train_gcn(
    gcn_cfg: cfg_mod.GCNConfig,
    train_cfg: cfg_mod.TrainConfig,
    frames_per_clip: int = 64,
    log_every: int = 20,
    resume_from: str | None = None,
    checkpoint_tag: str | None = None,
    device="cuda",
):
    """GCN training.  The returned model is in eval mode and needs
    `prepare()` before its fused forward."""
    device = resolve_device(device)
    model = _new_model(ActionSegmentationGCN, gcn_cfg, train_cfg, device)

    def loss_fn(m, batch, step):
        return gcn_loss(m, batch, step, seed=train_cfg.seed)

    def batch_fn(step):
        samples = data_mod.make_swing_batch(
            train_cfg.batch_size, frames_per_clip, seed=train_cfg.seed + step)
        return build_gcn_batch(samples, device=device)

    return _run_training(model, loss_fn, batch_fn, train_cfg, log_every,
                         aux_keys=("acc",), resume_from=resume_from,
                         checkpoint_tag=checkpoint_tag)


def align_pairs(train_cfg: cfg_mod.TrainConfig, frames_per_clip: int, step: int):
    """The alignment trainer's samples of one step: pairs with the same swing
    content under different tempo, style and noise."""
    rng = np.random.default_rng(train_cfg.seed + step)
    sa, sb = [], []
    for _ in range(train_cfg.batch_size):
        warp_a, warp_b = rng.uniform(-0.8, 0.8, 2)
        r = np.random.default_rng(rng.integers(1 << 31))
        sa.append(data_mod.swing_keypoints(frames_per_clip, r, tempo_warp=warp_a))
        r = np.random.default_rng(rng.integers(1 << 31))
        sb.append(data_mod.swing_keypoints(frames_per_clip, r, tempo_warp=warp_b))
    return sa, sb


def train_align(
    align_cfg: cfg_mod.AlignConfig,
    train_cfg: cfg_mod.TrainConfig,
    frames_per_clip: int = 48,
    log_every: int = 20,
    resume_from: str | None = None,
    checkpoint_tag: str | None = None,
    device="cuda",
):
    device = resolve_device(device)
    model = _new_model(AlignEncoder, align_cfg, train_cfg, device)

    def batch_fn(step):
        return build_align_batch(*align_pairs(train_cfg, frames_per_clip, step),
                                 device=device)

    return _run_training(model, align_loss, batch_fn, train_cfg, log_every,
                         aux_keys=("sdtw_div", "tcc"), resume_from=resume_from,
                         checkpoint_tag=checkpoint_tag)


def error_samples(train_cfg: cfg_mod.TrainConfig, frames_per_clip: int, step: int):
    """The error trainer's samples of one step: (samples, references | None).
    Steps alternate with and without a reference so one parameter set serves
    both runtime modes (analyze with and without a reference swing)."""
    # sev_range widened below the generator default: the pose front
    # attenuates fault deflections, so runtime patterns look milder.
    samples = data_mod.make_swing_batch(
        train_cfg.batch_size, frames_per_clip, seed=train_cfg.seed + step,
        fault_prob=0.5, sev_range=(0.3, 1.0))
    if step % 2:
        return samples, None
    refs = data_mod.make_swing_batch(
        train_cfg.batch_size, frames_per_clip,
        seed=train_cfg.seed + 100_000 + step, fault_prob=0.0)
    return samples, refs


def train_error(
    error_cfg: cfg_mod.ErrorConfig,
    train_cfg: cfg_mod.TrainConfig,
    frames_per_clip: int = 64,
    log_every: int = 20,
    resume_from: str | None = None,
    checkpoint_tag: str | None = None,
    device="cuda",
):
    device = resolve_device(device)
    model = _new_model(ErrorClassifier, error_cfg, train_cfg, device)

    def batch_fn(step):
        return build_error_batch(*error_samples(train_cfg, frames_per_clip, step),
                                 device=device)

    return _run_training(model, error_loss, batch_fn, train_cfg, log_every,
                         aux_keys=("acc",), resume_from=resume_from,
                         checkpoint_tag=checkpoint_tag)
