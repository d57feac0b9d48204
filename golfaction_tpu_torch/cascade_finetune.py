"""Cascade fine-tuning: adapt the skeleton models to the pipeline's own
predictions, then calibrate the per-fault thresholds.

The GCN and the error head are first trained on ground-truth skeletons; at
run time they read keypoints that the pose front predicts from estimated
person boxes, a shifted distribution.  This closes the gap:

  1. Render held-out clips and run the real pose front on them (C++ motion
     boxes -> crop (kernel A) -> PoseNet -> tracked decode) to collect
     predicted keypoints and the heatmap aux block; measure the residual
     noise model, and draw a larger pool of noise-matched synthetic clips.
  1b. Optionally train the keypoint refiner on (predicted, true) pairs.
  2. Fine-tune the GCN on (predicted skeletons, true phase labels).
  3. Train the error head on the run-time inputs: predicted keypoints, the
     fine-tuned GCN's logits, true fault flags; half of every batch fresh
     synthetic pairs with the measured attenuation, flicker and noise.
  4. Calibrate per-fault thresholds through `analyze` (both modes).
  5. Write a new artifacts tree at `--out` (never into `--artifacts`).

The arguments, seeds and the order of every numpy draw are those of the JAX
package's `scripts/cascade_finetune.py`, so both produce the same batches.
Each model trains at its config's dtype (bfloat16 as shipped) through its
plain module chain with dropout 0, under AdamW with optax's
hyper-parameters (betas 0.9 / 0.999, eps 1e-8, weight decay 1e-4 on every
parameter), a constant learning rate and no clipping.  As in the JAX script,
the error head trains on the GCN's training-chain logits at `gcn.dtype`,
where `analyze` feeds it the float32 inference logits (kernel B).

    python -m golfaction_tpu_torch.cascade_finetune --artifacts artifacts --out <dir>
        [--device cpu] [--set pose.dtype=float32 ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.calibrate_thresholds import calibration_probs
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN, normalize_skeleton
from golfaction_tpu_torch.models.refine import KeypointRefiner
from golfaction_tpu_torch.pipeline import video_io
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline, init_params, resolve_device
from golfaction_tpu_torch.train import data, losses, metrics

#: The arrays of a collection (the JAX script's collect-cache keys).
COLLECTION_KEYS = ("pred_kpts", "pred_aux", "labels", "flags", "gt_keypoints", "gt_progress",
                   "gt_fault_defl")
#: The fields of a collection's fingerprint.
FINGERPRINT_KEYS = ("spread_features", "mode_features", "clips", "frames", "hw",
                    "pose_sha256", "refine_sha256", "pose_meta")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def adamw(params, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr, weight_decay=1e-4): decay on every parameter, a
    constant learning rate."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def _step(model, opt, loss_fn: Callable, batch) -> tuple[torch.Tensor, dict]:
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn(model, batch)
    loss.backward()
    opt.step()
    return loss.detach(), aux


def _logged(i: int, n: int, parts: int) -> bool:
    return i % max(n // parts, 1) == 0 or i == n - 1


# ---------------------------------------------------------------------------
# 1. The collection and the measured noise model
# ---------------------------------------------------------------------------

@torch.inference_mode()
def collect(pipe: Pipeline, samples, use_aux: bool) -> dict:
    """Each rendered clip through the pose front, one clip at a time: its
    C++ motion boxes, then `pipe._pose_fn`.  Returns the collection
    {pred_kpts [N, T, V, 3], pred_aux [N, T, V, 4] (None without aux),
    labels, flags, gt_keypoints, gt_progress, gt_fault_defl}."""
    kpts, aux = [], []
    for s in samples:
        boxes = video_io.estimate_person_boxes(s.frames)
        k, a = pipe._pose_fn(pipe._to_device([s.frames]), pipe._to_device([boxes]))
        kpts.append(k[0].float().cpu().numpy())
        if use_aux:
            aux.append(a[0].float().cpu().numpy())
    return {"pred_kpts": np.stack(kpts), "pred_aux": np.stack(aux) if use_aux else None,
            "labels": np.stack([s.phase_labels for s in samples]),
            "flags": np.stack([s.error_flags for s in samples]),
            "gt_keypoints": np.stack([s.keypoints for s in samples]),
            "gt_progress": np.stack([s.progress for s in samples]),
            "gt_fault_defl": np.stack([s.fault_defl for s in samples])}


def as_collection(col: dict) -> dict:
    """A collection with every entry a numpy array, the aux None when it has
    none (the JAX script's pickle keeps lists, and [] for no aux)."""
    out = {}
    for k in COLLECTION_KEYS:
        v = col.get(k)
        if isinstance(v, (list, tuple)):
            v = np.stack(v) if len(v) else None
        out[k] = v
    return out


def collection_samples(col: dict) -> list:
    """The rendered clips' ground truth (frames dropped) from a collection."""
    return [data.SwingSample(keypoints=k, phase_labels=lb, error_flags=fl, progress=pr,
                             fault_defl=fd)
            for k, lb, fl, pr, fd in zip(col["gt_keypoints"], col["labels"], col["flags"],
                                         col["gt_progress"], col["gt_fault_defl"])]


def _sha256(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fingerprint(cfg, artifacts: str, clips: int, frames: int, hw) -> dict:
    """What a collection depends on: the aux variant, the counts and size,
    the pose (and refiner) checkpoint's bytes and pose_meta.json."""
    pdir = checkpoint._params_dir(artifacts)
    meta = os.path.join(artifacts, "pose_meta.json")
    return {"spread_features": bool(cfg.error.spread_features),
            "mode_features": bool(cfg.error.mode_features),
            "clips": int(clips), "frames": int(frames), "hw": [int(v) for v in hw],
            "pose_sha256": _sha256(os.path.join(pdir, "pose.npz")),
            "refine_sha256": _sha256(os.path.join(pdir, "refine.npz")),
            "pose_meta": _read(meta)}


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def save_collection(path: str, col: dict, fp: dict) -> None:
    arrays = {k: col[k] for k in COLLECTION_KEYS if col[k] is not None}
    with open(path, "wb") as f:
        np.savez(f, fingerprint=np.array(json.dumps(fp)), **arrays)


def load_collection(path: str, fp: dict, use_aux: bool) -> dict:
    """A cache written by save_collection, checked against this run's
    fingerprint: ValueError naming the missing aux block or every field
    that differs."""
    with np.load(path, allow_pickle=False) as z:
        col = {k: (z[k] if k in z.files else None) for k in COLLECTION_KEYS}
        have = json.loads(str(z["fingerprint"])) if "fingerprint" in z.files else {}
    if use_aux and col["pred_aux"] is None:
        raise ValueError(f"collect cache {path}: it holds no pred_aux (heatmap aux block), and "
                         "this run's error head reads one (spread_features="
                         f"{fp['spread_features']}, mode_features={fp['mode_features']}); "
                         "delete the cache or name another")
    bad = [k for k in FINGERPRINT_KEYS if have.get(k) != fp[k]]
    if bad:
        raise ValueError(f"collect cache {path} was made for another run: "
                         + "; ".join(f"{k}: cache {have.get(k)!r}, this run {fp[k]!r}"
                                     for k in bad))
    return col


@dataclasses.dataclass
class NoiseModel:
    """The pose front's residual: robust scale `sigma`, per-joint scale
    `sigma_v` [1, 1, V, 1] and lag-1 autocorrelation `rho`."""

    sigma: float
    sigma_v: np.ndarray
    rho: float

    @property
    def innov(self) -> float:
        return float(np.sqrt(1 - self.rho ** 2))


def noise_model(pred: np.ndarray, gt: np.ndarray) -> NoiseModel:
    """Residual scale and temporal correlation of predicted keypoints
    [N, T, V, 3] against the truth: the synthetic clips must match both, or
    the angular-velocity features blow i.i.d. noise up into a signal."""
    resid = pred[..., :2] - gt[..., :2]
    sigma = float(np.median(np.abs(resid))) * 1.4826   # robust std estimate
    sigma_v = np.median(np.abs(resid), axis=(0, 1, 3)) * 1.4826  # [V]
    sigma_v = np.maximum(sigma_v, 0.25 * sigma)[None, None, :, None]
    r0 = resid - resid.mean(axis=1, keepdims=True)
    rho = float(np.clip(
        (r0[:, 1:] * r0[:, :-1]).sum() / max((r0 ** 2).sum(), 1e-9), 0.0, 0.99))
    return NoiseModel(sigma, sigma_v, rho)


def mode_floor(aux: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """The real runner-up modes' noise floor from aux [N, T, V, 4]: the miss
    rate, and per joint the median mass ratio and separation where a mode
    exists (0.1 and 4 px where none does)."""
    present = aux[..., 3] > 0                          # [N, T, V]
    miss = float(np.clip(1.0 - present.mean(), 0.0, 0.9))
    V = aux.shape[2]
    rel = np.empty(V, np.float32)
    sep = np.empty(V, np.float32)
    for j in range(V):
        m = present[..., j]
        rel[j] = float(np.median(aux[..., j, 2][m])) if m.any() else 0.1
        sep[j] = float(np.median(aux[..., j, 3][m])) if m.any() else 4.0
    return miss, rel, sep


def blur_excess(aux: np.ndarray) -> np.ndarray:
    """Per-joint median isotropic excess variance (px²) of the real heatmap
    spread aux [N, T, V, 4] (motion blur widens blobs even on clean joints)."""
    iso = np.maximum(0.5 * (aux[..., 0] + aux[..., 2]) - aux[..., 3], 0.0)
    return np.median(iso, axis=(0, 1)).astype(np.float32)


def ar1_noise(rng: np.random.Generator, shape, rho: float, innov: float) -> np.ndarray:
    """AR(1) noise float32 [N, T, ...]: unit normal at t = 0, then
    rho * previous + N(0, innov)."""
    nz = np.empty(shape, np.float32)
    nz[:, 0] = rng.normal(0, 1.0, nz[:, 0].shape)
    for tt in range(1, shape[1]):
        nz[:, tt] = rho * nz[:, tt - 1] + rng.normal(0, innov, nz[:, 0].shape)
    return nz


def aug_pool(n: int, T: int, hw, noise: NoiseModel, rng_aug: np.random.Generator):
    """`n` noise-matched synthetic clips (seed 560_000): the generator's
    keypoints plus AR(1) noise at the measured per-joint scale.  Returns the
    samples and their noisy keypoints [n, T, V, 3]."""
    aug = data.make_swing_batch(n, T, seed=560_000, image_hw=tuple(hw), fault_prob=0.5,
                                sev_range=(0.3, 1.0))
    aug_k = np.stack([s.keypoints for s in aug])
    aug_k[..., :2] += ar1_noise(rng_aug, (len(aug), T, aug_k.shape[2], 2), noise.rho,
                                noise.innov) * noise.sigma_v
    return aug, aug_k


def pool_aux(aug_k: np.ndarray, pose_cfg, hw, rng_aug, use_spread: bool,
             blur_iso=None, clean_rel=None, clean_sep=None, mode_miss: float = 0.15):
    """The synthetic pool's aux block: the pool carries full (unattenuated)
    deflections, so its blobs are the floor plus the blur excess (spread)
    and its runner-up modes the noise floor (modes)."""
    if use_spread:
        return data.synth_spread(aug_k, pose_cfg, tuple(hw), rng_aug, blur_iso=blur_iso)
    return data.synth_modes(aug_k, rng_aug, clean_rel=clean_rel, clean_sep=clean_sep,
                            miss_prob=mode_miss)


# ---------------------------------------------------------------------------
# 1b. The keypoint refiner
# ---------------------------------------------------------------------------

def _pairs(i: int, j: int, n_seed: int, b_seed: int, T: int, hw, fault_p: float):
    """One (faulty, clean) synthetic pair sharing style, tempo and placement
    (swing_keypoints draws nothing inside its fault branches), and the
    pair's own generator, from the step's seeds."""
    rd = np.random.default_rng(n_seed + j)
    faults = {}
    if rd.uniform() < fault_p:
        kk = rd.integers(1, 3)
        for name in rd.choice(cfg_mod.SWING_ERRORS, size=kk, replace=False):
            faults[str(name)] = float(rd.uniform(0.3, 1.0))
    tempo = float(rd.uniform(-0.8, 0.8))
    seed_b = b_seed + j
    sf = data.swing_keypoints(T, np.random.default_rng(seed_b), tempo_warp=tempo, faults=faults)
    sc = data.swing_keypoints(T, np.random.default_rng(seed_b), tempo_warp=tempo)
    sf = data.place_in_image(sf, tuple(hw), person_height_px=0.65 * hw[0],
                             rng=np.random.default_rng(seed_b + 1))
    sc = data.place_in_image(sc, tuple(hw), person_height_px=0.65 * hw[0],
                             rng=np.random.default_rng(seed_b + 1))
    return sf, sc, rd


@dataclasses.dataclass
class RefineStream:
    """What the refiner's batches are drawn from: the rendered clips'
    predictions and truth, the noise model and its generator (seed 77)."""

    pred_kpts: np.ndarray             # [R, T, V, 3] the pose front's
    gt: np.ndarray                    # [R, T, V, 3]
    defl: np.ndarray                  # [R, T, V] fault deflection (px)
    noise: NoiseModel
    rng: np.random.Generator
    half: int
    hw: tuple
    fault_weight: float = 3.0

    def weights(self, defl: np.ndarray) -> np.ndarray:
        return 1.0 + self.fault_weight * np.minimum(defl / 15.0, 2.0) / 2.0


def refine_batch(i: int, st: RefineStream):
    """Step i's refiner batch (numpy): half real (predicted, true) pairs
    from the rendered clips, half fresh synthetic attenuated pairs (input =
    clean + (faulty - clean) * g + AR(1) noise, its score lowered where the
    deflection was attenuated; target = faulty).  -> (inp, tgt, w, v)."""
    T = st.gt.shape[1]
    idx = st.rng.choice(len(st.gt), size=st.half, replace=False)
    inp_r, tgt_r, w_r = st.pred_kpts[idx], st.gt[idx], st.weights(st.defl[idx])
    inp_s, tgt_s, w_s = [], [], []
    for j in range(st.half):
        sf, sc, rd = _pairs(i, j, 700_000 + i * 97, 710_000 + i * 97, T, st.hw, 0.7)
        g = rd.uniform(0.35, 1.0, (1, 17, 1))
        inp1 = sc.keypoints + (sf.keypoints - sc.keypoints) * g
        nz1 = np.empty((T, 17, 2), np.float32)
        nz1[0] = rd.normal(0, 1.0, (17, 2))
        for tt in range(1, T):
            nz1[tt] = st.noise.rho * nz1[tt - 1] + rd.normal(0, st.noise.innov, (17, 2))
        inp1 = inp1.copy()
        inp1[..., :2] += nz1 * st.noise.sigma_v[0]
        # The decoder scores an attenuated joint low: the refiner's cue.
        defl_on = (np.abs(sf.keypoints[..., :2] - sc.keypoints[..., :2]).sum(-1, keepdims=True)
                   > 1e-6)
        score = 1.0 - 0.6 * (1.0 - g) * defl_on + rd.normal(0, 0.05, (T, 17, 1))
        inp1[..., 2:] = np.clip(score, 0.05, 1.0)
        inp_s.append(inp1)
        tgt_s.append(sf.keypoints)
        w_s.append(st.weights(sf.fault_defl))
    inp = np.concatenate([inp_r, np.stack(inp_s)]).astype(np.float32)
    tgt = np.concatenate([tgt_r, np.stack(tgt_s)]).astype(np.float32)
    w = np.concatenate([w_r, np.stack(w_s)]).astype(np.float32)
    return inp, tgt, w, np.ones(inp.shape[:2], bool)


def new_refiner(refine_cfg) -> dict:
    """A new refiner's state (seed 7): random trunk, zero head (the identity)."""
    m = KeypointRefiner(refine_cfg)
    weights.init_random(m, torch.Generator().manual_seed(7))
    torch.nn.init.zeros_(m.head.weight)
    return m.state_dict()


def refine_loss(model, batch, scale_px: float):
    """Per-joint-weighted squared error of the refined keypoints over the
    torso-ish scale `scale_px`, over the weighted valid joint-frames."""
    inp, tgt, w, v = batch
    out = model(inp, v)
    err = ((out[..., :2] - tgt[..., :2]) / scale_px) ** 2
    wv = w * v[..., None]
    return (err.sum(-1) * wv).sum() / wv.sum().clamp(min=1.0), {}


def train_refiner(refine_cfg, state: dict, st: RefineStream, steps: int, device,
                  log=_log) -> tuple[dict, list]:
    """`steps` AdamW steps (lr 1e-3) of the refiner from `state` on
    refine_batch(0..steps-1), refine_loss over 0.65 H / 2.  Returns the
    state and the losses."""
    model = KeypointRefiner(refine_cfg)
    model.load_state_dict(state)
    model.to(device).train()
    opt = adamw(model.parameters(), 1e-3)
    scale_px = 0.65 * st.hw[0] / 2.0
    hist = []
    for i in range(steps):
        batch = tuple(torch.from_numpy(a).to(device) for a in refine_batch(i, st))
        loss, _ = _step(model, opt, lambda m, b: refine_loss(m, b, scale_px), batch)
        hist.append(float(loss))
        if _logged(i, steps, 5):
            log(f"[refine-cascade] step {i} loss {hist[-1]:.5f}")
    model.eval()
    return model.state_dict(), hist


def refiner_fn(refine_cfg, state: dict, device) -> Callable:
    """kpts [N, T, V, 3] float32 (numpy or tensor) -> the refined keypoints
    (the same kind), every frame valid."""
    model = KeypointRefiner(refine_cfg)
    model.load_state_dict(state)
    model.to(device).eval()

    @torch.no_grad()
    def apply(k):
        t = torch.from_numpy(np.asarray(k, np.float32)).to(device) if isinstance(
            k, np.ndarray) else k
        out = model(t, torch.ones(t.shape[:2], dtype=torch.bool, device=t.device))
        return out.cpu().numpy() if isinstance(k, np.ndarray) else out

    return apply


# ---------------------------------------------------------------------------
# 2. The GCN on predicted skeletons
# ---------------------------------------------------------------------------

def chain_gcn(gcn_cfg, state: dict, device) -> ActionSegmentationGCN:
    """The GCN in its training chain (plain modules at gcn.dtype), dropout
    0: the flax chain the JAX script trains and reads logits from."""
    model = ActionSegmentationGCN(dataclasses.replace(gcn_cfg, dropout=0.0))
    model.load_state_dict(state)
    return model.to(device).train()


@torch.no_grad()
def chain_logits(model: ActionSegmentationGCN, sk: torch.Tensor, valid: torch.Tensor):
    return model(sk, valid)


def gcn_loss(model, batch):
    """Label-smoothed (0.05) per-frame cross entropy, and the accuracy."""
    s, lb, v = batch
    logits = model(s, v)
    loss = losses.phase_cross_entropy(logits, lb, v, label_smoothing=0.05)
    return loss, {"acc": (logits.argmax(-1) == lb).float().mean()}


def finetune_gcn(gcn_cfg, state: dict, sk, labels, valid, steps: int, batch_size: int,
                 lr: float, rng: np.random.Generator, log=_log) -> tuple[dict, list]:
    """`steps` AdamW steps of the GCN from `state` on batches of the pool
    (normalized skeletons `sk` [N, T, V, 3], `labels`, `valid` on the
    device) drawn by `rng` (seed 0): label-smoothed per-frame cross
    entropy.  Returns the state and the losses."""
    model = chain_gcn(gcn_cfg, state, sk.device)
    opt = adamw(model.parameters(), lr)
    N = sk.shape[0]
    hist = []
    for i in range(steps):
        idx = torch.from_numpy(rng.choice(N, size=min(batch_size, N), replace=False)).to(
            sk.device)
        loss, aux = _step(model, opt, gcn_loss, (sk[idx], labels[idx], valid[idx]))
        hist.append(float(loss))
        if _logged(i, steps, 5):
            log(f"[gcn-cascade] step {i} loss {hist[-1]:.4f} acc {float(aux['acc']):.4f}")
    return model.state_dict(), hist


# ---------------------------------------------------------------------------
# 3. The error head on run-time inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ErrorStream:
    """What the error head's batches are drawn from.  The pool tensors (on
    the device) hold the rendered clips first, then the synthetic ones."""

    kpts: torch.Tensor                 # [N, T, V, 3] raw keypoints
    logits: torch.Tensor               # [N, T, P] the fine-tuned GCN's
    flags: torch.Tensor                # [N, E]
    valid: torch.Tensor                # [N, T]
    ref_warp: torch.Tensor             # [N, T, V, 3] warped noisy references
    aux: Optional[torch.Tensor]        # [N, T, V, 4] or None
    n_rendered: int
    gcn: ActionSegmentationGCN         # the fine-tuned GCN, training chain
    refs: list                         # clean reference swings (seed 570_000)
    noise: NoiseModel
    rng: np.random.Generator           # pool indices (seed 0, after the GCN's)
    rng_aug: np.random.Generator       # synthesis (seed 123)
    half: int
    hw: tuple
    pose_cfg: cfg_mod.PoseConfig
    use_spread: bool = False
    use_modes: bool = False
    gain_tab: Optional[np.ndarray] = None
    beta_tab: Optional[np.ndarray] = None
    pres_tab: Optional[np.ndarray] = None
    canon_tab: Optional[np.ndarray] = None
    blur_iso: Optional[np.ndarray] = None
    clean_rel: Optional[np.ndarray] = None
    clean_sep: Optional[np.ndarray] = None
    mode_miss: float = 0.15
    pool_rendered_frac: float = 0.0
    refine: Optional[Callable] = None


def fresh_pairs(i: int, half: int, T: int, hw):
    """Step i's `half` fresh (faulty, clean) pairs: the faulty samples and
    both keypoint stacks [half, T, V, 3]."""
    fresh, fks, cks = [], [], []
    for j in range(half):
        sf, sc, _ = _pairs(i, j, 600_000 + i * 131, 610_000 + i * 131, T, hw, 0.5)
        fresh.append(sf)
        fks.append(sf.keypoints)
        cks.append(sc.keypoints)
    return fresh, np.stack(fks), np.stack(cks)


def error_batch(i: int, st: ErrorStream):
    """Step i's error-head batch -> (kpts, phase logits, flags, valid,
    ref_warp or None, aux or None) on the device.  Half fresh synthetic
    clips: each faulty clip blended toward its clean counterpart with a
    per-joint gain conditioned on the measured profile, with modes the
    bimodal flicker of the measured presence, AR(1) noise, the aux block
    consistent with both, [the refiner]; logits from the fine-tuned GCN.
    Half pool clips (a `pool_rendered_frac` share from the rendered ones).
    Even steps carry noisy reference warps (compare mode), odd ones none."""
    T = st.kpts.shape[1]
    dev = st.kpts.device
    fresh, fk, ck = fresh_pairs(i, st.half, T, st.hw)
    g = np.stack([data.conditioned_gain(st.rng_aug, st.gain_tab, s.error_flags)
                  for s in fresh])[:, None, :, None]
    dfl = (fk - ck)[..., :2]           # full-strength deflection
    fk = ck + (fk - ck) * g
    present = side = None
    if st.use_modes:
        # Bimodal flicker where the probe measured a hidden mode: the
        # selected keypoint sits at the canonical or the true mode, the
        # runner-up at the other, full ±d apart.
        pp_m = np.stack([data.conditioned_presence(st.pres_tab, s.error_flags)
                         for s in fresh])[:, None, :]
        cc_m = np.stack([data.conditioned_presence(st.canon_tab, s.error_flags, default=1.0)
                         for s in fresh])[:, None, :]
        present = st.rng_aug.uniform(size=fk.shape[:3]) < pp_m
        side = st.rng_aug.uniform(size=fk.shape[:3]) < cc_m
        flick_xy = ck[..., :2] + np.where((present & ~side)[..., None], dfl, 0.0)
        fk[..., :2] = np.where(present[..., None], flick_xy, fk[..., :2])
    fk[..., :2] += ar1_noise(st.rng_aug, (st.half, T, fk.shape[2], 2), st.noise.rho,
                             st.noise.innov) * st.noise.sigma_v
    sp_f = None
    if st.use_spread:
        bb = np.stack([data.conditioned_beta(st.beta_tab, s.error_flags)
                       for s in fresh])[:, None, :, None]
        sp_f = data.synth_spread(fk, st.pose_cfg, tuple(st.hw), st.rng_aug, defl_vec=dfl,
                                 gain=g, blur_iso=st.blur_iso, beta=bb)
    elif st.use_modes:
        sp_f = data.synth_modes(fk, st.rng_aug, defl_vec=dfl, clean_rel=st.clean_rel,
                                clean_sep=st.clean_sep, miss_prob=st.mode_miss,
                                present_mask=present, side_canon=side)
    fk_t = torch.from_numpy(fk.astype(np.float32)).to(dev)
    v_f = torch.ones((st.half, T), dtype=torch.bool, device=dev)
    if st.refine is not None:          # the head sees refined keypoints at run time
        fk_t = st.refine(fk_t)
    sk_f = normalize_skeleton(fk_t, v_f)
    fl_f = torch.from_numpy(np.stack([s.error_flags for s in fresh])).to(dev)
    N = st.kpts.shape[0]
    if st.pool_rendered_frac > 0:
        nr = min(int(round(st.half * st.pool_rendered_frac)), st.n_rendered)
        i_r = st.rng.choice(st.n_rendered, size=nr, replace=False)
        i_s = st.rng.choice(np.arange(st.n_rendered, N), size=st.half - nr, replace=False)
        idx = np.concatenate([i_r, i_s])
    else:
        idx = st.rng.choice(N, size=st.half, replace=False)
    idx = torch.from_numpy(idx).to(dev)
    sp_all = None
    if st.aux is not None:
        sp_all = torch.cat([torch.from_numpy(sp_f).to(dev), st.aux[idx]])
    k_all = torch.cat([fk_t, st.kpts[idx]])
    v_all = torch.cat([v_f, st.valid[idx]])
    pl_all = torch.cat([chain_logits(st.gcn, sk_f, v_f), st.logits[idx]])
    fl_all = torch.cat([fl_f, st.flags[idx]])
    rw = None
    if i % 2 == 0:
        rw_f = np.stack([data.progress_align_reference(s, st.refs[j % len(st.refs)])
                         for j, s in enumerate(fresh)])
        rw_f[..., :2] += st.rng_aug.normal(0, st.noise.sigma, rw_f[..., :2].shape)
        rw = torch.cat([torch.from_numpy(rw_f).to(dev), st.ref_warp[idx]])
    return k_all, pl_all, fl_all, v_all, rw, sp_all


def error_loss(model, batch, fault_weights=None):
    """(Fault-weighted) BCE of the error head, and the flag accuracy."""
    s, pl, f, v, rw, sp = batch
    logits = model(s, pl, v, rw, sp)
    loss = losses.error_bce(logits, f, fault_weights=fault_weights)
    return loss, {"acc": ((torch.sigmoid(logits) > 0.5).float() == f).float().mean()}


def train_error_head(error_cfg, state: dict, st: ErrorStream, steps: int, lr: float,
                     fault_weights=None, log=_log) -> tuple[dict, list]:
    """`steps` AdamW steps of the error head from `state` on
    error_batch(0..steps-1): (fault-weighted) BCE.  Returns the state and
    the losses."""
    model = ErrorClassifier(error_cfg)
    model.load_state_dict(state)
    model.to(st.kpts.device).train()
    opt = adamw(model.parameters(), lr)
    hist = []
    for i in range(steps):
        loss, aux = _step(model, opt, lambda m, b: error_loss(m, b, fault_weights),
                          error_batch(i, st))
        hist.append(float(loss))
        if _logged(i, steps, 6):
            log(f"[error-cascade] step {i} loss {hist[-1]:.4f} acc {float(aux['acc']):.4f}")
    model.eval()
    return model.state_dict(), hist


# ---------------------------------------------------------------------------
# The whole cascade
# ---------------------------------------------------------------------------

def train_stages(args, cfg, params: dict, collection: dict, device, lap, log=_log):
    """Stages 1-3 after the collection: the noise model and synthetic pool,
    the refiner (trained, or the tree's own applied), the GCN, the error
    head, from `params` ({name: state_dict}) on `device`.  `lap(name, t0)`
    books the seconds since t0 to a stage and returns the time.  Returns the
    new params, the losses by stage and the pool's clip count."""
    T, hw = args.frames, tuple(args.hw)
    params = dict(params)
    use_spread, use_modes = cfg.error.spread_features, cfg.error.mode_features
    use_aux = use_spread or use_modes
    t0 = time.perf_counter()
    samples = collection_samples(collection)
    pred_kpts, pred_aux = collection["pred_kpts"], collection["pred_aux"]
    labels, flags = collection["labels"], collection["flags"]

    blur_iso = clean_rel = clean_sep = None
    mode_miss = 0.15
    if use_modes:
        mode_miss, clean_rel, clean_sep = mode_floor(pred_aux)
        log(f"[modes] measured runner-up floor: miss {mode_miss:.2f}, rel med elbows "
            f"{clean_rel[7]:.2f}/{clean_rel[8]:.2f}, sep med elbows "
            f"{clean_sep[7]:.0f}/{clean_sep[8]:.0f} px")
    if use_spread:
        blur_iso = blur_excess(pred_aux)
        log(f"[spread] measured blur excess (median px²): elbows {blur_iso[7]:.0f}/"
            f"{blur_iso[8]:.0f} wrists {blur_iso[9]:.0f}/{blur_iso[10]:.0f}")
    gt = collection["gt_keypoints"]
    noise = noise_model(pred_kpts, gt)
    log(f"pose residual sigma {noise.sigma:.2f} px, lag-1 rho {noise.rho:.2f}; generating "
        f"{args.aug} noise-matched synthetic clips")
    rng_aug = np.random.default_rng(123)
    aug, aug_k = aug_pool(args.aug, T, hw, noise, rng_aug)
    refs = data.make_swing_batch(8, T, seed=570_000, image_hw=hw, fault_prob=0.0)
    t0 = lap("render", t0)

    # ---- 1b. The keypoint refiner (trained, or the tree's own) ----
    refine = None
    losses_by_stage: dict = {}
    if args.refine_steps == 0 and "refine" in params:
        log("[refine] applying the tree's refiner to the cascade inputs")
        refine = refiner_fn(cfg.refine, params["refine"], device)
    if args.refine_steps > 0:
        st = RefineStream(pred_kpts=pred_kpts, gt=gt, defl=collection["gt_fault_defl"],
                          noise=noise, rng=np.random.default_rng(77),
                          half=max(min(args.batch_size // 2, len(samples)), 1), hw=hw,
                          fault_weight=args.refine_fault_weight)
        log(f"[refine] training {args.refine_steps} steps ...")
        params["refine"], losses_by_stage["refine"] = train_refiner(
            cfg.refine, new_refiner(cfg.refine), st, args.refine_steps, device, log)
        refine = refiner_fn(cfg.refine, params["refine"], device)
    if refine is not None:
        pred_kpts, aug_k = refine(pred_kpts), refine(aug_k)
    t0 = lap("refine", t0)

    pool_aux_np = None
    if use_aux:
        pool_aux_np = np.concatenate([pred_aux, pool_aux(
            aug_k, cfg.pose, hw, rng_aug, use_spread, blur_iso, clean_rel, clean_sep, mode_miss)])
    kpts = torch.from_numpy(np.concatenate([pred_kpts, aug_k]).astype(np.float32)).to(device)
    lab = torch.from_numpy(np.concatenate([labels, np.stack([s.phase_labels for s in aug])])
                           ).long().to(device)
    flg = torch.from_numpy(np.concatenate([flags, np.stack([s.error_flags for s in aug])])
                           ).to(device)
    valid = torch.ones(lab.shape, dtype=torch.bool, device=device)
    sk = normalize_skeleton(kpts, valid)
    N = sk.shape[0]
    log(f"total training clips (rendered + synthetic): {N}")
    rng = np.random.default_rng(0)

    # ---- 2. Fine-tune the GCN on predicted skeletons ----
    params["gcn"], losses_by_stage["gcn"] = finetune_gcn(
        cfg.gcn, params["gcn"], sk, lab, valid, args.steps, args.batch_size, args.lr, rng, log)
    t0 = lap("gcn", t0)

    # ---- 3. The error head on run-time inputs ----
    gcn = chain_gcn(cfg.gcn, params["gcn"], device)
    ref_np = np.stack([data.progress_align_reference(s, refs[i % len(refs)])
                       for i, s in enumerate(list(samples) + list(aug))])
    ref_np[..., :2] += rng_aug.normal(0, noise.sigma, ref_np[..., :2].shape)
    fw = fault_weights(args.fault_weight)
    if fw is not None:
        log(f"[error-cascade] per-fault loss weights: {fw.tolist()}")
    estate = params["error"]
    if use_aux:
        fresh = ErrorClassifier(cfg.error)
        weights.init_random(fresh, torch.Generator().manual_seed(11))
        fresh = fresh.state_dict()
        if (estate.keys() != fresh.keys()
                or any(estate[k].shape != fresh[k].shape for k in fresh)):
            log("[error-cascade] feature width changed (aux features): a new error head")
            estate = fresh
    prof_path = args.gain_profile or os.path.join(args.artifacts, "probe_arm_gain.json")
    gain_tab = data.load_gain_profile(prof_path)
    if gain_tab is not None:
        log(f"attenuation sampling conditioned on {prof_path} "
            f"({int(np.isfinite(gain_tab).sum())} fault-joint gains)")
    beta_tab = pres_tab = canon_tab = None
    if use_spread:
        beta_tab = data.load_spread_profile(os.path.join(args.artifacts,
                                                         "probe_heatmap_spread.json"))
    if use_modes:
        pres_path = os.path.join(args.artifacts, "probe_heatmap_modes.json")
        prof = data.load_mode_profile(pres_path)
        if prof is not None:
            pres_tab, canon_tab = prof
            log(f"synthetic hidden modes gated by the measured presence of {pres_path} "
                f"({int(np.isfinite(pres_tab).sum())} fault-joint fractions)")
        else:
            log(f"WARNING: no {pres_path}: the synthetic clips get no hidden modes and no "
                "keypoint flicker, only the measured runner-up noise floor")
    st = ErrorStream(
        kpts=kpts, logits=chain_logits(gcn, sk, valid), flags=flg, valid=valid,
        ref_warp=torch.from_numpy(ref_np).to(device),
        aux=None if pool_aux_np is None else torch.from_numpy(pool_aux_np).to(device),
        n_rendered=len(samples), gcn=gcn, refs=refs, noise=noise, rng=rng, rng_aug=rng_aug,
        half=max(args.batch_size // 2, 1), hw=hw, pose_cfg=cfg.pose, use_spread=use_spread,
        use_modes=use_modes, gain_tab=gain_tab, beta_tab=beta_tab, pres_tab=pres_tab,
        canon_tab=canon_tab, blur_iso=blur_iso, clean_rel=clean_rel, clean_sep=clean_sep,
        mode_miss=mode_miss, pool_rendered_frac=args.pool_rendered_frac, refine=refine)
    params["error"], losses_by_stage["error"] = train_error_head(
        cfg.error, estate, st, args.error_steps or args.steps * 2, args.error_lr or args.lr,
        fw, log)
    del gcn, st
    t0 = lap("error", t0)

    return params, losses_by_stage, N


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--out", required=True,
                    help="folder of the new artifacts tree (not --artifacts, not artifacts/)")
    ap.add_argument("--clips", type=int, default=48)
    ap.add_argument("--aug", type=int, default=256,
                    help="extra noise-matched synthetic (unrendered) clips")
    ap.add_argument("--calib-clips", type=int, default=16,
                    help="positive clips per fault in the threshold calibration")
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hw", type=int, nargs=2, default=(540, 960))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. --set gcn.dtype=float32 (repeatable)")
    ap.add_argument("--refine-steps", type=int, default=0,
                    help="train the keypoint refiner on (predicted, true) pairs for this "
                         "many steps (0 = off); the later stages then read refined keypoints")
    ap.add_argument("--refine-fault-weight", type=float, default=3.0,
                    help="refiner loss weight of fault-displaced joints and frames")
    ap.add_argument("--pool-rendered-frac", type=float, default=0.0,
                    help="share of the pool half-batch drawn from the rendered clips "
                         "instead of uniformly over rendered and synthetic")
    ap.add_argument("--spread", action="store_true",
                    help="train the error head with heatmap-spread features (a new head)")
    ap.add_argument("--modes", action="store_true",
                    help="train the error head with secondary-mode features (a new head; "
                         "forces pose.decode_tracking >= 2)")
    ap.add_argument("--collect-cache", default=None,
                    help=".npz of the rendered clips' collection: written after a fresh "
                         "collection, read (and its fingerprint checked) when it exists")
    ap.add_argument("--fault-weight", action="append", default=[], metavar="NAME=W",
                    help="per-fault BCE weight of the error cascade (repeatable)")
    ap.add_argument("--error-steps", type=int, default=None,
                    help="error-head steps (default 2 * --steps)")
    ap.add_argument("--error-lr", type=float, default=None,
                    help="error-head learning rate (default --lr)")
    ap.add_argument("--gain-profile", default=None,
                    help="probe_arm_gain.json conditioning the synthetic attenuation "
                         "(default <artifacts>/probe_arm_gain.json when present)")
    return ap.parse_args(argv)


def cascade_config(args):
    """The full_pipeline preset at the run's size, adapted to the tree, with
    --spread / --modes applied."""
    hw = tuple(args.hw)
    cfg = cfg_mod.apply_overrides(cfg_mod.get_config("full_pipeline"),
                                  [f"video_hw={hw}", f"length_buckets=({args.frames},)",
                                   *args.set])
    cfg = checkpoint.config_for_artifacts(cfg, args.artifacts)
    if args.spread and not cfg.error.spread_features:
        cfg = cfg_mod.apply_overrides(cfg, ["error.spread_features=True"])
    if args.modes:
        ov = []
        if not cfg.error.mode_features:
            ov += ["error.mode_features=True", "error.spread_features=False"]
        if cfg.pose.decode_tracking < 2:
            ov += ["pose.decode_tracking=4", "pose.track_suppress_radius=2.0"]
        if ov:
            cfg = cfg_mod.apply_overrides(cfg, ov)
    return cfg


def fault_weights(specs) -> Optional[np.ndarray]:
    if not specs:
        return None
    fw = np.ones(cfg_mod.NUM_ERRORS, np.float32)
    for spec in specs:
        name, wv = spec.split("=")
        fw[cfg_mod.SWING_ERRORS.index(name)] = float(wv)
    return fw


def main(argv=None, collection: Optional[dict] = None) -> dict:
    """Run the cascade; print the JAX script's last line.  `collection`
    (the arrays of COLLECTION_KEYS) replaces stage 1's render and pose front.
    Returns the paths, the new states, the losses of every stage, the
    calibration's probabilities and thresholds, seconds by stage and the
    collection."""
    args = parse_args(argv)
    checkpoint.refuse_inside(args.out, args.artifacts)
    device = resolve_device("cpu" if args.cpu else args.device)
    log = _log
    seconds: dict = {}

    def lap(name, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    cfg = cascade_config(args)
    T, hw = args.frames, tuple(args.hw)
    params = {**init_params(cfg, 0), **weights.from_flax(checkpoint.load_params(args.artifacts))}
    if args.spread or args.modes:
        # The narrower head of the tree does not fit the widened one: it
        # starts from the seed-0 initialization, as the JAX script's does.
        params["error"] = init_params(cfg, 0)["error"]
    use_aux = cfg.error.spread_features or cfg.error.mode_features

    # ---- 1. Collect predicted keypoints through the real pose front ----
    t0 = time.perf_counter()
    fp = fingerprint(cfg, args.artifacts, args.clips, T, hw)
    if collection is None and args.collect_cache and os.path.exists(args.collect_cache):
        collection = load_collection(args.collect_cache, fp, use_aux)
        log(f"collection loaded from {args.collect_cache} ({len(collection['pred_kpts'])} clips)")
    if collection is None:
        rendered = data.make_swing_batch(args.clips, T, seed=550_000, image_hw=hw, render=True,
                                         fault_prob=0.5,
                                         scene_families=data.TRAIN_SCENE_FAMILIES)
        t0 = lap("render", t0)
        log(f"running the pose front on {args.clips} rendered clips ...")
        collection = collect(Pipeline(cfg, params, device=device), rendered, use_aux)
        t0 = lap("pose_front", t0)
        if args.collect_cache:
            save_collection(args.collect_cache, collection, fp)
            log(f"collection cached to {args.collect_cache}")
    collection = as_collection(collection)
    if len(collection["pred_kpts"]) != args.clips:
        raise ValueError(f"the collection holds {len(collection['pred_kpts'])} clips, "
                         f"--clips is {args.clips}")
    if use_aux and collection["pred_aux"] is None:
        raise ValueError("the collection holds no pred_aux, which this run's error head reads")
    params, losses_by_stage, N = train_stages(args, cfg, params, collection, device, lap, log)

    # ---- 4. Per-fault thresholds through the real pipeline ----
    log(f"calibrating per-fault thresholds (stratified, {args.calib_clips} per fault) ...")
    t0 = time.perf_counter()
    pipe = Pipeline(cfg, params, device=device)
    probs, truth = calibration_probs(pipe, args.calib_clips, T, hw, log)
    thresholds = metrics.calibrate_error_thresholds(probs, truth, log=log)
    t0 = lap("calibration", t0)

    # ---- 5. The new tree ----
    new = {k: params[k] for k in ("gcn", "error", "refine") if k in params
           and (k != "refine" or args.refine_steps > 0)}
    paths = checkpoint.write_artifacts(args.out, args.artifacts, new, thresholds)
    log("stage seconds " + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    line = {"gcn_checkpoint": paths["gcn"], "error_checkpoint": paths["error"],
            "clips": int(N), "thresholds": paths["thresholds"]}
    print(json.dumps(line))
    return {**line, "params": {k: params[k] for k in new}, "losses": losses_by_stage,
            "probs": probs, "truth": truth, "thresholds_values": thresholds,
            "seconds": seconds, "collection": collection}


if __name__ == "__main__":
    main()
