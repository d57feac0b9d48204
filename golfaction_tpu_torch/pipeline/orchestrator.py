"""End-to-end pipeline: video in -> per-frame keypoints, swing-phase labels,
alignment against a reference swing, and swing-fault flags out.

Stages per clip (frames padded to a length bucket, `valid` marks real ones):
[coarse pose pass on every k-th frame from full-frame boxes -> smoothed
keypoint-seeded boxes, when box_refine_stride > 0] -> crop/resize/normalize
(kernel A, once per neighbour offset when pose.in_frames > 1) -> PoseNet ->
heatmap decode (single peak through kernel D, or the tracked top-k decode)
[-> keypoint refiner, when the params carry one] -> skeleton normalize -> GCN
(block tails through kernel B) -> error head.
Compare mode embeds clip and reference, computes the soft-DTW cost and the
hard-DTW path (kernel C), warps the reference onto the clip's timeline and
re-runs the error head with the deviation features.

The pipeline runs on the card unless the caller passes another device; a
CUDA device that is not there raises.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from golfaction_tpu_torch import checkpoint, types, weights
from golfaction_tpu_torch.config import PipelineConfig, get_config
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN, normalize_skeleton
from golfaction_tpu_torch.models.pose import PoseNet
from golfaction_tpu_torch.models.refine import KeypointRefiner
from golfaction_tpu_torch.ops import affine, heatmap, preprocess, softdtw
from golfaction_tpu_torch.pipeline import video_io


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the kernels' plain versions")
    return dev


class Pipeline:
    """Holds the four models and runs the analysis program.

    `params`: {"pose", "gcn", "align", "error"[, "refine"]} of torch
    state_dicts (see weights.from_flax); None draws random weights from
    `seed`.  The keypoint refiner runs when `params` carries "refine" (with
    random weights: when `cfg.refine.enabled`; its zero head makes it the
    identity).
    `error_thresholds`: per-fault decision thresholds [NUM_ERRORS]
    (checkpoint.load_error_thresholds), used when `analyze` gets none.
    """

    def __init__(self, cfg: PipelineConfig | None = None, params: dict | None = None,
                 device="cuda", seed: int = 0, error_thresholds=None):
        self.cfg = cfg or get_config()
        c = self.cfg
        self.device = resolve_device(device)
        self.pose_model = PoseNet(c.pose)
        self.gcn_model = ActionSegmentationGCN(c.gcn)
        self.align_model = AlignEncoder(c.align)
        self.error_model = ErrorClassifier(c.error)
        self.models = {"pose": self.pose_model, "gcn": self.gcn_model,
                       "align": self.align_model, "error": self.error_model}
        self.refine_model = None
        has_refiner = c.refine.enabled if params is None else "refine" in params
        if has_refiner:
            self.refine_model = self.models["refine"] = KeypointRefiner(c.refine)
        if params is None:
            self._init_random(seed)
        else:
            for name, sd in params.items():
                self.models[name].load_state_dict(sd)
        for m in self.models.values():
            m.to(self.device).eval()
        self.gcn_model.prepare()
        self.error_thresholds = None
        if error_thresholds is not None:
            self.error_thresholds = torch.as_tensor(
                np.asarray(error_thresholds, np.float32), device=self.device)

    @classmethod
    def from_artifacts(cls, root: str = "artifacts", preset: str = "full_pipeline",
                       device="cuda") -> "Pipeline":
        """The shipped model: config adapted to the tree (pose_meta.json, the
        checkpoints' shapes), weights from `<root>/params/*.npz`, per-fault
        thresholds from error_thresholds.json."""
        cfg = checkpoint.config_for_artifacts(get_config(preset), root)
        params = weights.from_flax(checkpoint.load_params(root))
        return cls(cfg, params, device=device,
                   error_thresholds=checkpoint.load_error_thresholds(root))

    def _init_random(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        for m in self.models.values():
            weights.init_random(m, gen)
        if self.refine_model is not None:      # a new refiner is the identity
            torch.nn.init.zeros_(self.refine_model.head.weight)

    # ------------------------------------------------------------------
    # Device programs
    # ------------------------------------------------------------------
    def _pose_fn(self, frames: torch.Tensor, boxes: torch.Tensor):
        """The pose stage of a chunk of clips: `_pose_pass`, after the
        keypoint-seeded box refinement when `box_refine_stride` > 0.

        The refinement runs a coarse pose pass on every `stride`-th frame
        from FULL-FRAME boxes (the pose net trains with box-scale augmentation
        up to whole-frame crops, so it owes nothing to the host's box
        estimate and survives camera motion), takes tight boxes from its
        keypoints, interpolates them to every frame and smooths them."""
        s = self.cfg.box_refine_stride
        N, T, H, W = frames.shape[:4]
        if s > 0 and T > s:
            sub = frames[:, ::s].contiguous()
            full = torch.tensor([W / 2.0, H / 2.0, float(W), float(H)], dtype=torch.float32,
                                device=frames.device).expand(N, sub.shape[1], 4)
            coarse, _ = self._pose_pass(sub, full, want_aux=False)
            rb = affine.boxes_from_keypoints(coarse, (H, W), min_size=0.1 * H)
            boxes = torch.stack([affine.smooth_boxes(affine.interp_boxes(rb[n], s, T), window=9)
                                 for n in range(N)])
        return self._pose_pass(frames, boxes)

    def _pose_pass(self, frames: torch.Tensor, boxes: torch.Tensor, want_aux: bool = True):
        """frames [N, T, H, W, 3] uint8, boxes [N, T, 4] (device) ->
        keypoints [N, T, V, 3] image px, and the per-joint heatmap aux
        [N, T, V, 4] the error head reads (else None): with
        error.mode_features (dx, dy, rel_mass, sep) of the strongest mode the
        tracked decode did not select, with error.spread_features (cov_xx,
        cov_xy, cov_yy, floor) of the heatmap in image px², floor being the
        training target's (sigma * box scale)²."""
        c = self.cfg
        N, T = frames.shape[:2]
        V = c.pose.num_joints
        track_k = c.pose.decode_tracking
        want_modes = want_aux and c.error.mode_features
        want_spread = want_aux and c.error.spread_features
        if want_modes and track_k < 2:
            raise ValueError("error.mode_features requires pose.decode_tracking >= 2 "
                             "(the secondary mode comes from the tracked-decode NMS)")
        half = c.pose.in_frames // 2
        boxes = affine.box_to_center_scale(
            boxes, aspect_ratio=c.pose.input_hw[1] / c.pose.input_hw[0])
        flat_f = frames.reshape(N * T, *frames.shape[2:])
        flat_b = boxes.reshape(N * T, 4).contiguous()
        mb = max(1, min(c.frame_batch, N * T))
        decs, moms = [], []
        for s in range(0, N * T, mb):
            if half == 0:
                crops = preprocess.crop_resize_normalize(
                    flat_f[s:s + mb], flat_b[s:s + mb], c.pose.input_hw)
            else:
                # Temporal context: each frame's neighbours t-k..t+k (clamped
                # at its clip's edges), cropped with frame t's box and
                # concatenated on the channel axis.
                idx = torch.arange(s, min(s + mb, N * T), device=frames.device)
                start, t = idx - idx % T, idx % T
                crops = torch.cat([
                    preprocess.crop_resize_normalize(
                        flat_f[start + (t + off).clamp(0, T - 1)], flat_b[s:s + mb],
                        c.pose.input_hw)
                    for off in range(-half, half + 1)], dim=-1)
            hm = self.pose_model(crops)                             # [mb, V, Hh, Wh]
            if track_k:
                decs.append(heatmap.topk_modes(
                    hm, k=track_k, suppress_radius=c.pose.track_suppress_radius))
            else:
                decs.append(heatmap.decode_heatmaps(hm, method="udp" if c.pose.udp
                                                    else "quarter"))
            if want_spread:
                moms.append(heatmap.moment_stats(hm))
        dec = torch.cat(decs, dim=0)
        spread = None
        if want_spread:
            # Covariance heatmap px² -> image px² (the crop is an aspect-matched
            # pure scale, so one factor per frame).
            sc = (flat_b[:, 3] / c.pose.heatmap_hw[0])[:, None, None]          # [N*T,1,1]
            cov = torch.cat(moms, dim=0)[..., 2:5] * sc ** 2
            floor = ((c.pose.sigma * sc) ** 2).expand(*cov.shape[:2], 1)
            spread = torch.cat([cov, floor], dim=-1).reshape(N, T, V, 4)
        if not track_k:
            kpts = heatmap.keypoints_to_image(dec, flat_b, c.pose.heatmap_hw,
                                              c.pose.input_hw)
            return kpts.reshape(N, T, V, 3), spread
        # Viterbi runs in image space, normalized by the clip-mean crop scale
        # so track_lambda keeps heatmap-px² units at any resolution.
        img = heatmap.keypoints_to_image(dec.reshape(N * T, V * track_k, 3), flat_b,
                                         c.pose.heatmap_hw, c.pose.input_hw)
        img = img.reshape(N, T, V, track_k, 3)
        s = (boxes[..., 3].mean(1) / c.pose.heatmap_hw[0])[:, None, None, None]   # [N,1,1,1]
        norm = torch.cat([img[..., :2] / s[..., None], img[..., 2:]], dim=-1)
        # One Viterbi over all clips: time leads, the clip axis is a batch dim.
        tr = heatmap.viterbi_track(norm.transpose(0, 1), lam=c.pose.track_lambda).transpose(0, 1)
        kpts = torch.cat([tr[..., :2] * s, tr[..., 2:]], dim=-1)               # [N,T,V,3]
        if not want_modes:
            return kpts, spread
        aux = _secondary_modes(img.reshape(N * T, V, track_k, 3), kpts.reshape(N * T, V, 3))
        return kpts, aux.reshape(N, T, V, 4)

    def _core_fn(self, frames, boxes, valid) -> dict:
        """Clips [N, T, H, W, 3] -> keypoints, phase logits/labels, error
        logits (and the pose aux block when mode features are on)."""
        kpts, aux = self._pose_fn(frames, boxes)
        if self.refine_model is not None:
            kpts = self.refine_model(kpts, valid)
        sk = normalize_skeleton(kpts, valid)
        logits = self.gcn_model(sk, valid)
        err = self.error_model(kpts, logits, valid, None, aux)
        labels = torch.where(valid, logits.argmax(-1), -1).to(torch.int32)
        out = {"keypoints": kpts, "phase_logits": logits, "phase_labels": labels,
               "error_logits": err}
        if aux is not None:
            out["kpt_aux"] = aux
        return out

    def _align_batch_fn(self, kpts, valid, ref_kpts, ref_valid, phase_logits=None,
                        aux=None) -> dict:
        """Align N clips [N, T, V, 3] against one reference [Tr, V, 3] ->
        cost [N], path [N, T+Tr-1, 2], path_length [N], plus error_logits
        [N, E] refined with the deviation features when phase_logits given."""
        c = self.cfg
        sa = normalize_skeleton(kpts, valid)
        sr = normalize_skeleton(ref_kpts[None], ref_valid[None])
        ea = self.align_model(sa, valid)                            # [N, T, D]
        er = self.align_model(sr, ref_valid[None])                  # [1, Tr, D]
        D = softdtw.pairwise_sqdist(ea, er.expand(ea.shape[0], *er.shape[1:]))
        D = D.contiguous()
        N = D.shape[0]
        la = valid.sum(-1).clamp(min=1).to(torch.int32)
        lb = ref_valid.sum().clamp(min=1).to(torch.int32).expand(N)
        cost = softdtw.softdtw_cost_masked(D, la, lb, c.align.gamma)
        path, length = softdtw.dtw_path_masked(D, la, lb)
        out = {"cost": cost, "path": path, "path_length": length}
        if phase_logits is not None:
            ref_warp = softdtw.warp_by_path(ref_kpts, path, length, kpts.shape[1])
            out["error_logits"] = self.error_model(kpts, phase_logits, valid, ref_warp, aux)
        return out

    def _align_fn(self, kpts_a, valid_a, kpts_b, valid_b) -> dict:
        """Soft-DTW alignment between two keypoint sequences."""
        out = self._align_batch_fn(kpts_a[None], valid_a[None], kpts_b, valid_b)
        return {k: v[0] for k, v in out.items()}

    def _align_refine_fn(self, kpts, valid, ref_kpts, ref_valid, phase_logits,
                         aux=None) -> dict:
        """Alignment + alignment-conditioned error refinement (one pair): the
        reference is warped onto the clip's timeline along the DTW path and
        the error head re-runs with the deviation features."""
        out = self._align_fn(kpts, valid, ref_kpts, ref_valid)
        ref_warp = softdtw.warp_by_path(ref_kpts, out["path"], out["path_length"],
                                        kpts.shape[0])
        out["error_logits"] = self.error_model(
            kpts[None], phase_logits[None], valid[None], ref_warp[None],
            None if aux is None else aux[None])[0]
        return out

    # ------------------------------------------------------------------
    # Host-facing API
    # ------------------------------------------------------------------
    def _prepare(self, frames: np.ndarray, boxes: Optional[np.ndarray]):
        if boxes is None:
            boxes = video_io.estimate_person_boxes(frames)
        return video_io.pad_to_bucket(frames, np.asarray(boxes), self.cfg.length_buckets)

    def _to_device(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """Same-shaped host arrays -> one [n, ...] device batch.  Each array
        is copied straight into its slot: no stacked host copy of the 1080p
        frames is made."""
        first = torch.from_numpy(np.ascontiguousarray(arrays[0]))
        out = torch.empty((len(arrays), *first.shape), dtype=first.dtype, device=self.device)
        for slot, a in zip(out, arrays):
            slot.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return out

    def _thresholds(self, error_threshold):
        if error_threshold is not None:
            return error_threshold
        return self.error_thresholds if self.error_thresholds is not None else 0.5

    @torch.inference_mode()
    def analyze(self, video: Union[str, np.ndarray], boxes: Optional[np.ndarray] = None,
                reference: Optional[types.Skeleton] = None,
                error_threshold=None) -> types.AnalysisResult:
        """Analyze one swing clip (a path or frames [T, H, W, 3] uint8).
        With `reference` (a Skeleton, e.g. from `extract_skeleton`) the
        soft-DTW alignment is included and the error head is refined."""
        frames = video_io.load_video(video)[0] if isinstance(video, str) else np.asarray(video)
        frames_p, boxes_p, valid_np = self._prepare(frames, boxes)
        valid = torch.from_numpy(valid_np).to(self.device)
        out = self._core_fn(self._to_device([frames_p]), self._to_device([boxes_p]),
                            valid[None])
        out = {k: v[0] for k, v in out.items()}
        alignment = None
        if reference is not None:
            a = self._align_refine_fn(
                out["keypoints"], valid, reference.keypoints.to(self.device),
                reference.valid.to(self.device), out["phase_logits"], out.get("kpt_aux"))
            alignment = types.AlignmentResult(cost=a["cost"], path=a["path"],
                                              path_length=a["path_length"])
            out["error_logits"] = a["error_logits"]
        probs = torch.sigmoid(out["error_logits"])
        return types.AnalysisResult(
            keypoints=out["keypoints"], phase_labels=out["phase_labels"],
            phase_logits=out["phase_logits"],
            error_flags=probs > self._thresholds(error_threshold),
            error_probs=probs, valid=valid, alignment=alignment)

    @torch.inference_mode()
    def analyze_batch(self, videos: Sequence[Union[str, np.ndarray]],
                      boxes: Optional[Sequence[np.ndarray]] = None,
                      reference: Optional[types.Skeleton] = None,
                      error_threshold=None) -> list:
        """Analyze many clips: a thread pool decodes and prepares clips while
        the main thread runs each chunk of up to `clip_batch` same-bucket
        clips as one batch.  With `reference`, every clip is aligned against
        it in one batched alignment per chunk.

        A clip that fails decode or preparation yields its Exception at its
        index instead of an AnalysisResult; the others go on.
        """
        n_vids = len(videos)
        prepared: list = [None] * n_vids
        failures: dict[int, Exception] = {}
        cb = max(1, self.cfg.clip_batch)
        outs: dict[int, dict] = {}
        thr = self._thresholds(error_threshold)
        ref = None
        if reference is not None:
            ref = (reference.keypoints.to(self.device), reference.valid.to(self.device))

        def _decode(i):
            v = videos[i]
            frames = video_io.load_video(v)[0] if isinstance(v, str) else np.asarray(v)
            return self._prepare(frames, None if boxes is None else boxes[i])

        def _dispatch(chunk):
            valid = self._to_device([prepared[i][2] for i in chunk])
            out = self._core_fn(self._to_device([prepared[i][0] for i in chunk]),
                                self._to_device([prepared[i][1] for i in chunk]), valid)
            for i in chunk:       # release the decoded host frames
                prepared[i] = (None, None, prepared[i][2])
            if ref is not None:
                a = self._align_batch_fn(out["keypoints"], valid, ref[0], ref[1],
                                         out["phase_logits"], out.get("kpt_aux"))
                out["alignment"] = a
                out["error_logits"] = a["error_logits"]
            for n, i in enumerate(chunk):
                outs[i] = _index(out, n)

        pending: dict[int, list[int]] = {}   # bucket length -> ready clips
        workers = min(4, os.cpu_count() or 1, n_vids or 1)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            futs = {ex.submit(_decode, i): i for i in range(n_vids)}
            for fut in cf.as_completed(futs):
                i = futs[fut]
                try:
                    prepared[i] = fut.result()
                except Exception as e:  # noqa: BLE001 — quarantine decode errors
                    failures[i] = e
                    continue
                tb = prepared[i][0].shape[0]
                pending.setdefault(tb, []).append(i)
                if len(pending[tb]) == cb:
                    _dispatch(pending.pop(tb))
        for tb in sorted(pending):
            idxs = pending[tb]
            for c0 in range(0, len(idxs), cb):
                _dispatch(idxs[c0:c0 + cb])

        results: list = []
        for i, p in enumerate(prepared):
            if p is None:
                results.append(failures[i])
                continue
            out = outs[i]
            probs = torch.sigmoid(out["error_logits"])
            alignment = None
            if ref is not None:
                a = out["alignment"]
                alignment = types.AlignmentResult(cost=a["cost"], path=a["path"],
                                                  path_length=a["path_length"])
            results.append(types.AnalysisResult(
                keypoints=out["keypoints"], phase_labels=out["phase_labels"],
                phase_logits=out["phase_logits"], error_flags=probs > thr,
                error_probs=probs, valid=torch.from_numpy(p[2]).to(self.device),
                alignment=alignment))
        return results

    def extract_skeleton(self, result: types.AnalysisResult) -> types.Skeleton:
        return types.Skeleton(keypoints=result.keypoints, valid=result.valid)


def _index(tree, n):
    if isinstance(tree, dict):
        return {k: _index(v, n) for k, v in tree.items()}
    return tree[n]


def _secondary_modes(img: torch.Tensor, kpts_img: torch.Tensor) -> torch.Tensor:
    """Per-joint (dx, dy, rel_mass, sep) [T, V, 4] of the strongest mode the
    Viterbi did not select, relative to the selection (image px); zeros
    where no such mode exists.  img [T, V, K, 3], kpts_img [T, V, 3]."""
    K = img.shape[-2]
    d = img[..., :2] - kpts_img[:, :, None, :2]                    # [T, V, K, 2]
    dist = torch.linalg.norm(d, dim=-1)
    score = img[..., 2]
    inf = torch.full_like(dist, float("inf"))
    sel = torch.where(score > 0, dist, inf).argmin(dim=-1)
    one = F.one_hot(sel, K).bool()
    other = torch.where(one | (score <= 0), -inf, score)
    jbest = other.argmax(dim=-1)                                   # [T, V]
    has = torch.isfinite(torch.gather(other, -1, jbest[..., None]))[..., 0]
    dj = torch.gather(d, 2, jbest[..., None, None].expand(*jbest.shape, 1, 2))[:, :, 0]
    sj = torch.gather(score, -1, jbest[..., None])[..., 0]
    zero = torch.zeros_like(sj)
    rel = torch.where(has, sj / kpts_img[..., 2].clamp(min=1e-6), zero)
    sep = torch.where(has, torch.linalg.norm(dj, dim=-1), zero)
    off = torch.where(has[..., None], dj, torch.zeros_like(dj))
    return torch.cat([off, rel[..., None], sep[..., None]], dim=-1)
