"""End-to-end pipeline: video in -> per-frame keypoints, swing-phase labels,
alignment against a reference swing, and swing-fault flags out.

Stages per clip (frames padded to a length bucket, `valid` marks real ones):
[coarse pose pass on every k-th frame from full-frame boxes -> smoothed
keypoint-seeded boxes, when box_refine_stride > 0] -> crop/resize/normalize
(kernel A, once per neighbour offset when pose.in_frames > 1) -> pose net ->
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
import dataclasses
import functools
import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from golfaction_tpu_torch import checkpoint, types, weights
from golfaction_tpu_torch.config import MeshConfig, PipelineConfig, apply_overrides, get_config
from golfaction_tpu_torch.models.align import AlignEncoder
from golfaction_tpu_torch.models.error import ErrorClassifier
from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN, normalize_skeleton
from golfaction_tpu_torch.models.pose import pose_net
from golfaction_tpu_torch.models.pose_graph import PoseGraphs
from golfaction_tpu_torch.models.refine import KeypointRefiner
from golfaction_tpu_torch.ops import affine, heatmap, preprocess, softdtw
from golfaction_tpu_torch.parallel import mesh as mesh_mod
from golfaction_tpu_torch.pipeline import video_io
from golfaction_tpu_torch.utils.profiling import span


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the kernels' plain versions")
    return dev


def assemble_clip_batch(clips: Sequence[np.ndarray], n: int) -> np.ndarray:
    """Same-shaped clips -> one host batch [n, ...], the last clip repeated
    into the slots past the clips given."""
    out = np.empty((n, *np.shape(clips[0])), np.asarray(clips[0]).dtype)
    for i in range(n):
        out[i] = clips[min(i, len(clips) - 1)]
    return out


def _new_models(c: PipelineConfig, refiner: bool) -> dict:
    models = {"pose": pose_net(c.pose), "gcn": ActionSegmentationGCN(c.gcn),
              "align": AlignEncoder(c.align), "error": ErrorClassifier(c.error)}
    if refiner:
        models["refine"] = KeypointRefiner(c.refine)
    return models


def init_params(cfg: PipelineConfig, seed: int = 0) -> dict:
    """{name: state_dict} of random weights drawn from one CPU generator
    seeded with `seed`, models in the order pose, gcn, align, error[,
    refine] (the refiner with `cfg.refine.enabled`; its zero head makes it
    the identity)."""
    gen = torch.Generator().manual_seed(seed)
    models = _new_models(cfg, cfg.refine.enabled)
    for m in models.values():
        weights.init_random(m, gen)
    if "refine" in models:
        torch.nn.init.zeros_(models["refine"].head.weight)
    return {name: m.state_dict() for name, m in models.items()}


class Pipeline:
    """Holds the four models and runs the analysis program.

    `params`: {"pose", "gcn", "align", "error"[, "refine"]} of torch
    state_dicts (see weights.from_flax); None draws random weights from
    `seed`.  The keypoint refiner runs when `params` carries "refine" (with
    random weights: when `cfg.refine.enabled`; its zero head makes it the
    identity).
    `error_thresholds`: per-fault decision thresholds [NUM_ERRORS]
    (checkpoint.load_error_thresholds), used when `analyze` gets none.
    `logger`: an optional utils.logging.JsonlLogger; `analyze` then logs an
    "analyze" event (frames, bucket, hw, wall_ms), the card synchronized
    before the clock is read.
    `device`: "cuda" when None and no mesh.  `mesh`: a parallel.mesh.Mesh
    with the layout of `cfg.mesh` (make_mesh(cfg.mesh)); the models then
    live on its device with rank 0's parameters (`mesh.replicate`), and
    `analyze_batch` splits the clips over its data shards.  A non-default
    `cfg.mesh` without a mesh, or a mesh of another layout, raises
    ValueError.
    """

    def __init__(self, cfg: PipelineConfig | None = None, params: dict | None = None,
                 device=None, seed: int = 0, error_thresholds=None, logger=None, mesh=None):
        self.cfg = cfg or get_config()
        self.logger = logger
        c = self.cfg
        self.mesh = mesh
        if mesh is None:
            if c.mesh != MeshConfig():
                raise ValueError(f"cfg.mesh={c.mesh!r} asks for a mesh and none was given: pass "
                                 "mesh=parallel.mesh.make_mesh(cfg.mesh) in a process group")
            self.device = resolve_device(device or "cuda")
        elif device is None or torch.device(device) in (mesh.device,
                                                         torch.device(mesh.device.type)):
            self.device = mesh.device
        else:
            raise ValueError(f"device {device} is not the mesh's device {mesh.device}")
        if mesh is not None:
            mesh_mod.check_config(mesh, c.mesh)
        if params is None:
            params = self.init_params(seed)
        self.models = _new_models(c, "refine" in params)
        self.pose_model = self.models["pose"]
        self.gcn_model = self.models["gcn"]
        self.align_model = self.models["align"]
        self.error_model = self.models["error"]
        self.refine_model = self.models.get("refine")
        for name, sd in params.items():
            self.models[name].load_state_dict(sd)
        for m in self.models.values():
            m.to(self.device).eval()
            if mesh is not None:
                mesh_mod.replicate(m, mesh)
        self.gcn_model.prepare()
        self._pose_graphs = PoseGraphs()
        self.last_batch_stats: Optional[dict] = None
        self.last_copy_ms: list = []
        self.error_thresholds = None
        if error_thresholds is not None:
            self.error_thresholds = torch.as_tensor(
                np.asarray(error_thresholds, np.float32), device=self.device)

    @classmethod
    def from_artifacts(cls, root: str = "artifacts", preset: str = "full_pipeline",
                       device=None, overrides: Sequence[str] = (),
                       logger=None, mesh=None) -> "Pipeline":
        """The shipped model: the preset with `overrides` (config.apply_overrides
        syntax) adapted to the tree (pose_meta.json, the checkpoints'
        shapes), weights from `<root>/params/*.npz`, per-fault thresholds
        from error_thresholds.json.  The trees hold the ResNet pose net alone."""
        cfg = apply_overrides(get_config(preset), list(overrides))
        cfg.pose.require_resnet("Pipeline.from_artifacts (the npz trees' pose net)")
        cfg = checkpoint.config_for_artifacts(cfg, root)
        params = weights.from_flax(checkpoint.load_params(root))
        return cls(cfg, params, device=device,
                   error_thresholds=checkpoint.load_error_thresholds(root), logger=logger,
                   mesh=mesh)

    def init_params(self, seed: int = 0) -> dict:
        """The random state dicts that `Pipeline(self.cfg, params=None,
        seed=seed)` loads (module-level `init_params`)."""
        return init_params(self.cfg, seed)

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
        with span("pose"):
            return self._pose_pass(frames, self._refined_boxes(frames, boxes))

    def _refined_boxes(self, frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [N, T, 4] after the keypoint-seeded refinement of
        frames [N, T, H, W, 3] (`_pose_fn`); as given when
        `box_refine_stride` is 0 or the clips are no longer than it."""
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
        return boxes

    def _pose_heatmaps(self, frames: torch.Tensor, boxes: torch.Tensor):
        """The pose front of one clip up to the raw heatmaps, for the probes:
        frames [T, H, W, 3] uint8 and boxes [T, 4] on the device -> (heatmaps
        [T, V, Hh, Wh], the center-scale boxes [T, 4] the crops were taken
        with).  With `box_refine_stride` > 0 the boxes come from the coarse
        full-frame pass as in `_pose_fn`; then the crops (kernel A, once per
        neighbour offset when pose.in_frames > 1) and the pose net, in
        micro-batches of `frame_batch`."""
        c = self.cfg
        T = frames.shape[0]
        boxes = affine.box_to_center_scale(
            self._refined_boxes(frames[None], boxes[None])[0],
            aspect_ratio=c.pose.input_hw[1] / c.pose.input_hw[0]).contiguous()
        mb = max(1, min(c.frame_batch, T))
        # The final crops are float32 whatever preprocess_dtype says, as the
        # JAX probe front's are; the coarse pass above honours it.
        hms = [self._pose_net(self._context_crops(frames, boxes, i, mb, T, torch.float32))
               for i in range(0, T, mb)]
        return torch.cat(hms), boxes

    def _pose_net(self, crops: torch.Tensor) -> torch.Tensor:
        """The pose net on one micro-batch of crops: a replay of its captured
        CUDA graph where `pose_graph.graph_route` allows (the ResNet, a full
        micro-batch on the card, no gradient, no hook), else the module."""
        return self._pose_graphs(self.pose_model, crops, self.cfg.frame_batch)

    def _context_crops(self, flat_f: torch.Tensor, flat_b: torch.Tensor, s: int, mb: int,
                       T: int, dtype: torch.dtype) -> torch.Tensor:
        """The pose net's input for frames s..s+mb of flat_f [N*T, H, W, 3]
        (clips of T frames) with the center-scale boxes flat_b [N*T, 4]:
        crops of `dtype` through kernel A (its bfloat16 variant for
        bfloat16), [mb, h, w, 3 * pose.in_frames]."""
        c = self.cfg
        half = c.pose.in_frames // 2
        if half == 0:
            return preprocess.crop_resize_normalize(
                flat_f[s:s + mb], flat_b[s:s + mb], c.pose.input_hw, dtype=dtype)
        # Temporal context: each frame's neighbours t-k..t+k (clamped at its
        # clip's edges), cropped with frame t's box and concatenated on the
        # channel axis.
        idx = torch.arange(s, min(s + mb, flat_f.shape[0]), device=flat_f.device)
        start, t = idx - idx % T, idx % T
        return torch.cat([
            preprocess.crop_resize_normalize(
                flat_f[start + (t + off).clamp(0, T - 1)], flat_b[s:s + mb], c.pose.input_hw,
                dtype=dtype)
            for off in range(-half, half + 1)], dim=-1)

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
        boxes = affine.box_to_center_scale(
            boxes, aspect_ratio=c.pose.input_hw[1] / c.pose.input_hw[0])
        flat_f = frames.reshape(N * T, *frames.shape[2:])
        flat_b = boxes.reshape(N * T, 4).contiguous()
        mb = max(1, min(c.frame_batch, N * T))
        # The pose net casts its input to its own dtype: a float32 net takes
        # bfloat16 crops at their exact values, as JAX's type promotion does.
        crop_dtype = getattr(torch, c.preprocess_dtype)
        decs, moms = [], []
        for s in range(0, N * T, mb):
            with span("pose.crops"):
                crops = self._context_crops(flat_f, flat_b, s, mb, T, crop_dtype)
            with span("pose.net"):
                hm = self._pose_net(crops)                         # [mb, V, Hh, Wh]
            with span("pose.decode"):
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
            with span("pose.decode"):
                kpts = heatmap.keypoints_to_image(dec, flat_b, c.pose.heatmap_hw,
                                                  c.pose.input_hw)
            return kpts.reshape(N, T, V, 3), spread
        with span("pose.track"):
            # Viterbi runs in image space, normalized by the clip-mean crop scale
            # so track_lambda keeps heatmap-px² units at any resolution.
            img = heatmap.keypoints_to_image(dec.reshape(N * T, V * track_k, 3), flat_b,
                                             c.pose.heatmap_hw, c.pose.input_hw)
            img = img.reshape(N, T, V, track_k, 3)
            s = (boxes[..., 3].mean(1) / c.pose.heatmap_hw[0])[:, None, None, None]  # [N,1,1,1]
            norm = torch.cat([img[..., :2] / s[..., None], img[..., 2:]], dim=-1)
            # One Viterbi over all clips: time leads, the clip axis is a batch dim.
            tr = heatmap.viterbi_track(norm.transpose(0, 1),
                                       lam=c.pose.track_lambda).transpose(0, 1)
            kpts = torch.cat([tr[..., :2] * s, tr[..., 2:]], dim=-1)           # [N,T,V,3]
        if not want_modes:
            return kpts, spread
        with span("pose.modes"):
            aux = _secondary_modes(img.reshape(N * T, V, track_k, 3),
                                   kpts.reshape(N * T, V, 3))
        return kpts, aux.reshape(N, T, V, 4)

    def _core_fn(self, frames, boxes, valid) -> dict:
        """Clips [N, T, H, W, 3] -> keypoints, phase logits/labels, error
        logits (and the pose aux block when mode features are on)."""
        return self._heads_fn(*self._pose_fn(frames, boxes), valid)

    def _heads_fn(self, kpts, aux, valid) -> dict:
        """The core after the pose stage: [keypoint refiner ->] skeleton
        normalize -> GCN -> error head, on keypoints [N, T, V, 3] and the
        pose aux block (or None)."""
        with span("heads"):
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
        with span("align"):
            with span("align.encode"):
                sa = normalize_skeleton(kpts, valid)
                sr = normalize_skeleton(ref_kpts[None], ref_valid[None])
                ea = self.align_model(sa, valid)                    # [N, T, D]
                er = self.align_model(sr, ref_valid[None])          # [1, Tr, D]
                D = softdtw.pairwise_sqdist(ea, er.expand(ea.shape[0], *er.shape[1:]))
                D = D.contiguous()
            N = D.shape[0]
            la = valid.sum(-1).clamp(min=1).to(torch.int32)
            lb = ref_valid.sum().clamp(min=1).to(torch.int32).expand(N)
            with span("align.cost"):
                cost = softdtw.softdtw_cost_masked(D, la, lb, c.align.gamma)
            with span("align.path"):
                path, length = softdtw.dtw_path_masked(D, la, lb)
            out = {"cost": cost, "path": path, "path_length": length}
            if phase_logits is not None:
                with span("align.warp"):
                    ref_warp = softdtw.warp_by_path(ref_kpts, path, length, kpts.shape[1])
                with span("align.error"):
                    out["error_logits"] = self.error_model(kpts, phase_logits, valid,
                                                           ref_warp, aux)
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
        """A scalar, or per-fault thresholds [NUM_ERRORS] (array or tensor)
        as a tensor on the device; None: the pipeline's own, else 0.5."""
        if error_threshold is None:
            return self.error_thresholds if self.error_thresholds is not None else 0.5
        if isinstance(error_threshold, (int, float)):
            return error_threshold
        return torch.as_tensor(types.to_numpy(error_threshold).astype(np.float32),
                               device=self.device)

    @torch.inference_mode()
    def analyze(self, video: Union[str, np.ndarray], boxes: Optional[np.ndarray] = None,
                reference: Optional[types.Skeleton] = None,
                error_threshold=None) -> types.AnalysisResult:
        """Analyze one swing clip (a path or frames [T, H, W, 3] uint8).
        With `reference` (a Skeleton, e.g. from `extract_skeleton`) the
        soft-DTW alignment is included and the error head is refined."""
        t0 = time.perf_counter()
        frames = video_io.load_video(video)[0] if isinstance(video, str) else np.asarray(video)
        frames_p, boxes_p, valid_np = self._prepare(frames, boxes)
        valid = torch.from_numpy(valid_np).to(self.device)
        out = self._core_fn(self._to_device([frames_p]), self._to_device([boxes_p]),
                            valid[None])
        out = {k: v[0] for k, v in out.items()}
        if self.logger is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.logger.log("analyze", frames=int(valid_np.sum()), bucket=int(frames_p.shape[0]),
                            hw=list(frames_p.shape[1:3]),
                            wall_ms=1e3 * (time.perf_counter() - t0))
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
                      error_threshold=None, decode_workers: Optional[int] = None) -> list:
        """Analyze many clips: a `decode_workers`-thread pool decodes and
        prepares clips while the main thread runs each chunk of up to
        `clip_batch` same-bucket clips as one batch.  With `reference`, every
        clip is aligned against it in one batched alignment per chunk.

        On the card the frames go through pinned host staging (a ring of
        clip-sized slots, `_Stager`) and a copy stream, one chunk ahead: a
        chunk's copy is started before the previous chunk's programs run,
        and the compute stream waits on the copy's event.  At most two
        chunks' frames are on the card at once.  Per-call telemetry lands
        in `last_batch_stats` (the JAX package's keys) and, on the card, the
        copy's milliseconds per chunk by CUDA events in `last_copy_ms`.

        A clip that fails decode or preparation yields its Exception at its
        index instead of an AnalysisResult; the others go on.  Chunk
        membership follows decode-completion order.  A clip's outputs do
        not depend on which clips share its chunk, but they may differ in
        the last bits with the chunk's size: cuDNN may take other
        algorithms at another batch size.

        With a mesh, clip i goes to data shard i % dp.  That is a function
        of the index alone, so every rank agrees on it without a collective.
        The JAX layout (each chunk's clip axis split over `data`, the chunk
        padded to a multiple of dp) would need the ranks to agree on every
        chunk, and chunks here follow decode-completion order, which differs
        from rank to rank.  Each rank runs the body above on its own clips
        only, and decodes only those; one all_gather of the per-clip results
        (a failed clip's Exception included) then gives every rank the full
        list in input order, on its own device.  `last_batch_stats` then
        counts `clips` and `failures` over all shards and sums
        `decode_s_total` over them; the other keys are this rank's.
        """
        t_start = time.perf_counter()
        n_vids = len(videos)
        mine = range(n_vids) if self.mesh is None else range(self.mesh.data_index, n_vids,
                                                              self.mesh.dp)
        results, stats = self._analyze_clips(videos, mine, boxes, reference, error_threshold,
                                             decode_workers, t_start)
        if self.mesh is not None:
            results, stats = self._gather_results(results, stats)
        self.last_batch_stats = {
            "wall_s": time.perf_counter() - t_start,
            "decode_s_total": stats["decode_s_total"],
            "decode_workers": stats["decode_workers"],
            "first_dispatch_s": stats["first_dispatch_s"],
            "clips": n_vids,
            "failures": stats["failures"],
        }
        return [results[i] for i in range(n_vids)]

    def _gather_results(self, results: dict, stats: dict) -> tuple[dict, dict]:
        """Every data shard's {index: result or Exception} and stats (one
        all_gather through the host), the other shards' results moved to
        this rank's device."""
        host = {i: r if isinstance(r, Exception) else _to(r, "cpu") for i, r in results.items()}
        merged, decode_s, failures = {}, 0.0, 0
        for part, st in mesh_mod.gather_objects((host, stats), self.mesh):
            merged.update(part)
            decode_s += st["decode_s_total"]
            failures += st["failures"]
        merged = {i: results[i] if i in results else
                  r if isinstance(r, Exception) else _to(r, self.device)
                  for i, r in merged.items()}
        return merged, dict(stats, decode_s_total=decode_s, failures=failures)

    def _analyze_clips(self, videos, indices, boxes, reference, error_threshold,
                       decode_workers, t_start) -> tuple[dict, dict]:
        """The body of `analyze_batch` over videos[i] for i in `indices`:
        ({i: AnalysisResult or Exception}, stats)."""
        prepared: dict = {}
        failures: dict[int, Exception] = {}
        decode_s = {i: 0.0 for i in indices}
        first_dispatch = [None]
        cb = max(1, self.cfg.clip_batch)
        outs: dict[int, dict] = {}
        thr = self._thresholds(error_threshold)
        ref = None
        if reference is not None:
            ref = (reference.keypoints.to(self.device), reference.valid.to(self.device))
        stager = _Stager(self.device) if self.device.type == "cuda" else None
        uploads: list = []       # (chunk, frames future) submitted, not yet computed
        done: list = []          # each computed chunk's completion event

        def _decode(i):
            t0 = time.perf_counter()
            v = videos[i]
            frames = video_io.load_video(v)[0] if isinstance(v, str) else np.asarray(v)
            p = self._prepare(frames, None if boxes is None else boxes[i])
            decode_s[i] = time.perf_counter() - t0
            return p

        def _upload(chunk, after):
            fr = [prepared[i][0] for i in chunk]
            if stager is None:
                frames = self._to_device(fr)
            else:
                frames = stager.upload(fr, after)
            for i in chunk:       # release the decoded host frames
                prepared[i] = (None, prepared[i][1], prepared[i][2])
            return frames

        def _compute(chunk, fut):
            frames = fut.result()
            if stager is not None:
                frames = stager.claim(frames)
            valid = self._to_device([prepared[i][2] for i in chunk])
            out = self._core_fn(frames, self._to_device([prepared[i][1] for i in chunk]), valid)
            if ref is not None:
                a = self._align_batch_fn(out["keypoints"], valid, ref[0], ref[1],
                                         out["phase_logits"], out.get("kpt_aux"))
                out["alignment"] = a
                out["error_logits"] = a["error_logits"]
            if stager is not None:
                done.append(stager.record_done())
            for n, i in enumerate(chunk):
                outs[i] = _index(out, n)

        def _dispatch(chunk):
            if first_dispatch[0] is None:
                first_dispatch[0] = time.perf_counter() - t_start
            # Chunk k's copy starts before chunk k-1's programs run; it waits
            # for chunk k-2's (done[-1]) to finish: two chunks' frames at most.
            after = done[-1] if done else None
            if stager is None:
                fut = cf.Future()
                fut.set_result(_upload(chunk, None))
            else:
                fut = copier.submit(_upload, chunk, after)
            uploads.append((chunk, fut))
            if len(uploads) > 1:
                _compute(*uploads.pop(0))

        pending: dict[int, list[int]] = {}   # bucket length -> ready clips
        workers = decode_workers or min(4, os.cpu_count() or 1, len(indices) or 1)
        with cf.ThreadPoolExecutor(max_workers=workers) as ex, \
                cf.ThreadPoolExecutor(max_workers=1) as copier:
            futs = {ex.submit(_decode, i): i for i in indices}
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
            while uploads:
                _compute(*uploads.pop(0))
        if stager is not None:
            self.last_copy_ms = stager.copy_ms()

        results: dict = dict(failures)
        for i, p in prepared.items():
            out = outs[i]
            probs = torch.sigmoid(out["error_logits"])
            alignment = None
            if ref is not None:
                a = out["alignment"]
                alignment = types.AlignmentResult(cost=a["cost"], path=a["path"],
                                                  path_length=a["path_length"])
            results[i] = types.AnalysisResult(
                keypoints=out["keypoints"], phase_labels=out["phase_labels"],
                phase_logits=out["phase_logits"], error_flags=probs > thr,
                error_probs=probs, valid=torch.from_numpy(p[2]).to(self.device),
                alignment=alignment)
        stats = {"decode_s_total": sum(decode_s.values()), "decode_workers": workers,
                 "first_dispatch_s": first_dispatch[0], "failures": len(failures)}
        return results, stats

    def extract_skeleton(self, result: types.AnalysisResult) -> types.Skeleton:
        return types.Skeleton(keypoints=result.keypoints, valid=result.valid)


class _Stager:
    """Copies clips to the card through pinned host staging on a side stream.

    The pinned memory is a ring of SLOTS clip-sized buffers, each reused
    once the copy out of it has finished (its event), so it stays at SLOTS
    clips whatever the number of chunks.  `upload` runs on a copy thread:
    each clip is copied into a slot on the host, then to the card on the
    copy stream; the main thread `claim`s the batch, which makes the compute
    stream wait on the copy's event."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.ring: list = [(None, None)] * self.SLOTS
        self.next = 0
        self.timing: list = []          # (start, end) CUDA events a chunk

    def _slot(self, nbytes: int):
        buf, ev = self.ring[self.next]
        if ev is not None:
            ev.synchronize()            # the copy out of this slot has finished
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        ev = torch.cuda.Event()
        self.ring[self.next] = (buf, ev)
        self.next = (self.next + 1) % len(self.ring)
        return buf, ev

    def upload(self, arrays: Sequence[np.ndarray], after=None):
        """Same-shaped host arrays -> (device batch [n, ...], copy-done event).
        `after`: an event to wait for on the host before the batch is
        allocated (the chunk whose frames must leave the card first)."""
        first = torch.from_numpy(np.ascontiguousarray(arrays[0]))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if after is not None:
                after.synchronize()
            out = torch.empty((len(arrays), *first.shape), dtype=first.dtype,
                              device=self.device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(self.stream)
            for slot, a in zip(out, arrays):
                src = torch.from_numpy(np.ascontiguousarray(a))
                nbytes = src.numel() * src.element_size()
                buf, ev = self._slot(nbytes)
                host = buf[:nbytes].view(src.dtype).view(src.shape)
                host.copy_(src)
                slot.copy_(host, non_blocking=True)
                ev.record(self.stream)
            end.record(self.stream)
        self.timing.append((start, end))
        return out, end

    def claim(self, uploaded) -> torch.Tensor:
        """The uploaded batch, ordered after its copy on the compute stream."""
        frames, ready = uploaded
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        frames.record_stream(stream)
        return frames

    def record_done(self) -> torch.cuda.Event:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def copy_ms(self) -> list:
        """Milliseconds of each chunk's copy stream, first copy to last."""
        out = []
        for start, end in self.timing:
            end.synchronize()
            out.append(start.elapsed_time(end))
        return out


@functools.lru_cache(maxsize=4)
def _default_pipeline(preset: str, device: str) -> Pipeline:
    return Pipeline(get_config(preset), device=device)


def analyze(video, boxes=None, reference=None, preset: str = "full_pipeline",
            device="cuda") -> types.AnalysisResult:
    """Module-level convenience: analyze one clip with a cached Pipeline of
    the preset (random weights from seed 0, as the JAX package's)."""
    return _default_pipeline(preset, str(device)).analyze(video, boxes=boxes,
                                                          reference=reference)


def _to(obj, device):
    """A tensor, or a dataclass of tensors (and of such dataclasses), on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


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
