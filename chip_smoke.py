#!/usr/bin/env python3
"""Drive golfaction_tpu_torch on one CUDA card and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device    the card's name and power limit (nvidia-smi)
  2. build     nvcc of every kernel source and g++ of the motion-box
               library (native/golfer_host.cpp), all started together; what
               ptxas reported for the kernels of A (both variants), B, C, E
               and F (registers, spills) and how many of their blocks one
               SM holds at the main
               path's and the trainer's shapes; F's cluster size at each
               distinct site shape and how many such clusters the card holds
               at once
  3. parity    each kernel against its plain version at the main path's
               shapes, float32 with TF32 off
  4. main      the shipped model (artifacts/) at full width: analyze (its
               boxes from the C++ motion-box library, checked against the
               numpy body), compare-mode analyze and analyze_batch of 4 clips
               with a reference, on 64-frame 1080p clips rendered from a seed;
               output checks, launch counts, compare mode twice (the
               alignment stage on the same keypoints, and whole runs with
               deterministic cuDNN, to the bit), one analyze with a
               JsonlLogger (its "analyze" event and fields), and the same
               program on the CPU (plain versions) on a small input as the
               reference
  5. times     kernel, plain and library times (CUDA events around one call;
               `graph_ms` is the kernel alone, 20 calls replayed in a CUDA
               graph; kernel A's library call is timed both ways too) at the
               main path's shapes, each kernel's bound (kernel C also with
               its register ring instead of its staged table; C and E their
               nanoseconds per anti-diagonal, E also through its two-launch
               layout), end-to-end frames/s,
               the stage times and a device profile of one chunk, and the GCN
               tail's four launches one by one
  6. single    the `full_pipeline` preset as it is (single-peak decode
               through kernel D, random weights from a seed, full width):
               analyze and analyze_batch with a reference; output checks,
               launch counts, and the program after the pose network held to
               the CPU on the card's own heatmaps
  7. train     the four trainers at their default (full) widths for a few
               steps each, then the stage-wise pose evaluation (crops
               through kernel A, decode through kernel D, PCK); finite
               losses, launch counts (one forward wavefront and one backward
               per alignment step), one alignment and one GCN step against
               the same step on the CPU
  8. int8     the post-training int8 pose path on the shipped pose checkpoint
               at full width: the card's integer convolution against a
               float64 convolution (exact), kernel F against its plain version
               at all 20 sites of a fused forward on real convolution outputs,
               then calibrate on 16 rendered crops and evaluate float, int8,
               fused-int8 and mixed forwards on 64 others (decode through
               kernel D): PCK@0.05 and milliseconds of each, the fused forward
               with kernel F against the fused forward with the plain epilogue;
               kernel F's time at each site shape, under the launch layout its
               policy chose and under the others it weighs
  9. options  the shipped model with box_refine_stride=8 on one 64-frame 1080p
               clip (finite keypoints, refined boxes inside the frame, one
               more launch of kernel A for the coarse pass), and a
               random-weight pipeline with in_frames=3, the spread features
               and the keypoint refiner, held to the CPU on the card's own
               heatmaps
 10. shipped_bf16  the shipped model at its own dtype (bfloat16) on the card
               against the same program on the CPU (2 clips x 20 frames):
               the keypoint gaps held to the CPU's own bfloat16-to-float32
               noise, the labels' agreement with the float32 run, the pose
               network's milliseconds at each dtype; then `group_norm`:
               kernel G at the 20 launch sites of one pose-net call on 64
               of those crops against its plain version (one bfloat16 ulp,
               bit-equal on >= 99.9%), its times beside its byte bound, the
               plain version's and F.group_norm's, every cluster, and the
               net with G against the net with the plain GroupNorms
 11. batch_overlap  analyze_batch of 12 clips in 3 chunks (pinned staging,
               the copy on a side stream one chunk ahead) against three
               one-chunk calls: equal to the bit with deterministic cuDNN;
               frames/s, the copy's ms a chunk and the card's idle share of
               both forms; the 3-chunk call must idle the card less
 12. stream, cli  one 1080p clip through analyze_stream and through
               `cli analyze --report --render`: keypoints equal to _core_fn
               on the same frames
 13. e2e_score demo_e2e at small counts (about 17 clips of 48 frames at
               540x960): the JAX script's JSON keys, every score finite in
               [0, 1], the comparison video written
 14. bench     `python -m golfaction_tpu_torch.cli bench --clips 2
               --e2e-clips 4 --iters 2 --impl-compare` in a subprocess: rc 0,
               the headline, e2e, pose, GCN (four buckets) and alignment
               rates finite and positive, sol_vs_peak and mfu_vs_peak in
               (0, 1.05]
 15. parallel  data parallelism (golfaction_tpu_torch/parallel/): two gloo
               ranks spawned on this card (a file store) run the shipped
               model's sharded analyze_batch of 8 clips (clip_batch 4,
               deterministic cuDNN; each rank renders and reads only its own
               clips), one data-parallel step of the skeleton loss at the
               trainers' default widths (float32) and the row-band sharded
               soft-DTW at [128, 80] and [61, 45]; this process runs the same
               analyze_batch and step without a mesh and through a one-rank
               NCCL group.  Sharded and NCCL results equal one process to the
               bit, the two-rank step within rel 1e-4, the soft-DTW cost
               within rtol 2e-5 of the oracle and the summed band gradients
               within atol 2e-5; frames/s of two ranks against one process
               and the soft-DTW's ms a call
 16. cascade   `cascade_finetune` on the shipped tree at full width and its
               dtype (4 rendered clips of 48 frames at 540x960, 16 synthetic,
               4 refiner, 10 GCN and 10 error-head steps, calibration on one
               clip a fault) into a temporary folder, then
               `calibrate_thresholds --per-fault 1` on the new tree:
               artifacts/ byte for byte unchanged, losses finite, thresholds
               on the grid, the new tree loaded and analyzed, kernels A, B, C
               launched, seconds by stage; then 2 refiner, 3 GCN and 3 error
               steps at float32 from its collection on the card against the
               CPU: every step's loss within rel 1e-4, every parameter
               within twice the summed learning rate (AdamW's step on a
               gradient that is float noise), the relative gaps reported
 17. retrain_chain  the ends of the retraining chain, writing into temporary
               folders only (artifacts/ byte for byte unchanged):
               `train_eval --eval-only` on a copy of the shipped checkpoints
               (its four evaluations beside artifacts/metrics.json, a
               record; A, B, C, D launched), a short `train_eval` run at the
               default widths (8 steps, 2 pose steps, a pose pool of 32
               clips; finite losses, metrics.json's keys, four npz files the
               pipeline loads and runs, C and E launched once a train_align
               step and C once more for the evaluation's hard paths), the
               three probes on the shipped tree at one pair (their gains
               beside the committed profiles, a record), `promote_artifacts`
               of the trained tree with the probes' profiles and phase 13's
               demo_e2e metrics as demo/ into a copy of artifacts/ (a gate
               miss exits 1 and writes nothing; float16 checkpoints, the
               sidecars, demo/; a destination step folder refused; the
               promoted tree runs), `import_pose` of an MMPose-style state
               dict at full width (coverage 1, the imported tree runs), and
               `softdtw_bwd_bench` at B 64 and 192, T 128, with kernel E's
               two-launch layout timed alone beside its bound
 18. preprocess_bf16  kernel A's bfloat16 variant against its plain version
               at [64, 1080, 1920, 3] -> [64, 256, 192, 3] with the smoke's
               boxes and 20 odd ones (equal to the bit); its two divisions
               (a reciprocal and one correction) against IEEE division over
               every float32 of their domains (0 mismatches); its times,
               bound and library call (`F.grid_sample`, then `.bfloat16()`);
               `_core_fn` of the shipped model on 2 clips at
               preprocess_dtype float32 and bfloat16 (each call a driven path:
               A's variant launched only at bfloat16, kernel A only at
               float32), the keypoint gap and the phase labels' agreement
               between them; `bench_preprocess_dtype` at its defaults
Phases 4 (main), 5 (e2e, breakdown), 10-13 and the trainers' timed steps run
at the configs' default dtype (bfloat16); the comparisons with the CPU
(reference_cpu, single_peak_cpu, options_cpu, train_step_*_vs_cpu),
compare_determinism and the kernels' parity inputs pin float32 (FLOAT32),
the dtype their limits were set for.
Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --options-repeats N

runs only the options phase, N times on the same clips (a record of whether
`options_cpu` ever fails), and

    python3 chip_smoke.py --group-norm

only the build and kernel G's phase (`group_norm`: parity at the 20 launch
sites of a shipped pose-net call, times, layouts, the net with and without G).

A kernel's `launches` counts calls of its wrapper, summed over the driven
paths (4, 6-9, 11-18; the bench counts its own, in its process, from its
headline to config 1; the parallel phase adds what its ranks counted); each path zeroes the counts just before it runs and
reads them just after.  The GCN tail's call is four __global__ launches
(rows, taps, gates, apply); the others' is one.  The `launches` line also
carries `phase_seconds`, the host seconds each phase took.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from golfaction_tpu_torch.bench import cuda_ms, graph_ms
from golfaction_tpu_torch.ops import kernel_counters

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
CLIP_T, VIDEO_HW, BATCH_CLIPS = 64, (1080, 1920), 4
TRAIN_STEPS = 8                # steps each trainer takes
# The fused int8 forward with kernel F against the same forward with the plain
# epilogue, heatmap gaps over the largest heatmap value: the largest single
# gap and the mean gap.
GAP_MAX, GAP_MEAN = 0.08, 5e-3
# Kernels as they were first ported (A: one thread per output pixel,
# coordinates made by a dozen torch launches; B: a frame-tile pass with a
# recomputed halo and a scalar product loop; C and E: one block per table,
# one thread per row, a block barrier and loads of D (and R) per diagonal,
# E's three exponentials on the chain; F: three launches over chunks of
# rows, every element read twice; A's bfloat16 variant: A's shared tile
# with two IEEE divisions a value and twelve one-byte loads a pixel),
# measured by this script at the same
# shapes on an NVIDIA H100 80GB HBM3 at 700.00 W: event-pair and in-graph
# milliseconds.  PERF.md names the runs.
EARLIER = {"crop_resize_normalize": {"earlier_ms": 0.278, "earlier_graph_ms": 0.0705},
           "gcn_block_tail": {"earlier_ms": 6.95, "earlier_graph_ms": 6.34},
           "softdtw_wavefront": {"earlier_ms": 0.188, "earlier_graph_ms": 0.137},
           "softdtw_backward": {"earlier_ms": 0.0863, "earlier_graph_ms": 0.0712},
           "requant_epilogue": {"earlier_ms": 2.08, "earlier_graph_ms": 0.875},
           "crop_resize_normalize_bf16": {"earlier_ms": 0.0766, "earlier_graph_ms": 0.0409}}
EARLIER_FROM = "the first port of the kernel, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md)"
TIME_KEYS = ("name", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "library_graph_ms", "ns_per_diagonal", "ring_graph_ms", "two_launch_graph_ms",
             "earlier_ms",
             "earlier_graph_ms", "earlier_from", "shape")
# The keys of one entry of the `kernels` line.  The earlier times above go on
# the `time` lines only: they are not this run's.
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")


# The comparisons with the CPU, compare_determinism and the kernels' parity
# inputs hold limits set for float32: their pipelines pin every model to it.
FLOAT32 = ("pose.dtype=float32", "gcn.dtype=float32", "align.dtype=float32",
           "error.dtype=float32", "refine.dtype=float32")


class SmokeFailure(RuntimeError):
    pass


def float32(cfg):
    from golfaction_tpu_torch.config import apply_overrides

    return apply_overrides(cfg, FLOAT32)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + json.dumps(kv), flush=True)


# ---------------------------------------------------------------------------
# Synthetic swing clips: a stick figure whose arms swing around the
# shoulders, drawn in torch on the card from a seed.
# ---------------------------------------------------------------------------

_BODY = np.array([  # COCO-17 joints in a unit body frame (y down, hips at 0)
    [0.0, -0.92], [-0.04, -0.96], [0.04, -0.96], [-0.09, -0.93], [0.09, -0.93],
    [-0.16, -0.72], [0.16, -0.72], [-0.2, -0.48], [0.2, -0.48], [-0.22, -0.26],
    [0.22, -0.26], [-0.1, 0.0], [0.1, 0.0], [-0.12, 0.45], [0.12, 0.45],
    [-0.13, 0.9], [0.13, 0.9]], np.float32)
_LIMBS = ((15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12), (5, 6),
          (5, 7), (7, 9), (6, 8), (8, 10), (0, 5), (0, 6), (0, 1), (0, 2), (1, 3), (2, 4))


def swing_keypoints(T: int, rng: np.random.Generator) -> np.ndarray:
    """[T, 17, 2] image px: arms rotate about the shoulders through a swing."""
    H, W = VIDEO_HW
    height = rng.uniform(600, 800) / 1.9                 # px per body unit
    center = np.array([rng.uniform(0.4, 0.6) * W, rng.uniform(0.5, 0.55) * H])
    tempo = rng.uniform(0.7, 1.4)
    k = np.repeat(_BODY[None], T, 0).copy()
    ph = (np.arange(T) / (T - 1)) ** tempo
    ang = np.deg2rad(-40 + 260 * ph)                      # arm angle vs straight down
    for sh, el, wr in ((5, 7, 9), (6, 8, 10)):
        for j, r in ((el, 0.24), (wr, 0.47)):
            k[:, j, 0] = _BODY[sh, 0] + r * np.sin(ang)
            k[:, j, 1] = _BODY[sh, 1] + r * np.cos(ang)
    k[:, :11, 0] += 0.05 * np.sin(np.pi * ph)[:, None]     # upper-body turn
    return (k * height + center).astype(np.float32)


def render_clip(kpts: np.ndarray, seed: int) -> np.ndarray:
    """[T, 17, 2] px -> frames [T, H, W, 3] uint8: noisy backdrop, bright limbs."""
    H, W = VIDEO_HW
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    back = 40 + 30 * (ys / H) + 10 * torch.rand((H, W), generator=gen, device=dev)
    color = torch.tensor([235.0, 205.0, 175.0], device=dev)
    out = torch.empty((len(kpts), H, W, 3), dtype=torch.uint8)
    kp = torch.from_numpy(kpts).to(dev)
    for t in range(len(kpts)):
        d2 = torch.full((H, W), float("inf"), device=dev)
        for a, b in _LIMBS:
            pa, pb = kp[t, a], kp[t, b]
            ab = pb - pa
            s = (((xs - pa[0]) * ab[0] + (ys - pa[1]) * ab[1]) / (ab @ ab + 1e-6)).clamp(0, 1)
            d2 = torch.minimum(d2, (xs - pa[0] - s * ab[0]) ** 2 + (ys - pa[1] - s * ab[1]) ** 2)
        ink = (d2 < 12.0 ** 2).float()[..., None]
        frame = back[..., None] * (1 - ink) + color * ink
        frame = frame + 6 * torch.randn((H, W, 3), generator=gen, device=dev)
        out[t] = frame.clamp(0, 255).to(torch.uint8).cpu()
    return out.numpy()


def boxes_of(kpts: np.ndarray) -> np.ndarray:
    lo, hi = kpts.min(1), kpts.max(1)
    return np.concatenate([(lo + hi) / 2, (hi - lo) * 1.15], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# Timing and bounds
# ---------------------------------------------------------------------------

def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def preprocess_bytes_ops(boxes: torch.Tensor, H: int, W: int, oh: int, ow: int,
                         out_bytes: int = 4, ops_per_px: int = 47):
    """Bytes the warp must move: the source pixels its taps touch (3 B each)
    plus the output (`out_bytes` a value: 4 float32, 2 bfloat16); ops:
    `ops_per_px` float operations per output pixel (47 for the float32
    kernel; about 60 for the bfloat16 variant, which rounds three times and
    divides twice a value)."""
    from golfaction_tpu_torch.ops.preprocess import _sample_coords

    b = boxes.detach().cpu().float()
    touched = 0
    for axis_x, size in ((0, W), (1, H)):
        c = torch.floor(_sample_coords(b, ow if axis_x == 0 else oh, axis=axis_x))
        counts = []
        for row in c:
            taps = torch.cat([row, row + 1]).unique()
            counts.append(int(((taps >= 0) & (taps < size)).sum()))
        if axis_x == 0:
            nx = np.asarray(counts)
        else:
            ny = np.asarray(counts)
    touched = int((nx * ny).sum()) * 3
    out = b.shape[0] * oh * ow * 3 * out_bytes
    return touched + out + b.numel() * 4, float(ops_per_px) * b.shape[0] * oh * ow


def gcn_tail_bytes_ops(B: int, T: int, V: int, w) -> tuple[float, float]:
    """x read and out written once, la and the packed weights read once
    (W1 once: the kernel reads its fragment-ordered copy instead of the
    packed one; the scratch it writes and reads again is not counted);
    ops counted per row (the C x C branch product, once, not the three
    passes of its TF32 split) plus the per-frame and per-joint gate MLPs."""
    C, M = w.C, w.M
    rows = B * T * V
    nbytes = 2 * rows * C * 4 + B * 4 + w.packed.numel() * 4
    per_row = 2 * C * C + 60 * C
    gates = B * (T + V) * (2 * C * M + 2 * M * C + 10 * M) + B * 4 * C * M
    return nbytes, rows * per_row + gates


def wavefront_bytes_ops(B: int, Ta: int, Tb: int, gamma: float):
    return 2 * B * Ta * Tb * 4, B * Ta * Tb * (17 if gamma > 0 else 3)


def decode_bytes_ops(M: int, HW: int):
    """Each heatmap read once, three floats written; one compare per element
    plus the nine-log Taylor step."""
    return M * HW * 4 + M * 3 * 4, M * (HW + 200)


def softdtw_bwd_bytes_ops(B: int, Ta: int, Tb: int):
    """D and R read once, E written once; three exponentials (about ten
    operations each) and a dozen more operations per cell."""
    return 3 * B * Ta * Tb * 4, B * Ta * Tb * 45


def requant_bytes_ops(numel: int, C: int, res_mode: int, out_bytes: int):
    """y read once (4 B), the residual once (int8 1 B, int32 4 B), the output
    written once (int8 1 B, bf16 2 B), the per-channel vectors once; about 13
    float operations per element (dequantize, two sums, normalize, relu,
    requantize), 2 more for an int8 residual, 9 for one with its own
    GroupNorm."""
    nbytes = numel * (4 + (0, 1, 4)[res_mode] + out_bytes) + C * 4 * (3, 3, 6)[res_mode]
    return nbytes, numel * (13 + (0, 2, 9)[res_mode])


def group_norm_bytes_ops(numel: int, C: int, mode: int):
    """x read once (2 B), the residual or the shortcut's input once (2 B),
    the output written once (2 B), weight and bias once per GroupNorm; about
    12 float operations per element (two sums, normalize, round, relu), 2
    more for a residual add, 11 for a second GroupNorm and its add."""
    gns = 2 if mode == 2 else 1
    nbytes = numel * (4 + (0, 2, 2)[mode]) + gns * C * 8
    return nbytes, numel * (12 + (0, 2, 11)[mode])


def decode_edge_rows(H: int, W: int) -> np.ndarray:
    """Made-up heatmaps [n, H, W] on the decode's edge cases: all zeros, two
    equal maxima (the first must win), a peak in each corner and on each
    edge, a negative-valued map and a smooth interior blob."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)

    def blob(cx, cy, s=1.5):
        return np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s)).astype(np.float32)

    rows = [np.zeros((H, W), np.float32)]
    tie = np.full((H, W), 0.1, np.float32)
    tie[H // 3, W // 2] = tie[2 * H // 3, W // 4] = 0.9
    rows.append(tie)
    for cx, cy in ((0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1),
                   (W // 2, 0), (W // 2, H - 1), (0, H // 2), (W - 1, H // 2)):
        rows.append(blob(cx, cy))
    rows.append(-1.0 - blob(W / 2 + 0.3, H / 2 - 0.2))
    rows.append(blob(W / 3 + 0.37, H / 2 + 0.21) + 1e-3)
    return np.stack(rows)


def decode_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Kernel D against the plain decode [..., 3]: whether the integer peaks
    and the scores are equal, and the largest x/y gap in heatmap px."""
    got, want = got.reshape(-1, 3), want.reshape(-1, 3)
    return {"peaks_equal": bool(torch.equal(got[:, :2].round(), want[:, :2].round())),
            "scores_equal": bool(torch.equal(got[:, 2], want[:, 2])),
            "max_xy_err": float((got[:, :2] - want[:, :2]).abs().max())}


def check_results(results, reference) -> None:
    """Shapes, finiteness, label range and, for every result after the first
    (the reference clip's own, which has no alignment), a monotone path
    between the right corners."""
    from golfaction_tpu_torch.config import NUM_ERRORS, NUM_PHASES

    lb = int(reference.valid.sum())
    for n, r in enumerate(results):
        check(isinstance(r.keypoints, torch.Tensor), f"analyze_batch returned {r!r}")
        T = r.valid.shape[0]
        check(tuple(r.keypoints.shape) == (T, 17, 3), "keypoint shape")
        check(tuple(r.phase_logits.shape) == (T, NUM_PHASES), "phase logit shape")
        check(tuple(r.error_probs.shape) == (NUM_ERRORS,), "error prob shape")
        check(bool(torch.isfinite(r.keypoints).all() and torch.isfinite(r.phase_logits).all()
                   and torch.isfinite(r.error_probs).all()), "non-finite output")
        lab = r.phase_labels[r.valid]
        check(bool(((lab >= 0) & (lab < NUM_PHASES)).all()), "phase label out of range")
        if n == 0:
            continue
        a = r.alignment
        la, n_path = int(r.valid.sum()), int(a.path_length)
        check(max(la, lb) <= n_path <= la + lb - 1, f"path length {n_path} for {la}x{lb}")
        p = a.path[:n_path].cpu()
        steps = p[1:] - p[:-1]
        check(p[0].tolist() == [0, 0] and p[-1].tolist() == [la - 1, lb - 1], "path ends")
        check(bool(((steps >= 0) & (steps <= 1)).all() and (steps.sum(1) >= 1).all()),
              "path not monotone")
        check(bool(torch.isfinite(a.cost)), "alignment cost not finite")


class Replay(torch.nn.Module):
    """Stands in for a pose network: for each call, the recorded heatmaps of
    the unused recorded call whose input is nearest this one's.  The two
    runs may batch clips in another order (analyze_batch fills its chunks in
    decode-completion order), so calls are matched by their crops, not by
    their order; `gaps` keeps each match's largest input difference and
    `order` the recorded call each call took."""

    def __init__(self, calls):
        super().__init__()
        self.recorded = list(calls)                  # (crops, heatmaps) on the CPU
        self.unused = set(range(len(self.recorded)))
        self.gaps, self.order = [], []
        self.calls = 0

    def forward(self, crops):
        x = crops.detach().cpu()
        gap, best = min(((float((self.recorded[i][0] - x).abs().max()), i)
                         for i in self.unused if self.recorded[i][0].shape == x.shape),
                        default=(float("inf"), None))
        if best is None:
            raise SmokeFailure(f"replay: no recorded pose call of shape {tuple(x.shape)} left")
        self.unused.discard(best)
        self.gaps.append(gap)
        self.order.append(best)
        self.calls += 1
        return self.recorded[best][1].to(crops.device)


def replay_on_cpu(tag: str, pipe, cpu, small, small_boxes, ref_small) -> None:
    """The program after the pose network, held to the CPU on the card's own
    heatmaps: random weights give near-tied peaks, so the two devices' own
    heatmaps (equal to float noise) may decode to different peaks.  `cpu` is
    the same pipeline on the CPU; its pose network is replaced by a replay."""
    seen = []
    handle = pipe.pose_model.register_forward_hook(lambda m, a, out: seen.append(
        (a[0].detach().to("cpu", copy=True), out.detach().to("cpu", copy=True))))
    try:
        r_gpu = pipe.analyze_batch(small, boxes=small_boxes, reference=ref_small)
    finally:
        handle.remove()
    cpu.pose_model = Replay(seen)
    r_cpu = cpu.analyze_batch(small, boxes=small_boxes, reference=ref_small)
    failed = [r for r in (*r_gpu, *r_cpu) if isinstance(r, Exception)]
    check(not failed, f"{tag}: clips failed: {failed}")
    check(cpu.pose_model.calls == len(seen), f"{tag}: the CPU replay made other pose calls")
    # Each CPU call took the recorded call on the same crops (kernel A's
    # float32 crops are within 1e-4 of the plain version's).
    input_gap = max(cpu.pose_model.gaps, default=0.0)
    check(input_gap <= 1e-3, f"{tag}: a CPU pose call matched no card call ({input_gap})")
    diffs = {"keypoints": 0.0, "phase_logits": 0.0, "error_probs": 0.0, "cost_rel": 0.0}
    clear = total = labels_off = paths_off = 0
    for g, c in zip(r_gpu, r_cpu):
        for k in ("keypoints", "phase_logits", "error_probs"):
            diffs[k] = max(diffs[k], float((getattr(g, k).cpu() - getattr(c, k)).abs().max()))
        diffs["cost_rel"] = max(diffs["cost_rel"], float(
            (g.alignment.cost.cpu() - c.alignment.cost).abs() / c.alignment.cost.abs()))
        # Labels where the CPU's top two logits are further apart than the
        # logit tolerance allows the card to move them.
        top2 = c.phase_logits.topk(2, dim=-1).values
        sure = c.valid & ((top2[:, 0] - top2[:, 1]) > 2e-3)
        clear, total = clear + int(sure.sum()), total + int(c.valid.sum())
        labels_off += int((g.phase_labels.cpu()[sure] != c.phase_labels[sure]).sum())
        paths_off += int(not torch.equal(g.alignment.path.cpu(), c.alignment.path))
    atol = {"keypoints": 1e-2, "phase_logits": 1e-3, "error_probs": 1e-4, "cost_rel": 1e-4}
    # The line comes before the checks, so that a failed run shows how far off it was.
    say(tag, frames=len(small[0]), clips=len(small), replayed_pose_calls=len(seen),
        replay_input_gap=input_gap, replay_order=cpu.pose_model.order, max_diff=diffs,
        atol=atol, labels_compared=clear,
        labels_valid=total, labels_off=labels_off, paths="exact", paths_off=paths_off)
    check(labels_off == 0, f"{tag}: phase labels differ from the CPU")
    check(paths_off == 0, f"{tag}: path differs from the CPU")
    check(all(diffs[k] <= atol[k] for k in atol),
          f"{tag}: card and CPU disagree after the pose network")


def single_peak_phase(clips, boxes, counters) -> dict:
    """The `full_pipeline` preset as it is: decode_tracking 0, so the pose
    pass decodes through kernel D.  Random weights from seed 0."""
    from golfaction_tpu_torch.config import get_config
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
    from golfaction_tpu_torch.types import Skeleton
    from tests import torch_dp

    cfg = float32(get_config("full_pipeline"))      # single_peak_cpu's limits are float32's
    check(cfg.pose.decode_tracking == 0 and cfg.pose.udp, "preset is not single-peak UDP")
    pipe = Pipeline(cfg, device="cuda", seed=0)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_ref = pipe.analyze(clips[1], boxes=boxes[1])
    reference = pipe.extract_skeleton(res_ref)
    res_cmp = pipe.analyze(clips[0], boxes=boxes[0], reference=reference)
    res_batch = pipe.analyze_batch(clips[2:], boxes=boxes[2:], reference=reference)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check_results([res_ref, res_cmp, *res_batch], reference)
    for k in ("preprocess", "gcn_tail", "softdtw", "decode"):
        check(launches[k] > 0, f"kernel {k} was not launched on the single-peak path")
    say("single_peak", config="full_pipeline preset, random weights, seed 0",
        decode_tracking=cfg.pose.decode_tracking, seconds=round(seconds, 3), launches=launches,
        results=2 + len(res_batch), ok=True)

    small = [c[:20] for c in clips[2:4]]
    small_boxes = [b[:20] for b in boxes[2:4]]
    ref_small = Skeleton(keypoints=reference.keypoints[:40].cpu(),
                         valid=reference.valid[:40].cpu())
    replay_on_cpu("single_peak_cpu", pipe, Pipeline(cfg, device="cpu", seed=0), small,
                  small_boxes, ref_small)
    return launches


def _step_loss_and_grad_norm(model, loss_fn, batch):
    from golfaction_tpu_torch.train.loops import global_grad_norm

    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    return float(loss.detach()), float(global_grad_norm(model))


def step_on_card_vs_cpu(model_cpu, loss_fn, batch_cpu, what: str) -> dict:
    """One loss and backward from the same weights and batch on both devices."""
    import copy

    dev = torch.device("cuda")
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    batch_gpu = tuple(None if t is None else t.to(dev) for t in batch_cpu)
    model_cpu.train()
    model_gpu.train()
    lc, nc = _step_loss_and_grad_norm(model_cpu, loss_fn, batch_cpu)
    lg, ng = _step_loss_and_grad_norm(model_gpu, loss_fn, batch_gpu)
    out = {"loss_card": lg, "loss_cpu": lc, "loss_rel": abs(lg - lc) / abs(lc),
           "grad_norm_card": ng, "grad_norm_cpu": nc, "grad_norm_rel": abs(ng - nc) / abs(nc)}
    check(out["loss_rel"] <= 1e-4, f"{what}: loss on the card and on the CPU differ")
    check(out["grad_norm_rel"] <= 1e-3, f"{what}: gradient norms differ")
    return out


def train_phase(counters) -> dict:
    """The four trainers at their default widths, a few steps each, then the
    stage-wise pose evaluation."""
    import dataclasses

    from golfaction_tpu_torch import config as cfg_mod
    from golfaction_tpu_torch import weights
    from golfaction_tpu_torch.models.align import AlignEncoder
    from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
    from golfaction_tpu_torch.train import data as data_mod
    from golfaction_tpu_torch.train import loops

    steps = TRAIN_STEPS
    tc = cfg_mod.TrainConfig(batch_size=32, warmup_steps=2, total_steps=steps, seed=0)
    pose_cfg = cfg_mod.PoseConfig()
    image_hw = (256, 320)
    for fn in counters.values():
        fn.launches = 0
    out = {}

    def run(name, fn):
        before = {k: f.launches for k, f in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        for rec in hist:
            check(all(np.isfinite(v) for v in rec.values()), f"{name}: non-finite {rec}")
        check(len(hist) == steps and state.step == steps, f"{name}: {len(hist)} records")
        out[name] = {k: f.launches - before[k] for k, f in counters.items()}
        # The call's seconds hold the set-up (model, pool rendering) and the
        # first step's warm-up; the later steps' pace is read off the history.
        later = (hist[-1]["seconds"] - hist[0]["seconds"]) / (steps - 1)
        say(f"train_{name}", steps=steps, seconds=round(sec, 3),
            seconds_per_step=round(sec / steps, 4),
            setup_seconds=round(sec - hist[-1]["seconds"], 3),
            first_step_seconds=round(hist[0]["seconds"], 4),
            later_seconds_per_step=round(later, 4), loss=[rec["loss"] for rec in hist],
            grad_norm=[rec["grad_norm"] for rec in hist],
            extra={k: [rec[k] for rec in hist] for k in hist[0]
                   if k not in ("step", "loss", "grad_norm", "seconds")}, launches=out[name])
        return state, hist

    _, hist = run("align", lambda: loops.train_align(cfg_mod.AlignConfig(), tc,
                                                     frames_per_clip=48, log_every=1))
    check(out["align"]["softdtw"] == steps and out["align"]["softdtw_bwd"] == steps,
          f"train_align: {out['align']} launches for {steps} steps")
    check(hist[-1]["loss"] < hist[0]["loss"], "train_align: the loss did not fall")
    run("gcn", lambda: loops.train_gcn(cfg_mod.GCNConfig(), tc, frames_per_clip=64,
                                       log_every=1))
    check(out["gcn"]["gcn_tail"] == 0, "train_gcn went through the forward-only tail kernel")
    run("error", lambda: loops.train_error(cfg_mod.ErrorConfig(), tc, frames_per_clip=64,
                                           log_every=1))
    state, _ = run("pose", lambda: loops.train_pose(
        pose_cfg, tc, image_hw=image_hw, clips_per_epoch=4, frames_per_clip=8, log_every=1,
        pool_clips=4, arm_weight=2.0, fast_frame_boost=1.0, pool_fault_prob=0.5,
        fault_frame_boost=1.0, fault_joint_boost=1.0, arm_wander=0.05))
    check(out["pose"]["preprocess"] > 0, "train_pose built its pool without kernel A")

    before = {k: f.launches for k, f in counters.items()}
    samples = data_mod.make_swing_batch(4, 8, seed=780_000, image_hw=image_hw, render=True,
                                        scene_families=data_mod.TRAIN_SCENE_FAMILIES)
    pck = loops.evaluate_pose(state.model, pose_cfg, samples, alpha=0.05)
    out["pose_eval"] = {k: f.launches - before[k] for k, f in counters.items()}
    check(np.isfinite(pck) and 0.0 <= pck <= 1.0, f"pose evaluation PCK {pck}")
    check(out["pose_eval"]["decode"] == len(samples) and out["pose_eval"]["preprocess"]
          == len(samples), f"pose evaluation launches {out['pose_eval']}")
    say("train_pose_eval", clips=len(samples), frames=8, hw=list(image_hw), pck_at_0_05=pck,
        launches=out["pose_eval"], note="after a handful of steps: a mechanism check")
    launches = {k: f.launches for k, f in counters.items()}

    # One step on the card against the same step on the CPU, small batch.
    small = dataclasses.replace(tc, batch_size=4)
    gen = torch.Generator().manual_seed(1)
    align = AlignEncoder(cfg_mod.AlignConfig(dtype="float32"))      # limits set for float32
    weights.init_random(align, gen)
    batch = loops.build_align_batch(*loops.align_pairs(small, 48, 0), device="cpu")
    say("train_step_align_vs_cpu", batch=4, frames=48,
        **step_on_card_vs_cpu(align, loops.align_loss, batch, "train_align step"))
    # Dropout 0: the two devices' generators draw different masks.
    gcn = ActionSegmentationGCN(cfg_mod.GCNConfig(dropout=0.0, dtype="float32"))
    weights.init_random(gcn, gen)
    batch = loops.build_gcn_batch(data_mod.make_swing_batch(4, 64, seed=0), device="cpu")
    say("train_step_gcn_vs_cpu", batch=4, frames=64, dropout=0.0,
        **step_on_card_vs_cpu(gcn, loops.gcn_loss, batch, "train_gcn step"))
    return launches


def int_conv_exact() -> None:
    """The card's integer convolution (strided patches + torch._int_mm)
    against a float64 convolution on full-range random int8: at the stem, at
    a 3x3 layer 512 channels deep (127 * 127 * 4608 passes 2^24) and at a
    transposed convolution."""
    from golfaction_tpu_torch.models import pose_quant as pq

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    out = {}
    for name, k, stride, cin, cout, hw, n in (("stem", 7, 2, 3, 64, (256, 192), 16),
                                              ("conv3x3x512", 3, 1, 512, 512, (8, 6), 64)):
        x, w = i8(n, *hw, cin), i8(k, k, cin, cout)
        got = pq.conv_i8(x, w.reshape(-1, cout), k, stride)
        xp = pq._pad_hw(x, k, stride).permute(0, 3, 1, 2).double()
        want = F.conv2d(xp, w.permute(3, 2, 0, 1).double(), stride=stride).permute(0, 2, 3, 1)
        out[name] = {"shape": list(got.shape), "largest": int(got.abs().max()),
                     "equal": bool(torch.equal(got.double(), want))}
    x, w = i8(64, 8, 6, 512), i8(4, 4, 512, 256)
    got = pq.deconv_i8(x, w.reshape(-1, 256))
    # flax's unflipped [kh, kw, I, O] is ConvTranspose2d's [I, O, kh, kw] flipped.
    want = F.conv_transpose2d(x.permute(0, 3, 1, 2).double(),
                              w.permute(2, 3, 0, 1).flip(2, 3).double(), stride=2, padding=1)
    out["deconv4x4"] = {"shape": list(got.shape), "largest": int(got.abs().max()),
                        "equal": bool(torch.equal(got.double(), want.permute(0, 2, 3, 1)))}
    say("int_conv_exact", route="strided int8 patches + torch._int_mm", against="float64 conv",
        results=out)
    check(all(v["equal"] for v in out.values()), "the integer convolution is not exact")


def int8_phase(counters, err: dict) -> tuple[dict, dict]:
    """The int8 pose path at full width on the shipped pose checkpoint.
    Returns (launches, kernel F's entry for the kernels line)."""
    from golfaction_tpu_torch import quantize_eval as qe
    from golfaction_tpu_torch.models import pose_quant as pq
    from golfaction_tpu_torch.ops import requant
    from golfaction_tpu_torch.ops.heatmap import decode_heatmaps_plain as heatmap_decode

    dev = torch.device("cuda")
    int_conv_exact()
    model = qe.load_pose_model("artifacts", device=dev)
    cfg = model.cfg
    check(cfg.stage_channels == (64, 128, 256, 512) and tuple(cfg.input_hw) == (256, 192),
          "the shipped pose model is not at full width")
    t0 = time.perf_counter()
    calib, _, _ = qe.render_crops(model, 2, 8, 660_000, (540, 960))
    crops, gt, boxes = qe.render_crops(model, 8, 8, 661_000, (540, 960))
    check(calib.shape[0] == 16 and crops.shape[0] == 64, "calibration/evaluation crop counts")
    say("int8_render", calib=16, eval=64, hw=[540, 960], seconds=round(time.perf_counter() - t0, 3))

    # parity_requant: kernel F against its plain version at every site of a
    # fused forward, on the shipped model's own int32 convolution outputs.
    with torch.inference_mode():
        qweights, scales = pq.prepare_int8(model, calib)
    sites, kept = [], {}

    def both(y, sy, gamma, beta, groups, **kw):
        got = requant.requant_epilogue(y, sy, gamma, beta, groups, **kw)
        want = requant.requant_epilogue_plain(y, sy, gamma, beta, groups, **kw)
        mode = requant._residual_mode(kw.get("residual"))
        N, H, W, C = y.shape
        site = {"R": H * W, "C": C, "residual": ("none", "int8", "conv")[mode],
                "out": "bf16" if kw.get("out_scale") is None else "int8"}
        if site["out"] == "int8":
            d = (got.int() - want.int()).abs()
            site["max_diff_lsb"] = int(d.max())
            site["share_off"] = float((d != 0).float().mean())
            ok = site["max_diff_lsb"] <= 1 and site["share_off"] < 1e-3
        else:
            w = want.float()
            ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30))) - 7)
            gap = (got.float() - w).abs()
            site["max_abs_err"] = float(gap.max())
            ok = bool((gap <= ulp.clamp(min=1e-5)).all())
        site["ok"] = ok
        sites.append(site)
        key = (site["R"], site["C"], site["residual"], site["out"])
        if key in kept:
            kept[key]["count"] += 1
        else:
            kept[key] = {"count": 1, "args": (y, sy, gamma, beta, groups), "kw": kw,
                         "mode": mode}
        return got

    with torch.inference_mode():
        pq.pose_forward_int8_fused(model, qweights, scales, crops, epilogue=both)
    torch.cuda.synchronize()
    check(len(sites) == 20, f"a fused forward has {len(sites)} epilogue sites, not 20")
    say("parity_requant", batch=64, sites=sites, distinct_shapes=len(kept),
        int8_limit="at most 1 LSB on under 0.1%",
        bf16_limit="one bfloat16 ulp (1e-5 where the terms cancel)")
    check(all(s_["ok"] for s_ in sites), "kernel F disagrees with its plain version")
    err["requant"] = float(max(s_.get("max_diff_lsb", 0) for s_ in sites))

    # Kernel F's times: each distinct site shape, weighted by how many sites
    # of a forward have it; beside each, the kernel alone under the other
    # layouts the launch policy weighs (one wave of blocks; the smallest
    # cluster that stages), so that the choice is measured in every run.
    tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
           "library_ms": 0.0}
    per_shape = []
    max_cluster, sms, l2 = requant.card_limits(dev)
    with torch.inference_mode():
        for (R, C, res, out_t), k in kept.items():
            a, kw = k["args"], k["kw"]
            ms = cuda_ms(lambda: requant.requant_epilogue(*a, **kw), reps=10)
            gms = graph_ms(lambda: requant.requant_epilogue(*a, **kw), calls=10, reps=5)
            plain = cuda_ms(lambda: requant.requant_epilogue_plain(*a, **kw), reps=3, warmup=1)
            nb, ops = requant_bytes_ops(a[0].numel(), C, k["mode"], 1 if out_t == "int8" else 2)
            bms, by = bound(nb, ops)
            shape = dict(N=a[0].shape[0], R=R, C=C, groups=a[4], res_mode=k["mode"],
                         out_int8=out_t == "int8", max_cluster=max_cluster, sms=sms)
            chosen = requant.launch_geometry(**shape, l2_bytes=l2)
            wave = requant.launch_geometry(**shape, l2_bytes=float("inf"))
            staging = next((c for c in (1, 2, 4, 8, 16) if c <= max_cluster
                            and requant.launch_geometry(**shape, cluster=c).staged), None)
            layouts = {}
            out = torch.empty_like(requant.requant_epilogue(*a, **kw))
            for c in sorted({wave.cluster, staging or wave.cluster} - {chosen.cluster}):
                geo = requant.launch_geometry(**shape, cluster=c)
                layouts[f"cluster {c}, {'staged' if geo.staged else 're-read'}"] = graph_ms(
                    lambda: requant.launch(out, geo, *a, **kw), calls=10, reps=5)
            # The library's GroupNorm alone on the site's dequantized values.
            y, sy, gamma, beta, groups = a
            deq = (y.float() * sy).permute(0, 3, 1, 2).contiguous()
            lib = cuda_ms(lambda: F.group_norm(deq, groups, gamma, beta, eps=1e-6), reps=10)
            del deq
            per_shape.append({"R": R, "C": C, "residual": res, "out": out_t, "sites": k["count"],
                              "cluster": chosen.cluster, "staged": chosen.staged,
                              "ms": ms, "graph_ms": gms, "plain_ms": plain, "bound_ms": bms,
                              "bound_by": by, "library_ms": lib,
                              "other_layouts_graph_ms": layouts})
            for key, v in (("ms", ms), ("graph_ms", gms), ("plain_ms", plain), ("bytes", nb),
                           ("ops", ops), ("library_ms", lib)):
                tot[key] += v * k["count"]
    kept.clear()
    torch.cuda.empty_cache()
    bms, by = bound(tot["bytes"], tot["ops"])
    entry = dict(name="requant_epilogue", route="cuda",
                 source="golfaction_tpu_torch/csrc/requant.cu",
                 replaces="golfaction_tpu/ops/pallas/requant_kernel.py:168",
                 launches=0, max_abs_err=err["requant"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=bms, bound_by=by, library_ms=tot["library_ms"],
                 graph_ms=tot["graph_ms"],
                 shape="the 20 sites of one fused forward at batch 64 (max_abs_err in int8 "
                       "LSB; library_ms is F.group_norm alone on each site's dequantized "
                       "float32 values, summed over the 20 sites as ms is)",
                 bytes=tot["bytes"], ops=tot["ops"], **EARLIER["requant_epilogue"],
                 earlier_from=EARLIER_FROM)
    say("time_requant_sites", per_shape=per_shape)

    # int8_path: the evaluation a user runs, through the entry point.
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = qe.evaluate(model, calib, crops, gt, boxes, reps=5)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    calls = 1 + 1 + 5                      # one for the PCK, one warm, five timed
    check(launches["requant"] == 20 * calls,
          f"{launches['requant']} launches of kernel F for {calls} fused forwards")
    check(launches["decode"] == 6, f"{launches['decode']} decode launches for six forwards")
    # The whole fused forward with kernel F against the same forward with the
    # plain epilogue.  Site by site on equal inputs they differ by 1 LSB on a
    # few elements in ten million (parity_requant); along the chain each such
    # element moves the next convolution's sums, so the share of elements
    # that differ grows from site to site and the heatmaps differ by a few
    # int8 steps of the last activations.
    plain_outs, differ = [], []

    def keep_plain(*a, **kw):
        plain_outs.append(requant.requant_epilogue_plain(*a, **kw))
        return plain_outs[-1]

    def against_plain(*a, **kw):
        out = requant.requant_epilogue(*a, **kw)
        differ.append(float((out != plain_outs[len(differ)]).float().mean()))
        return out

    with torch.inference_mode():
        hm_p = pq.pose_forward_int8_fused(model, qweights, scales, crops, epilogue=keep_plain)
        hm_k = pq.pose_forward_int8_fused(model, qweights, scales, crops,
                                          epilogue=against_plain)
        kp_k = heatmap_decode(hm_k)
        kp_p = heatmap_decode(hm_p)
        torch.backends.cudnn.allow_tf32 = True
        ms_tf32 = qe.forward_ms(lambda: model(crops), dev)
        torch.backends.cudnn.allow_tf32 = False
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pq.pose_forward_int8_fused(model, qweights, scales, crops)
            torch.cuda.synchronize()
    rows = device_kernel_rows(prof)
    top = sorted(rows, key=dev_us, reverse=True)[:10]
    busy_ms = sum(dev_us(e) for e in rows) / 1e3
    say("int8_profile", region="one fused int8 forward, 64 crops",
        device_busy_ms=busy_ms if rows else "not measured",
        device_idle_share=(1 - busy_ms / result["ms_int8_fused"]) if rows else "not measured",
        kernel_f_ms=sum(dev_us(e) for e in rows if "requant_kernel" in e.key) / 1e3,
        top=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])
    plain_outs.clear()
    largest = float(hm_p.abs().max())
    gap = float((hm_k - hm_p).abs().max()) / largest
    mean_gap = float((hm_k - hm_p).abs().mean()) / largest
    kp_gap = (kp_k[..., :2] - kp_p[..., :2]).abs().amax(-1)
    say("int8_path", config="artifacts/params/pose.npz, PoseConfig() widths", crops=64,
        seconds=round(seconds, 3), launches=launches, result=result,
        ms_float_cudnn_tf32=ms_tf32, float_is=f"{cfg.dtype} (the PoseConfig default), TF32 off",
        fused_kernel_vs_plain={"max_gap_rel": gap, "mean_gap_rel": mean_gap,
                               "share_of_elements_that_differ_by_site": differ,
                               "decoded_keypoints_max_gap_px": float(kp_gap.max()),
                               "decoded_keypoints_over_half_px": float((kp_gap > 0.5).float().mean())},
        limits={"max_gap_rel": GAP_MAX, "mean_gap_rel": GAP_MEAN, "keypoints_over_half_px": 0.01,
                "pck": 0.05})
    check(all(np.isfinite(result[k]) for k in ("pck_float", "pck_int8", "pck_int8_fused",
                                               "ms_float", "ms_int8", "ms_int8_fused")),
          "int8 evaluation: non-finite result")
    check(bool(torch.isfinite(hm_k).all()) and tuple(hm_k.shape) == (64, 17, 64, 48),
          "fused int8 heatmaps")
    check(gap <= GAP_MAX and mean_gap <= GAP_MEAN,
          "fused forward: kernel F and the plain epilogue give other heatmaps")
    check(float((kp_gap > 0.5).float().mean()) <= 0.01,
          "fused forward: kernel F and the plain epilogue decode to other keypoints")
    check(abs(result["pck_int8_fused"] - result["pck_float"]) <= 0.05,
          "fused int8 PCK is off the float PCK")
    return launches, entry


def group_norm_phase(pose_model, crops) -> dict:
    """Kernel G at the 20 launch sites (23 GroupNorms) of one call of the
    shipped bfloat16 pose net on a micro-batch of real crops: each site
    against its plain version (within one bfloat16 ulp a rounding, at the
    largest term of its sum, and bit-equal on at least 99.9% of elements),
    each distinct site's time by events and in a graph beside its byte
    bound, its plain version's and the library's (F.group_norm on the same
    bfloat16 channels-last input, GroupNorm alone), the kernel under every
    cluster the card takes, and the whole net with G and with the plain
    version.  Returns G's entry for the kernels line."""
    from golfaction_tpu_torch.ops import group_norm as kernel_g
    from tests.test_torch_group_norm_cuda import site_gap

    real, plain_fn = kernel_g.group_norm_act, kernel_g.group_norm_act_plain
    sites, kept = [], {}

    def both(x, groups, weight, bias, residual=None, x2=None, weight2=None, bias2=None,
             relu=True):
        a = (x, groups, weight, bias, residual, x2, weight2, bias2, relu)
        got = real(*a)
        mode = 1 if residual is not None else 2 if x2 is not None else 0
        N, C = x.shape[0], x.shape[-1]
        site = {"R": x.numel() // (N * C), "C": C,
                "epilogue": ("relu", "residual", "shortcut")[mode], **site_gap(got, a)}
        site["ok"] = site["gap_over_allowed"] <= 1.0 and site["bit_equal"] >= 0.999
        sites.append(site)
        key = (site["R"], C, mode)
        if key in kept:
            kept[key]["count"] += 1
        else:
            kept[key] = {"count": 1, "args": a, "mode": mode}
        return got

    kernel_g.group_norm_act = both
    try:
        with torch.inference_mode():
            pose_model(crops)
        torch.cuda.synchronize()
    finally:
        kernel_g.group_norm_act = real
    N = int(crops.shape[0])
    check(len(sites) == 20, f"a pose-net call has {len(sites)} GroupNorm launches, not 20")
    say("parity_group_norm", batch=N, sites=sites, distinct_shapes=len(kept),
        limit="one bfloat16 ulp a rounding, at the largest term of its sum "
              "(tests/test_torch_group_norm_cuda.py:term_ulp); bit-equal on >= 0.999")
    check(all(s_["ok"] for s_ in sites), "kernel G disagrees with its plain version")

    dev = crops.device
    max_cluster, sms, l2 = kernel_g.card_limits(dev)
    tot = {"ms": 0.0, "graph_ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "ops": 0.0,
           "library_ms": 0.0}
    per_shape = []
    with torch.inference_mode():
        for (R, C, mode), k in kept.items():
            a = k["args"]
            x, groups, weight, bias = a[:4]
            ms = cuda_ms(lambda: real(*a), reps=10)
            gms = graph_ms(lambda: real(*a), calls=10, reps=5)
            plain = cuda_ms(lambda: plain_fn(*a), reps=5, warmup=1)
            nb, ops = group_norm_bytes_ops(x.numel(), C, mode)
            bms, by = bound(nb, ops)
            chosen = kernel_g.launch_geometry(N, R, C, groups, 2 if mode == 2 else 1,
                                              max_cluster, sms, l2)
            out = torch.empty_like(x)
            layouts = {}
            for c in (1, 2, 4, 8, 16):
                if c <= max_cluster and c != chosen.cluster:
                    geo = kernel_g.launch_geometry(N, R, C, groups, 2 if mode == 2 else 1,
                                                   cluster=c)
                    layouts[f"cluster {c}, {'staged' if geo.staged else 're-read'}"] = graph_ms(
                        lambda: kernel_g.launch(out, geo, *a), calls=10, reps=5)
            xn, wb, bb = x.movedim(-1, 1), weight.bfloat16(), bias.bfloat16()
            lib = cuda_ms(lambda: F.group_norm(xn, groups, wb, bb, eps=1e-6), reps=10)
            per_shape.append({"R": R, "C": C, "epilogue": ("relu", "residual", "shortcut")[mode],
                              "sites": k["count"], "cluster": chosen.cluster,
                              "staged": chosen.staged, "smem": chosen.smem, "ms": ms,
                              "graph_ms": gms, "plain_ms": plain, "bound_ms": bms,
                              "bound_by": by, "library_ms": lib,
                              "other_layouts_graph_ms": layouts})
            for key, v in (("ms", ms), ("graph_ms", gms), ("plain_ms", plain), ("bytes", nb),
                           ("ops", ops), ("library_ms", lib)):
                tot[key] += v * k["count"]
        net_ms = cuda_ms(lambda: pose_model(crops), reps=10)
        kernel_g.group_norm_act = plain_fn
        try:
            net_plain_ms = cuda_ms(lambda: pose_model(crops), reps=10)
        finally:
            kernel_g.group_norm_act = real
    kept.clear()
    say("time_group_norm_sites", per_shape=per_shape,
        pose_net_ms={"crops": N, "kernel_g": net_ms, "plain_group_norms": net_plain_ms})
    bms, by = bound(tot["bytes"], tot["ops"])
    return dict(name="group_norm_act", route="cuda",
                source="golfaction_tpu_torch/csrc/group_norm.cu",
                replaces="none: the JAX package leaves this GroupNorm to XLA",
                launches=0, max_abs_err=max(s_["max_abs_err"] for s_ in sites),
                ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms, bound_by=by,
                library_ms=tot["library_ms"], graph_ms=tot["graph_ms"],
                shape=f"the 20 launches (23 GroupNorms) of one shipped pose-net call at batch "
                      f"{N} (library_ms is F.group_norm alone on each site's bfloat16 input, "
                      f"summed over the sites as ms is)",
                bytes=tot["bytes"], ops=tot["ops"])


def options_phase(clips, boxes, counters) -> dict:
    """The pose pass's options on the card: box refinement with the shipped
    model, then temporal context, spread features and the refiner together
    at random weights against the CPU."""
    import dataclasses

    from golfaction_tpu_torch import checkpoint, weights
    from golfaction_tpu_torch.config import PoseConfig, RefineConfig, get_config
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
    from golfaction_tpu_torch.types import Skeleton
    from tests import torch_dp

    H, W = VIDEO_HW
    base = checkpoint.config_for_artifacts(get_config("full_pipeline"), "artifacts")
    cfg = dataclasses.replace(base, box_refine_stride=8)
    pipe = Pipeline(cfg, weights.from_flax(checkpoint.load_params("artifacts")), device="cuda",
                    error_thresholds=checkpoint.load_error_thresholds("artifacts"))
    seen = []
    pass_ = pipe._pose_pass
    pipe._pose_pass = lambda f, b, **kw: (seen.append(b), pass_(f, b, **kw))[1]
    for fn in counters.values():
        fn.launches = 0
    res = pipe.analyze(clips[0])                 # host boxes: the refinement replaces them
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(len(seen) == 2 and seen[0].shape[1] == CLIP_T // 8, "box refinement: pose passes")
    rb = seen[1][0]
    inside = bool(((rb[:, 0] >= 0) & (rb[:, 0] <= W - 1) & (rb[:, 1] >= 0) & (rb[:, 1] <= H - 1)
                   & (rb[:, 2:] > 0).all(-1) & (rb[:, 2] <= 1.2 * W) & (rb[:, 3] <= 1.2 * H)).all())
    want_pre = -(-(CLIP_T // 8) // cfg.frame_batch) + -(-CLIP_T // cfg.frame_batch)
    say("options_box_refine", stride=8, frames=CLIP_T, launches=launches,
        preprocess_launches_without=-(-CLIP_T // cfg.frame_batch), boxes_inside=inside,
        box_mean=[round(float(v), 2) for v in rb.mean(0)], truth_box=[
            round(float(v), 2) for v in boxes[0].mean(0)])
    check(bool(torch.isfinite(res.keypoints).all()), "box refinement: keypoints not finite")
    check(inside, "box refinement: a refined box lies outside the frame")
    check(launches["preprocess"] == want_pre,
          f"box refinement: {launches['preprocess']} launches of kernel A, expected {want_pre}")
    del pipe

    cfg = get_config("full_pipeline")
    cfg = float32(dataclasses.replace(                 # options_cpu's limits are float32's
        cfg, pose=dataclasses.replace(cfg.pose, in_frames=3),
        error=dataclasses.replace(cfg.error, spread_features=True),
        refine=RefineConfig(enabled=True)))
    check(cfg.pose == PoseConfig(in_frames=3, dtype="float32"),
          "options: the pose model is not at full width")
    pipes = {d: Pipeline(cfg, device=d, seed=0) for d in ("cuda", "cpu")}
    head = torch.randn((2, cfg.refine.block_channels[-1]),
                       generator=torch.Generator().manual_seed(5)) * 0.1
    for p in pipes.values():                     # a zero head would be the identity
        with torch.no_grad():
            p.refine_model.head.weight.copy_(head)
    pipe = pipes["cuda"]
    before = {k: fn.launches for k, fn in counters.items()}
    r0 = pipe.analyze(clips[1], boxes=boxes[1])
    reference = pipe.extract_skeleton(r0)
    r1 = pipe.analyze(clips[0], boxes=boxes[0], reference=reference)
    torch.cuda.synchronize()
    check_results([r0, r1], reference)
    for k in launches:
        launches[k] += counters[k].launches - before[k]
    check(counters["preprocess"].launches - before["preprocess"] == 2 * 3,
          "in_frames=3: kernel A runs once per neighbour offset")
    say("options_context_spread_refine", in_frames=3, spread_features=True, refine=True,
        launches={k: counters[k].launches - before[k] for k in counters})
    small = [c[:20] for c in clips[2:4]]
    small_boxes = [b[:20] for b in boxes[2:4]]
    ref_small = Skeleton(keypoints=reference.keypoints[:40].cpu(),
                         valid=reference.valid[:40].cpu())
    replay_on_cpu("options_cpu", pipe, pipes["cpu"], small, small_boxes, ref_small)
    return launches


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def device_kernel_rows(prof) -> list:
    """A profile's kernel rows only: operator rows carry their kernels' time again."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]


def breakdown(pipe, clips, boxes, reference) -> None:
    """Where one analyze_batch chunk spends its time: host stage times
    (each ends in a synchronize; the copy as analyze_batch makes it, not
    overlapped here), then a torch.profiler trace of the device programs
    with the device's busy share and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from golfaction_tpu_torch.pipeline.orchestrator import _Stager

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    with torch.inference_mode():
        prep = stage("prepare_ms", lambda: [pipe._prepare(c, b) for c, b in zip(clips, boxes)])
        stager = _Stager(pipe.device)          # analyze_batch's copy: pinned ring, side stream
        fr = stage("to_device_ms", lambda: stager.claim(stager.upload([p[0] for p in prep])))
        bx, vd = pipe._to_device([p[1] for p in prep]), pipe._to_device([p[2] for p in prep])
        stage("pose_pass_ms", lambda: pipe._pose_pass(fr, bx))
        out = stage("core_ms", lambda: pipe._core_fn(fr, bx, vd))

        def align():
            return pipe._align_batch_fn(out["keypoints"], vd, reference.keypoints,
                                        reference.valid, out["phase_logits"], out.get("kpt_aux"))

        stage("align_ms", align)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = pipe._core_fn(fr, bx, vd)
            align()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    say("breakdown", clips=len(clips), **stages)

    kernels = device_kernel_rows(prof)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    window_ms = stages["core_ms"] + stages["align_ms"]      # the same work, unprofiled
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    say("profile", region="core+align of one chunk", profiled_wall_ms=wall_ms,
        unprofiled_wall_ms=window_ms, device_busy_ms=busy_ms if kernels else "not measured",
        device_idle_share=(1 - busy_ms / window_ms) if kernels else "not measured",
        top=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])


def time_gcn_tail_passes(blocks, tail_x) -> None:
    """Kernel B pass by pass: device microseconds of each of a call's four
    launches, at every other block's width, from a torch.profiler trace of
    three calls.  Run after the host-clock timings of the main path: once a
    process has profiled, each small launch costs its host about a third
    more.  A trace that lacks a pass is taken again, at most three
    sessions a width, and the sessions taken are printed: a profiler
    session can come back without some of its kernel records (one run on
    an H100 ended with passes missing here)."""
    from torch.profiler import ProfilerActivity, profile

    from golfaction_tpu_torch.ops import gcn_tail

    four = ["apply", "gates", "rows", "taps"]
    la_full = torch.full((BATCH_CLIPS,), CLIP_T, dtype=torch.int32, device=tail_x[0].device)
    passes, sessions = {}, {}
    for blk, x in list(zip(blocks, tail_x))[::2]:
        for session in range(1, 4):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    gcn_tail.gcn_block_tail(x, la_full, blk.tail)
                torch.cuda.synchronize()
            got = {e.key.split("tail_")[-1].split("_kernel")[0]: dev_us(e) / e.count
                   for e in device_kernel_rows(prof) if "tail_" in e.key}
            if sorted(got) == four:
                break
        passes[blk.tail.C], sessions[blk.tail.C] = got, session
    say("time_gcn_tail_passes", unit="microseconds per launch", B=BATCH_CLIPS, T=CLIP_T,
        per_width=passes, profiler_sessions=sessions)
    check(all(sorted(p) == four for p in passes.values()),
          "the trace does not show kernel B's four passes at every width: "
          f"{ {C: sorted(p) for C, p in passes.items()} }")


# The distinct epilogue sites of one fused int8 forward at batch 64:
# (R, C, residual mode (0 none, 1 int8, 2 int32 with its own GroupNorm), int8 out).
REQUANT_SITES = ((12288, 64, 0, True), (3072, 64, 0, True), (3072, 64, 1, True),
                 (768, 128, 0, True), (768, 128, 2, True), (768, 128, 1, True),
                 (192, 256, 0, True), (192, 256, 2, True), (192, 256, 1, True),
                 (48, 512, 0, True), (48, 512, 2, True), (48, 512, 1, True),
                 (3072, 128, 0, False))


def requant_occupancy(requant) -> dict:
    """Kernel F's launch at each distinct site shape of the fused forward at
    batch 64: cluster, rows a block, staged or not, shared memory, blocks per
    SM and clusters the card holds at once (cudaOccupancyMaxActiveClusters)."""
    from golfaction_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    max_cluster, sms, l2 = requant.card_limits(dev)
    clusters = _kernels.bind("requant", "requant_max_active_clusters", "iiiii")
    per_sm = _kernels.bind("requant", "requant_blocks_per_sm", "iiii")
    sites = []
    for R, C, mode, i8 in REQUANT_SITES:
        g = requant.launch_geometry(64, R, C, min(32, C), mode, i8, max_cluster=max_cluster,
                                    sms=sms, l2_bytes=l2)
        sites.append({"R": R, "C": C, "residual": ("none", "int8", "conv")[mode],
                      "cluster": g.cluster, "rows_a_block": g.rpb, "staged": g.staged,
                      "smem": g.smem, "threads": g.threads, "bytes_a_thread": 4 * g.wa,
                      "blocks_per_sm": per_sm(g.wa, int(i8), g.threads, g.smem),
                      "max_active_clusters": clusters(g.wa, int(i8), g.cluster, g.threads,
                                                      g.smem)})
    return {"largest_cluster": max_cluster, "sms": sms, "l2_bytes": l2, "sites": sites}


def group_norm_occupancy() -> dict:
    """Kernel G's launch at each distinct site shape of a shipped pose-net
    call at batch 64: cluster, rows a block, staged or not, shared memory,
    blocks per SM and clusters the card holds at once."""
    from golfaction_tpu_torch.ops import _kernels
    from golfaction_tpu_torch.ops import group_norm as kernel_g

    from tests.test_torch_group_norm import SITES

    max_cluster, sms, l2 = kernel_g.card_limits(torch.device("cuda"))
    clusters = _kernels.bind("group_norm", "group_norm_max_active_clusters", "iiii")
    per_sm = _kernels.bind("group_norm", "group_norm_blocks_per_sm", "iii")
    sites = []
    for R, C, mode in dict.fromkeys((H * W, C, mode) for _, H, W, C, mode in SITES):
        g = kernel_g.launch_geometry(64, R, C, min(32, C), 2 if mode == 2 else 1,
                                     max_cluster, sms, l2)
        sites.append({"R": R, "C": C, "epilogue": ("relu", "residual", "shortcut")[mode],
                      "cluster": g.cluster, "rows_a_block": g.rpb, "staged": g.staged,
                      "smem": g.smem, "threads": g.threads,
                      "blocks_per_sm": per_sm(mode, g.threads, g.smem),
                      "max_active_clusters": clusters(mode, g.cluster, g.threads, g.smem)})
    return {"largest_cluster": max_cluster, "sms": sms, "l2_bytes": l2, "sites": sites}


def wavefront_occupancy(softdtw) -> dict:
    """Kernel C's launch at [4, 64, 64] (compare) and [96, 48, 48] (one
    train_align step): rows a lane, warps a table, tables a block, staged,
    blocks per SM (soft and hard)."""
    from golfaction_tpu_torch.ops import _kernels

    fn = _kernels.bind("softdtw", "softdtw_wavefront_blocks_per_sm", "iiiiiii")
    out = {}
    for B, Ta, Tb in ((BATCH_CLIPS, CLIP_T, CLIP_T), (96, 48, 48)):
        g = softdtw.wavefront_geometry(B, Ta, Tb)
        out[f"{B}x{Ta}x{Tb}"] = {**g._asdict(), "blocks_per_sm": [
            fn(Ta, Tb, g.rows, g.warps, g.tables, int(g.staged), soft) for soft in (1, 0)]}
    return out


def backward_occupancy(softdtw) -> dict:
    """Kernel E's launch at [96, 48, 48] (one train_align step) and at
    [8, 128, 64] (the two-launch layout): rows, warps, tables, layout,
    shared memory and blocks per SM."""
    from golfaction_tpu_torch.ops import _kernels

    fn = _kernels.bind("softdtw_bwd", "softdtw_backward_blocks_per_sm", "iiiiiii")
    out = {}
    for B, Ta, Tb in ((96, 48, 48), (8, 128, 64)):
        g = softdtw.backward_geometry(B, Ta, Tb)
        out[f"{B}x{Ta}x{Tb}"] = {**g._asdict(), "blocks_per_sm": fn(
            Ta, Tb, g.rows, g.warps, g.tables, int(g.fits), g.ring)}
    return out


def differing_fields(runs) -> list:
    """The output fields in which two lists of AnalysisResults differ in
    any bit."""
    fields = set()
    for a, b in zip(*runs):
        fields |= {k for k in ("keypoints", "phase_logits", "phase_labels", "error_probs")
                   if not torch.equal(getattr(a, k), getattr(b, k))}
        fields |= {k for k in ("cost", "path", "path_length")
                   if not torch.equal(getattr(a.alignment, k), getattr(b.alignment, k))}
    return sorted(fields)


def compare_determinism(pipe, clips, boxes, reference) -> None:
    """Compare mode twice.  The alignment stage (kernel C, the backtrack,
    warp_by_path, the error head's re-run) from one chunk's keypoints must
    give the same bits; so must two whole analyze_batch runs once cuDNN is
    held to deterministic algorithms.  With cuDNN's default choice the
    fields that differ are reported."""
    with torch.inference_mode():
        prep = [pipe._prepare(c, b) for c, b in zip(clips, boxes)]
        fr, bx, vd = (pipe._to_device([p[k] for p in prep]) for k in range(3))
        out = pipe._core_fn(fr, bx, vd)
        del fr
        align = [pipe._align_batch_fn(out["keypoints"], vd, reference.keypoints, reference.valid,
                                      out["phase_logits"], out.get("kpt_aux"))
                 for _ in range(2)]
    stage_equal = all(torch.equal(align[0][k], align[1][k]) for k in align[0])
    default = differing_fields([pipe.analyze_batch(clips, boxes=boxes, reference=reference)
                                for _ in range(2)])
    torch.backends.cudnn.deterministic = True
    try:
        held = differing_fields([pipe.analyze_batch(clips, boxes=boxes, reference=reference)
                                 for _ in range(2)])
    finally:
        torch.backends.cudnn.deterministic = False
    say("compare_determinism", clips=len(clips), dtype=pipe.cfg.pose.dtype,
        alignment_stage_bit_equal=stage_equal,
        whole_runs_differ_in={"cudnn_default": default, "cudnn_deterministic": held})
    check(stage_equal, "two runs of the alignment stage on the same keypoints differ")
    check(not held, f"two compare-mode runs with deterministic cuDNN differ in {held}")



def kernel_rows_busy_ms(prof) -> float:
    """Device milliseconds of a profile's kernels, copies and fills left out."""
    return sum(dev_us(e) for e in device_kernel_rows(prof)
               if "Memcpy" not in e.key and "Memset" not in e.key) / 1e3


def pose_layers_on_cpu(net, crops) -> list:
    """[(module name, input, output)] of every convolution and GroupNorm of
    the port's PoseNet `net` (on the CPU) on `crops`: the convolutions in
    forward order, then the GroupNorms.  The net calls no GroupNorm module (each goes with its ReLU and residual
    through `precision.group_norm_act`), so each GroupNorm's layer is its
    module on the output of the convolution before it."""
    from golfaction_tpu_torch.models import pose as pose_mod

    kinds = (pose_mod.SameConv2d, pose_mod.Deconv2d, pose_mod.Project)
    norm_of = {"stem": "gn0", "conv1": "gn1", "conv2": "gn2", "proj": "gn3"}
    mods = dict(net.named_modules())
    layers, hooks = [], []
    for name, mod in net.named_modules():
        if isinstance(mod, kinds):
            hooks.append(mod.register_forward_hook(
                lambda m, args, out, name=name: layers.append((name, args[0], out))))
    try:
        with torch.inference_mode():
            net(crops)
            for name, _, out in list(layers):
                head, _, last = name.rpartition(".")
                gn = (f"dgns.{last}" if head == "deconvs"
                      else ".".join(filter(None, (head, norm_of.get(last, "")))))
                if gn in mods and last in norm_of or head == "deconvs":
                    out = out.contiguous(memory_format=torch.channels_last)
                    layers.append((gn, out, mods[gn](out)))
    finally:
        for h in hooks:
            h.remove()
    return layers


def layer_gaps(net, layers, dtype) -> list:
    """(name, share of elements that differ, largest gap over the layer's
    largest |value|) of each of `net`'s layers (on the card) given the CPU
    layer's input at `dtype`, against the CPU layer's output."""
    mods = dict(net.named_modules())
    gaps = []
    with torch.inference_mode():
        for name, x, want in layers:
            got = mods[name](x.to("cuda", dtype)).float().cpu()
            want = want.float()
            gaps.append((name, float((got != want).float().mean()),
                         float((got - want).abs().max() / want.abs().max())))
    return gaps


def shipped_bf16_phase(pipe, pipe32, cpu32, clips, boxes, crops) -> None:
    """The shipped model at its own dtype (bfloat16) on the card against the
    same program on the CPU, with the limits tests/test_torch_e2e_score.py
    holds the port to against flax:
      * layer by layer on two crops: each of the pose network's convolutions
        and GroupNorms on the card, given the CPU's input to that layer,
        differs from the CPU's output on at most 1% of the elements, by at
        most 1e-2 of the layer's largest value (one-ulp flips of another
        order of summation); the float32 control (the same layer at
        float32) differs on more than 99% of them;
      * 2 clips x 20 frames end to end: the card's bfloat16 keypoints lie
        strictly nearer the CPU's bfloat16 ones than the card's float32
        keypoints do (a larger share within 0.5 px, a smaller median gap).
    Printed beside: the labels' agreement with the float32 run, and the pose
    network's milliseconds on one micro-batch of crops at each dtype."""
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    cpu = Pipeline.from_artifacts("artifacts", device="cpu")
    check(cpu.cfg.pose.dtype == pipe.cfg.pose.dtype == "bfloat16", "the shipped dtype")
    layers = pose_layers_on_cpu(cpu.pose_model, crops[:2].cpu())
    gaps = {dt: layer_gaps(pipe.pose_model, layers, dt)
            for dt in (torch.bfloat16, torch.float32)}
    worst = {str(dt).split(".")[1]: {"max_share_differing": max(g[1] for g in gs),
                                     "min_share_differing": min(g[1] for g in gs),
                                     "max_gap_of_layer_peak": max(g[2] for g in gs)}
             for dt, gs in gaps.items()}
    small = [c[:20] for c in clips[2:4]]
    small_boxes = [b[:20] for b in boxes[2:4]]
    runs = {name: p.analyze_batch(small, boxes=small_boxes)
            for name, p in (("card", pipe), ("cpu", cpu), ("card32", pipe32), ("cpu32", cpu32))}

    def valid_rows(name, field):
        return torch.cat([getattr(r, field)[r.valid].cpu().float() for r in runs[name]])

    def share(a, b):
        gap = (valid_rows(a, "keypoints")[..., :2] - valid_rows(b, "keypoints")[..., :2]).norm(
            dim=-1)
        return float((gap <= 0.5).float().mean()), float(gap.median()), float(gap.max())

    card_share, card_median, card_max = share("card", "cpu")
    ctl_share, ctl_median, _ = share("card32", "cpu")
    agree = {f"{a}_vs_{b}": float((valid_rows(a, "phase_labels")
                                   == valid_rows(b, "phase_labels")).float().mean())
             for a, b in (("card", "cpu"), ("card", "card32"), ("cpu", "cpu32"))}
    probs = float(max((g.error_probs.cpu() - c.error_probs).abs().max()
                      for g, c in zip(runs["card"], runs["cpu"])))
    with torch.inference_mode():
        ms = {dt: cuda_ms(lambda p=p: p.pose_model(crops), reps=10)
              for dt, p in (("bfloat16", pipe), ("float32", pipe32))}
    say("shipped_bf16", clips=2, frames=20, dtype=pipe.cfg.pose.dtype,
        pose_layers={"layers": len(layers), "crops": 2, **worst},
        keypoints_card_vs_cpu={"share_within_0_5_px": card_share, "median_px": card_median,
                               "max_px": card_max},
        keypoints_card_f32_vs_cpu={"share_within_0_5_px": ctl_share, "median_px": ctl_median},
        error_probs_card_vs_cpu_max=probs, labels_agree=agree,
        pose_net_ms={"crops": int(crops.shape[0]), **ms, "tf32": False},
        limits={"layers": "share differing <= 0.01, gap <= 1e-2 of the layer's peak; "
                          "the float32 control differs on > 0.99",
                "keypoints": "share above and median below the card float32 control's"})
    for name, differ, gap in gaps[torch.bfloat16]:
        check(differ <= 1e-2 and gap <= 1e-2,
              f"shipped dtype: pose layer {name} on the card differs from the CPU's "
              f"(share {differ}, gap {gap})")
    for name, differ, _ in gaps[torch.float32]:
        check(differ > 0.99, f"shipped dtype: the float32 control of {name} meets the bar")
    check(card_share > ctl_share and card_median < ctl_median,
          "shipped dtype: the card's bfloat16 keypoints are no nearer the CPU's than "
          "its float32 ones")


def batch_overlap_phase(clips, boxes, reference, counters) -> dict:
    """analyze_batch of 12 clips in 3 chunks (clip_batch 4; the smoke's four
    batch clips three times) against three one-chunk calls, cuDNN held to
    deterministic algorithms: equal to the bit.  Frames/s of both forms,
    the copy's milliseconds a chunk, and the card's idle share over each
    form from torch.profiler kernel rows (copies left out)."""
    from torch.profiler import ProfilerActivity, profile

    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    pipe = Pipeline.from_artifacts("artifacts", device="cuda", overrides=["clip_batch=4"])
    four, four_boxes = clips[2:6], boxes[2:6]
    twelve, twelve_boxes = four * 3, four_boxes * 3

    def three_chunks():
        return pipe.analyze_batch(twelve, boxes=twelve_boxes, reference=reference)

    def one_chunk_calls():
        out, copy_ms = [], []
        for _ in range(3):
            out += pipe.analyze_batch(four, boxes=four_boxes, reference=reference)
            copy_ms += pipe.last_copy_ms
        return out, copy_ms

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def idle_share(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        busy = kernel_rows_busy_ms(prof)
        return (1 - busy / (wall * 1e3)) if busy else None, wall * 1e3, busy

    def median_run(runs):
        """The run of median idle share; (None, ...) if any run lacks device rows."""
        if any(r[0] is None for r in runs):
            return None, [r[1] for r in runs], [r[2] for r in runs]
        return sorted(runs, key=lambda r: r[0])[len(runs) // 2]

    torch.backends.cudnn.deterministic = True
    try:
        three_chunks()                                   # warm
        for fn in counters.values():
            fn.launches = 0
        res3, wall3 = timed(three_chunks)
        launches = {k: fn.launches for k, fn in counters.items()}
        copy3, stats = list(pipe.last_copy_ms), dict(pipe.last_batch_stats)
        (res1, copy1), wall1 = timed(one_chunk_calls)
        # Three profiled runs of each form, alternating; the median of each
        # is compared (the host clock spreads from run to run).
        runs3, runs1 = [], []
        for _ in range(3):
            runs3.append(idle_share(three_chunks))
            runs1.append(idle_share(one_chunk_calls))
        idle3, idle1 = (median_run(r) for r in (runs3, runs1))
    finally:
        torch.backends.cudnn.deterministic = False
    differ = differing_fields([res3, res1])
    frames = len(twelve) * CLIP_T
    say("batch_overlap", clips=len(twelve), chunks=3, clip_batch=4, frames=frames,
        hw=list(VIDEO_HW), reference=True, launches=launches, differ_in=differ,
        frames_per_s={"three_chunk_call": frames / wall3, "three_one_chunk_calls": frames / wall1},
        wall_s={"three_chunk_call": wall3, "three_one_chunk_calls": wall1},
        copy_ms_per_chunk={"three_chunk_call": copy3, "one_chunk_calls": copy1},
        device_idle_share={"three_chunk_call": idle3[0], "three_one_chunk_calls": idle1[0]},
        profiled_wall_ms={"three_chunk_call": idle3[1], "three_one_chunk_calls": idle1[1]},
        device_busy_ms={"three_chunk_call": idle3[2], "three_one_chunk_calls": idle1[2]},
        device_idle_share_runs={"three_chunk_call": [r[0] for r in runs3],
                                "three_one_chunk_calls": [r[0] for r in runs1]},
        last_batch_stats=stats)
    check(len(res3) == len(res1) == 12 and not differ,
          f"3-chunk analyze_batch differs from one-chunk calls in {differ}")
    for k in ("preprocess", "gcn_tail", "softdtw"):
        check(launches[k] > 0, f"batch_overlap: kernel {k} was not launched")
    check(idle3[0] is not None and idle1[0] is not None, "batch_overlap: no device rows")
    check(idle3[0] < idle1[0], "batch_overlap: the 3-chunk call idles the card no less than "
                               "one-chunk calls")
    return launches


def stream_cli_phase(pipe, clip, counters) -> tuple[dict, dict]:
    """One 1080p clip through analyze_stream (one 64-frame window) and
    through `cli analyze --report --render`: the emitted keypoints equal the
    same frames' _core_fn output on the card (cuDNN deterministic), the
    report and the overlay video are written."""
    import contextlib
    import io
    import tempfile

    from golfaction_tpu_torch import cli
    from golfaction_tpu_torch.pipeline import streaming, video_io, visualize

    def core_keypoints(frames):
        bx = video_io.estimate_person_boxes(frames)
        with torch.inference_mode():
            out = pipe._core_fn(pipe._to_device([frames]), pipe._to_device([bx]),
                                pipe._to_device([np.ones(len(frames), bool)]))
        return out["keypoints"][0].cpu().numpy()

    torch.backends.cudnn.deterministic = True
    try:
        for fn in counters.values():
            fn.launches = 0
        emitted = list(streaming.analyze_stream(pipe, iter(clip), window=CLIP_T, hop=CLIP_T))
        stream_launches = {k: fn.launches for k, fn in counters.items()}
        check([r["frame_index"] for r in emitted] == list(range(CLIP_T)), "stream: frames")
        stream_kp = np.stack([r["keypoints"] for r in emitted])
        stream_equal = bool(np.array_equal(stream_kp, core_keypoints(clip)))
        with tempfile.TemporaryDirectory() as d:
            mp4 = f"{d}/swing.mp4"
            visualize.write_video(mp4, clip, fps=30)
            for fn in counters.values():
                fn.launches = 0
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["analyze", mp4, "--checkpoint", "artifacts", "--report", "--render",
                          f"{d}/overlay.mp4", "--out", f"{d}/res.json"])
            cli_launches = {k: fn.launches for k, fn in counters.items()}
            with open(f"{d}/res.json") as f:
                res = json.load(f)
            cli_kp = np.asarray(res["keypoints"], np.float32)
            cli_equal = bool(np.array_equal(cli_kp, core_keypoints(video_io.load_video(mp4)[0])))
            overlay = len(video_io.load_video(f"{d}/overlay.mp4")[0])
    finally:
        torch.backends.cudnn.deterministic = False
    say("stream", frames=CLIP_T, window=CLIP_T, hop=CLIP_T, hw=list(VIDEO_HW),
        launches=stream_launches, keypoints_equal_core=stream_equal,
        phases=[r["phase"] for r in emitted[:4]])
    say("cli", call="analyze --checkpoint artifacts --report --render --out",
        launches=cli_launches, keypoints_equal_core=cli_equal, num_frames=res["num_frames"],
        report_phases=len(res["report"]["phases"]), overlay_frames=overlay,
        error_flags=res["error_flags"])
    check(stream_equal, "stream: emitted keypoints differ from _core_fn on the same frames")
    check(cli_equal, "cli: keypoints differ from _core_fn on the same frames")
    check(res["num_frames"] == CLIP_T and overlay == CLIP_T and res["report"]["phases"],
          "cli: report or overlay missing")
    for name, launches in (("stream", stream_launches), ("cli", cli_launches)):
        for k in ("preprocess", "gcn_tail"):
            check(launches[k] > 0, f"{name}: kernel {k} was not launched")
    return stream_launches, cli_launches


def _leaf_keys(tree) -> dict:
    return {k: _leaf_keys(v) if isinstance(v, dict) else None for k, v in tree.items()}


def e2e_score_phase(counters) -> tuple[dict, dict]:
    """demo_e2e at small counts (2 clips, one per fault plus two clean, one
    clip per held-out family, one jitter clip; 48 frames at 540x960) into
    a temporary directory: the JSON keys of the JAX script's shipped result
    (artifacts/demo/e2e_metrics.json), every score finite in [0, 1], the
    comparison video written.  Returns the launches and the metrics (the
    retrain_chain phase promotes them as demo/)."""
    import contextlib
    import io
    import os
    import tempfile

    from golfaction_tpu_torch import demo_e2e

    with open("artifacts/demo/e2e_metrics.json") as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory() as d:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            got = demo_e2e.main(["--artifacts", "artifacts", "--out", d, "--clips", "2",
                                 "--per-fault", "1", "--domain-clips", "1",
                                 "--jitter-clips", "1"])
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        video = os.path.getsize(got["comparison_video"])
    scores = [got["pck05_mean"], got["phase_acc_mean"], got["phase_f1_mean"],
              got["align_progress_err_mean"], *got["error_detection"].values(),
              *(got["jitter_eval"][k] for k in ("pck05_motion_boxes", "pck05_refined_boxes")),
              *(v for fam in got["unseen_domain"].values()
                for k, v in fam.items() if k != "clips"),
              *(v for f in got["error_detection_per_fault"].values()
                for k, v in f.items() if k != "support")]
    say("e2e_score", clips=got["clips"], error_eval_clips=got["error_eval_clips"], frames=48,
        hw=[540, 960], seconds=round(seconds, 3), launches=launches, video_bytes=video,
        summary={k: got[k] for k in ("pck05_mean", "phase_acc_mean", "phase_f1_mean",
                                     "error_detection", "align_progress_err_mean")})
    check(_leaf_keys(got) == _leaf_keys(want), "e2e_score: the JSON keys differ from the JAX "
                                               "script's")
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in scores),
          "e2e_score: a score is not finite in [0, 1]")
    check(video > 0, "e2e_score: no comparison video")
    for k in ("preprocess", "gcn_tail", "softdtw"):
        check(launches[k] > 0, f"e2e_score: kernel {k} was not launched")
    return launches, got


def logger_check(pipe, clip, boxes) -> None:
    """One analyze with a JsonlLogger on a temporary file: one "analyze"
    event carrying frames, bucket, hw and wall_ms."""
    import tempfile

    from golfaction_tpu_torch.utils.logging import JsonlLogger

    with tempfile.TemporaryDirectory() as d:
        pipe.logger = JsonlLogger(f"{d}/events.jsonl")
        try:
            pipe.analyze(clip, boxes=boxes)
        finally:
            pipe.logger.close()
            pipe.logger = None
        with open(f"{d}/events.jsonl") as f:
            events = [json.loads(line) for line in f]
    say("logger", events=events)
    check(len(events) == 1 and events[0]["event"] == "analyze", "logger: not one analyze event")
    ev = events[0]
    check(ev["frames"] == len(clip) and ev["bucket"] >= len(clip)
          and ev["hw"] == list(clip.shape[1:3]) and ev["wall_ms"] > 0,
          f"logger: the analyze event's fields are wrong: {ev}")


BENCH_ARGS = ("--clips", "2", "--e2e-clips", "4", "--iters", "2", "--impl-compare")


def bench_phase() -> dict:
    """`cli bench` in a subprocess (its own process, as a user runs it): rc 0
    and the rates of its last JSON line; returns the launches it counted."""
    cmd = [sys.executable, "-m", "golfaction_tpu_torch.cli", "bench", *BENCH_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"bench: rc {proc.returncode}")
    check(bool(lines), "bench: no JSON line")
    res = json.loads(lines[-1])
    rates = {k: res.get(k) for k in ("value", "e2e_fps", "pose_fps", "softdtw_pairs_per_s")}
    buckets = res.get("gcn_fps_by_bucket") or {}
    shares = {k: res.get(k) for k in ("sol_vs_peak", "mfu_vs_peak")}
    say("bench", call="cli bench " + " ".join(BENCH_ARGS), seconds=round(seconds, 3),
        device=res.get("device"), power_limit=res.get("power_limit"), **rates,
        gcn_fps_by_bucket=buckets, gcn_tail_graph_ms_by_bucket=res.get(
            "gcn_tail_graph_ms_by_bucket"), **shares, sol_tflops=res.get("sol_tflops"),
        effective_tflops=res.get("effective_tflops"), flops_per_call=res.get("flops_per_call"),
        stages={k: v["mean_ms"] for k, v in (res.get("stages") or {}).items()},
        impl_compare=res.get("impl_compare"), launches=res.get("launches"))
    check(all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0 for v in rates.values()),
          f"bench: a rate is not finite and positive: {rates}")
    check(len(buckets) == 4 and all(np.isfinite(v) and v > 0 for v in buckets.values()),
          f"bench: gcn_fps_by_bucket is not four finite positive rates: {buckets}")
    check(all(isinstance(v, (int, float)) and 0 < v <= 1.05 for v in shares.values()),
          f"bench: a share of the peak is outside (0, 1.05]: {shares}")
    launches = res.get("launches") or {}
    for k in ("preprocess", "gcn_tail", "softdtw"):
        check(launches.get(k, 0) > 0, f"bench: kernel {k} was not launched")
    return launches


# ---------------------------------------------------------------------------
# 16. cascade: the cascade fine-tune and the threshold calibration
# ---------------------------------------------------------------------------

CASCADE_ARGS = ("--clips", "4", "--aug", "16", "--calib-clips", "1", "--frames", "48",
                "--hw", "540", "960", "--steps", "10", "--error-steps", "10",
                "--refine-steps", "4")
# The card against the CPU at float32 from one collection: steps of each stage.
CASCADE_VS_CPU = ("--steps", "3", "--error-steps", "3", "--refine-steps", "2")


def tree_digest(root: str) -> dict:
    """{relative path: sha256} of every file under `root`."""
    import hashlib
    import os

    out = {}
    for dirpath, _, files in os.walk(root):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _state_rel(got: dict, want: dict, norm: str = "fro") -> float:
    """The largest relative gap of any tensor: ||got - want|| / ||want||
    ("fro"), or its largest element gap over its largest |value| ("max")."""
    def rel(a, b):
        d = a.cpu() - b
        if norm == "max":
            return float(d.abs().max()) / max(float(b.abs().max()), 1e-12)
        return float(d.norm()) / max(float(b.norm()), 1e-12)

    return max(rel(got[k], want[k]) for k in want)


def cascade_vs_cpu(collection: dict) -> dict:
    """The refiner, GCN and error-head stages from the shipped weights at
    float32 on one collection, on the card and on the CPU, the same numpy
    generators on both: every step's loss within rel 1e-4 (so the
    parameters after all but the last step agree where they move the
    loss), and every parameter within twice the stage's summed learning
    rate of the CPU's.  Where an element's gradient is float noise, AdamW
    normalises it to a step of about the learning rate whose sign the noise
    picks, so single elements do differ by that much: the line reports each
    stage's largest per-tensor ||card - cpu|| / ||cpu|| (`param_rel`) and
    largest element gap over its tensor's peak (`param_max_rel`)."""
    from golfaction_tpu_torch import cascade_finetune as cf
    from golfaction_tpu_torch import checkpoint, weights
    from golfaction_tpu_torch.pipeline.orchestrator import init_params

    args = cf.parse_args(["--artifacts", "artifacts", "--out", "unused", *CASCADE_ARGS,
                          *CASCADE_VS_CPU, *(a for s in FLOAT32 for a in ("--set", s))])
    cfg = cf.cascade_config(args)
    params = {**init_params(cfg, 0), **weights.from_flax(checkpoint.load_params("artifacts"))}
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        got, losses, _ = cf.train_stages(args, cfg, params, collection, torch.device(dev),
                                         lambda name, t: time.perf_counter(), log=lambda m: None)
        runs[dev] = (got, losses, time.perf_counter() - t0)
    (card, lc, sc), (cpu, lp, sp) = runs["cuda"], runs["cpu"]
    loss_rel = {k: max(abs(a - b) / abs(b) for a, b in zip(lc[k], lp[k])) for k in lp}
    param_rel = {k: _state_rel(card[k], cpu[k]) for k in ("refine", "gcn", "error")}
    out = {"steps": {k: len(v) for k, v in lp.items()}, "loss_card": lc, "loss_cpu": lp,
           "loss_rel": loss_rel, "param_rel": param_rel,
           "param_max_rel": {k: _state_rel(card[k], cpu[k], "max") for k in param_rel},
           "param_max_abs": {k: max(float((card[k][n].cpu() - cpu[k][n]).abs().max())
                                    for n in cpu[k]) for k in param_rel},
           "seconds_card": round(sc, 3), "seconds_cpu": round(sp, 3)}
    check(out["steps"] == {"refine": 2, "gcn": 3, "error": 3}, f"cascade_vs_cpu: {out['steps']}")
    check(all(v <= 1e-4 for v in loss_rel.values()),
          f"cascade_vs_cpu: losses differ by more than rel 1e-4: {loss_rel}")
    lr = {"refine": 1e-3, "gcn": args.lr, "error": args.error_lr or args.lr}
    bound = {k: 2 * out["steps"][k] * lr[k] for k in lr}
    check(all(out["param_max_abs"][k] <= bound[k] for k in bound),
          f"cascade_vs_cpu: a parameter moved apart by more than twice the summed learning "
          f"rate {bound}: {out['param_max_abs']}")
    return out


def cascade_phase(counters) -> dict:
    """`cascade_finetune` on the shipped tree at full width and its dtype
    (CASCADE_ARGS) into a temporary folder, then `calibrate_thresholds
    --per-fault 1` on the new tree: artifacts/ byte for byte unchanged, every
    loss finite, every threshold on the grid, the new tree loaded and run,
    kernels A, B and C launched; then the stages on the card against the CPU
    (cascade_vs_cpu).  Prints the seconds of each stage."""
    import contextlib
    import io
    import tempfile

    from golfaction_tpu_torch import calibrate_thresholds, cascade_finetune
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    before = tree_digest("artifacts")
    grid = set(np.round(np.linspace(0.20, 0.90, 15), 6))
    with tempfile.TemporaryDirectory() as d:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = cascade_finetune.main(["--artifacts", "artifacts", "--out", f"{d}/tree",
                                         *CASCADE_ARGS])
            t1 = time.perf_counter()
            cal = calibrate_thresholds.main(["--artifacts", f"{d}/tree", "--out", f"{d}/cal",
                                             "--per-fault", "1"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = {k: fn.launches for k, fn in counters.items()}
        pipe = Pipeline.from_artifacts(f"{d}/tree", device="cuda")
        clip = render_clip(swing_keypoints(48, np.random.default_rng(5)), seed=5)
        out = pipe.analyze(clip)
        loaded = {"refiner": pipe.refine_model is not None,
                  "finite": bool(torch.isfinite(out.error_probs).all()
                                 and torch.isfinite(out.keypoints).all())}
        del pipe
    after = tree_digest("artifacts")
    losses = res["losses"]
    thr = {"cascade": res["thresholds_values"], "calibrate": cal["values"]}
    say("cascade", call="cascade_finetune " + " ".join(CASCADE_ARGS),
        stage_seconds={k: round(v, 3) for k, v in res["seconds"].items()},
        cascade_seconds=round(t1 - t0, 3), calibrate_seconds=round(t2 - t1, 3),
        clips=res["clips"], losses=losses, thresholds=thr, launches=launches, loaded=loaded,
        artifacts_unchanged=before == after)
    check(before == after, "cascade: artifacts/ changed")
    check(all(np.isfinite(v) for stage in losses.values() for v in stage)
          and {k: len(v) for k, v in losses.items()} == {"refine": 4, "gcn": 10, "error": 10},
          f"cascade: losses {losses}")
    check(all(round(v, 6) in grid for t in thr.values() for v in t.values())
          and all(len(t) == 8 for t in thr.values()), f"cascade: a threshold off the grid {thr}")
    check(loaded["refiner"] and loaded["finite"], f"cascade: the new tree {loaded}")
    for k in ("preprocess", "gcn_tail", "softdtw"):
        check(launches[k] > 0, f"cascade: kernel {k} was not launched")
    say("cascade_vs_cpu", clips=res["clips"], **cascade_vs_cpu(res["collection"]))
    return launches


# ---------------------------------------------------------------------------
# 17. retrain_chain: train_eval, the probes, promote, import_pose, the bwd bench
# ---------------------------------------------------------------------------

# A short training run at the default widths and the script's 160-clip pose
# pool.  train_align takes half the steps.
RETRAIN_STEPS = 8
RETRAIN_ARGS = ("--steps", str(RETRAIN_STEPS), "--pose-steps", "2", "--eval-clips", "8")
PROBE_ARGS = ("--artifacts", "artifacts", "--pairs", "1")
BWD_POINTS = (64, 192)          # B at T = 128: the JAX script's two recorded points
BWD_ARGS = ("--T", "128", "--iters", "3", "--scan-timeout", "30")


def _counted(counters) -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items()}


def _quiet(main, argv):
    """main(argv) with its stdout swallowed (its JSON goes into our lines)."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def mmpose_state_dict(cfg, seed: int = 0) -> dict:
    """A pose checkpoint as MMPose writes one, built in memory (the layout of
    tests/test_torch_import_weights.py): in definition order, backbone
    convolutions (OIHW) each with a BatchNorm (weight, bias, running
    statistics, num_batches_tracked), the head's ConvTranspose2d (IOHW) each
    with its BatchNorm, then the final 1x1 convolution and its bias."""
    from golfaction_tpu_torch.models.pose import PoseNet
    from golfaction_tpu_torch.train import import_weights

    rng = np.random.default_rng(seed)
    shapes = {n: tuple(t.shape) for n, t in PoseNet(cfg).state_dict().items()}
    sd = {}
    for i, (name, _) in enumerate(import_weights.pose_param_order(cfg)):
        if name.endswith(".bias") and not name.startswith("final"):
            continue                                   # written with its BatchNorm
        shape = shapes[name]
        if len(shape) == 1 and not name.startswith("final"):
            prefix = f"backbone.layer{i}.bn"
            sd[f"{prefix}.weight"] = torch.from_numpy(rng.normal(1, 0.1, shape).astype("f4"))
            sd[f"{prefix}.bias"] = torch.from_numpy(rng.normal(0, 0.1, shape).astype("f4"))
            sd[f"{prefix}.running_mean"] = torch.from_numpy(rng.normal(0, 1, shape).astype("f4"))
            sd[f"{prefix}.running_var"] = torch.from_numpy(rng.uniform(0.5, 2, shape).astype("f4"))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)
        else:
            key = f"keypoint_head.layer{i}.{name.split('.')[-1]}"
            sd[key] = torch.from_numpy(rng.normal(0, 0.05, shape).astype("f4"))
    return sd


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _finite_analyze(root: str) -> dict:
    """Pipeline.from_artifacts(root) on the card, one rendered 48-frame clip
    analyzed: {"finite", "keypoints" shape}."""
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    pipe = Pipeline.from_artifacts(root, device="cuda")
    res = pipe.analyze(render_clip(swing_keypoints(48, np.random.default_rng(11)), seed=11))
    return {"finite": bool(torch.isfinite(res.keypoints).all()
                           and torch.isfinite(res.error_probs).all()),
            "keypoints": list(res.keypoints.shape)}


def retrain_eval_and_train(d: str, counters, seconds: dict, paths: dict) -> str:
    """train_eval --eval-only on a copy of the shipped checkpoints, then a
    short training run (--skip pose, then pose alone into the same tree):
    returns the trained tree."""
    import os
    import shutil

    from golfaction_tpu_torch import train_eval

    shipped = f"{d}/shipped"
    shutil.copytree("artifacts/params", f"{shipped}/params")
    with open("artifacts/metrics.json") as f:
        recorded = json.load(f)
    _zero(counters)
    t0 = time.perf_counter()
    ev = _quiet(train_eval.main, ["--out", shipped, "--eval-only"])["metrics"]
    seconds["eval_only"] = time.perf_counter() - t0
    paths["retrain_eval_only"] = _counted(counters)
    numbers = {"pose.eval_pck05": (ev["pose"]["eval_pck05"], recorded["pose"]["eval_pck05"]),
               "gcn.eval_f1": (ev["gcn"]["eval_f1"], recorded["gcn"]["eval_f1"]),
               "error.eval.f1": (ev["error"]["eval"]["f1"], recorded["error"]["eval"]["f1"]),
               "error.eval_with_ref.f1": (ev["error"]["eval_with_ref"]["f1"],
                                          recorded["error"]["eval_with_ref"]["f1"]),
               "align.eval_progress_err": (ev["align"]["eval_progress_err"],
                                           recorded["align"]["eval_progress_err"])}
    say("retrain_eval_only", seconds=round(seconds["eval_only"], 3),
        port_vs_metrics_json=numbers, launches=paths["retrain_eval_only"],
        note="a record: the shipped GCN and error head were fine-tuned after "
             "artifacts/metrics.json was written")
    for k in ("preprocess", "gcn_tail", "softdtw", "decode"):
        check(paths["retrain_eval_only"][k] > 0, f"retrain_eval_only: kernel {k} not launched")

    tree = f"{d}/train"
    _zero(counters)
    t0 = time.perf_counter()
    first = _quiet(train_eval.main, ["--out", tree, "--skip", "pose", *RETRAIN_ARGS])
    seconds["train_gcn_error_align"] = time.perf_counter() - t0
    skel = _counted(counters)
    _zero(counters)
    t0 = time.perf_counter()
    res = _quiet(train_eval.main, ["--out", tree, "--skip", "gcn", "error", "align",
                                   *RETRAIN_ARGS])
    seconds["train_pose"] = time.perf_counter() - t0
    pose_launches = _counted(counters)
    paths["retrain_train"] = {k: skel[k] + pose_launches[k] for k in skel}
    m = res["metrics"]
    align_steps = RETRAIN_STEPS // 2
    losses = {k: [h["loss"] for h in m[k]["history"]] for k in ("pose", "gcn", "align", "error")}
    keys = {"pose": {"history", "eval_pck05", "checkpoint"},
            "gcn": {"history", "eval_acc", "eval_f1", "checkpoint"},
            "error": {"history", "eval", "eval_with_ref", "checkpoint"},
            "align": {"history", "eval_progress_err", "checkpoint"}}
    loaded = _finite_analyze(tree)
    say("retrain_train", call="train_eval " + " ".join(RETRAIN_ARGS),
        seconds={k: round(v, 3) for k, v in {**first["seconds"], **res["seconds"]}.items()},
        losses=losses, metrics={k: {kk: vv for kk, vv in v.items() if kk != "history"}
                                if isinstance(v, dict) else v for k, v in m.items()},
        launches_skeleton_models=skel, launches_pose=pose_launches, loaded=loaded)
    check(all(np.isfinite(v) for vs in losses.values() for v in vs), f"retrain: losses {losses}")
    check(all(set(m[k]) == ks for k, ks in keys.items()) and "wall_time_s" in m,
          f"retrain: metrics.json keys {({k: sorted(v) for k, v in m.items() if isinstance(v, dict)})}")
    check(sorted(os.listdir(f"{tree}/params")) == ["align.npz", "error.npz", "gcn.npz",
                                                   "pose.npz"], "retrain: npz files")
    check(loaded["finite"], f"retrain: the new tree {loaded}")
    # One forward wavefront and one backward a train_align step (4 of them),
    # one wavefront for the evaluation's hard paths.
    check(skel["softdtw_bwd"] == align_steps and skel["softdtw"] == align_steps + 1,
          f"retrain: train_align launched C {skel['softdtw']} and E {skel['softdtw_bwd']} "
          f"times for {align_steps} steps")
    for k in ("preprocess", "decode"):
        check(pose_launches[k] > 0, f"retrain: kernel {k} not launched on the pose training")
    check(skel["gcn_tail"] > 0, "retrain: kernel B not launched by the GCN evaluation")
    return tree


def retrain_probes(d: str, staged: str, counters, seconds: dict, paths: dict) -> None:
    """The three probes on the shipped tree at --pairs 1 and their default
    frames and size, each written into the staged tree; their gains beside
    the committed profiles."""
    from golfaction_tpu_torch import probe_arm_gain, probe_heatmap_modes, probe_heatmap_spread

    committed = {}
    for name in ("probe_arm_gain", "probe_heatmap_modes", "probe_heatmap_spread"):
        with open(f"artifacts/{name}.json") as f:
            committed[name] = json.load(f)
    _zero(counters)
    t0 = time.perf_counter()
    arm = _quiet(probe_arm_gain.main, [*PROBE_ARGS, "--out", f"{staged}/probe_arm_gain.json"])
    seconds["probe_arm_gain"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    modes = _quiet(probe_heatmap_modes.main, [*PROBE_ARGS, "--out",
                                              f"{staged}/probe_heatmap_modes.json"])
    seconds["probe_heatmap_modes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spread = _quiet(probe_heatmap_spread.main, [*PROBE_ARGS, "--out",
                                                f"{staged}/probe_heatmap_spread.json"])
    seconds["probe_heatmap_spread"] = time.perf_counter() - t0
    paths["retrain_probes"] = launches = _counted(counters)
    c_arm, c_modes, c_spread = (committed[k] for k in ("probe_arm_gain", "probe_heatmap_modes",
                                                       "probe_heatmap_spread"))
    say("retrain_probes", pairs=1, frames=48, hw=[540, 960],
        seconds={k: round(seconds[k], 3) for k in ("probe_arm_gain", "probe_heatmap_modes",
                                                   "probe_heatmap_spread")},
        arm_mean_gain=[arm["arm_mean_gain"], c_arm["arm_mean_gain"]],
        drift_mean_gain=[arm["drift_mean_gain"], c_arm["drift_mean_gain"]],
        mean_gain_by_fault={f: [e["mean_gain"], c_arm["faults"][f]["mean_gain"]]
                            for f, e in arm["faults"].items()},
        modes_chicken_wing=[modes and modes["summary"],
                            c_modes["faults"].get("chicken_wing")],
        spread={f: {"port": {k: e.get(k) for k in ("beta", "gain_dev_only", "gain_combo_lopo",
                                                   "excess_auc_vs_twin")},
                    "committed": {k: c_spread["faults"][f].get(k)
                                  for k in ("beta", "gain_dev_only", "gain_combo_lopo",
                                            "excess_auc_vs_twin")}}
                for f, e in spread["faults"].items()},
        launches=launches, note="a record beside the committed profiles (4 pairs, "
                                "from the JAX package), not a bar")
    check(list(arm) == list(c_arm) and list(arm["faults"]) == list(c_arm["faults"]),
          "retrain_probes: the arm-gain JSON's layout differs from the committed one")
    check(list(spread) == list(c_spread) and list(spread["faults"]) == list(c_spread["faults"]),
          "retrain_probes: the spread JSON's layout differs from the committed one")
    check(all(np.isfinite(e["mean_gain"]) for e in arm["faults"].values()),
          "retrain_probes: a gain is not finite")
    for k in ("preprocess", "gcn_tail", "decode"):
        check(launches[k] > 0, f"retrain_probes: kernel {k} not launched")


def retrain_promote(d: str, staged: str, e2e: dict, seconds: dict) -> dict:
    """Promote the trained tree, with the probes' profiles, a pose_meta.json
    and the e2e_score phase's demo_e2e metrics as demo/, into a copy of
    artifacts/: the gate's pass and miss, the float16 checkpoints, the
    sidecars, demo/, and a destination with a step folder refused."""
    import os
    import shutil

    from golfaction_tpu_torch import checkpoint, promote_artifacts

    checkpoint.save_pose_meta(staged, sigma=2.0)
    os.makedirs(f"{staged}/demo")
    with open(f"{staged}/demo/e2e_metrics.json", "w") as f:
        json.dump(e2e, f, indent=1)
    overall = float(e2e["error_detection"]["f1"])
    dest = f"{d}/dest"
    shutil.copytree("artifacts", dest)
    out = {}
    try:
        _quiet(promote_artifacts.main, ["--staged", staged, "--artifacts", dest,
                                        "--gate", f"overall={overall + 0.01!r}"])
        out["miss_exit"] = 0
    except SystemExit as e:
        out["miss_exit"] = e.code
    out["unchanged_after_miss"] = tree_digest(dest) == tree_digest("artifacts")
    t0 = time.perf_counter()
    res = _quiet(promote_artifacts.main, ["--staged", staged, "--artifacts", dest,
                                          "--gate", f"overall={overall!r}"])
    seconds["promote"] = time.perf_counter() - t0
    fp16 = {}
    for name in ("pose", "gcn", "error", "align"):
        with np.load(f"{dest}/params/{name}.npz") as z, np.load(f"{staged}/params/{name}.npz") as s:
            fp16[name] = (all(z[k].dtype == np.float16 for k in z.files)
                          and all(np.array_equal(z[k], s[k].astype(np.float16)) for k in s.files))
    sidecars = {f: _bytes(f"{dest}/{f}") == _bytes(f"{staged}/{f}") for f in ("pose_meta.json", "probe_arm_gain.json", "probe_heatmap_modes.json",
                          "probe_heatmap_spread.json", "demo/e2e_metrics.json")}
    kept = {f: _bytes(f"{dest}/{f}") == _bytes(f"artifacts/{f}")
            for f in ("error_thresholds.json", "demo/compare.mp4")}
    refused = f"{d}/dest_orbax"
    shutil.copytree(dest, refused)
    os.makedirs(f"{refused}/params/gcn/step_00000001")
    try:
        promote_artifacts.main(["--staged", staged, "--artifacts", refused])
        out["step_dir_refused"] = False
    except ValueError as e:
        out["step_dir_refused"] = "params/gcn/step_00000001" in str(e)
    loaded = _finite_analyze(dest)
    say("retrain_promote", gate_overall=overall, promoted=res["written"], float16=fp16,
        sidecars_copied=sidecars, kept_from_destination=kept, loaded=loaded,
        seconds=round(seconds["promote"], 3), **out)
    check(out["miss_exit"] == 1 and out["unchanged_after_miss"],
          f"retrain_promote: a gate miss {out}")
    check(all(fp16.values()) and all(sidecars.values()) and all(kept.values()),
          f"retrain_promote: {fp16} {sidecars} {kept}")
    check(out["step_dir_refused"], "retrain_promote: a destination step folder was not refused")
    check(loaded["finite"], f"retrain_promote: the promoted tree {loaded}")
    return out


def retrain_import(d: str, counters, seconds: dict, paths: dict) -> None:
    """An MMPose-style state dict at the pose net's full width, saved as a
    .pth, imported by import_pose and run through Pipeline.from_artifacts."""
    from golfaction_tpu_torch import config as cfg_mod
    from golfaction_tpu_torch import import_pose

    sd = mmpose_state_dict(cfg_mod.PoseConfig())
    torch.save(sd, f"{d}/pose.pth")
    t0 = time.perf_counter()
    line = _quiet(import_pose.main, [f"{d}/pose.pth", "--out", f"{d}/imported"])
    seconds["import_pose"] = time.perf_counter() - t0
    _zero(counters)
    loaded = _finite_analyze(f"{d}/imported")
    paths["retrain_import"] = _counted(counters)
    say("retrain_import", tensors=len(sd), imported=line["imported"], coverage=line["coverage"],
        seconds=round(seconds["import_pose"], 3), loaded=loaded,
        launches=paths["retrain_import"])
    check(line["coverage"] == 1.0 and loaded["finite"], f"retrain_import: {line} {loaded}")


def retrain_bwd_bench(counters, seconds: dict, paths: dict) -> None:
    """softdtw_bwd_bench at B 64 and 192, T 128 (kernel E's two-launch
    layout): first call and step seconds of both paths; then E alone at
    those shapes by events and in a graph, beside its bound, and C's
    forward at the same shapes in a graph."""
    from golfaction_tpu_torch import softdtw_bwd_bench
    from golfaction_tpu_torch.ops import softdtw

    _zero(counters)
    t0 = time.perf_counter()
    runs = [_quiet(softdtw_bwd_bench.main, ["--B", str(B), *BWD_ARGS]) for B in BWD_POINTS]
    seconds["softdtw_bwd_bench"] = time.perf_counter() - t0
    paths["retrain_bwd_bench"] = launches = _counted(counters)
    say("retrain_bwd_bench", runs=runs, launches=launches,
        seconds=round(seconds["softdtw_bwd_bench"], 3))
    for r in runs:
        check(r["backward_geometry"]["fits"] is False
              and all(r[p]["step_s"] and np.isfinite(r[p]["step_s"]) for p in ("kernel", "plain")),
              f"retrain_bwd_bench: {r}")
    calls = 1 + int(BWD_ARGS[BWD_ARGS.index("--iters") + 1])
    check(launches["softdtw"] == launches["softdtw_bwd"] == len(BWD_POINTS) * calls,
          f"retrain_bwd_bench: {launches}")
    for B in BWD_POINTS:
        ea, eb = softdtw_bwd_bench.inputs(B, 128, 32, "cuda")
        D = softdtw.pairwise_sqdist(ea, eb).contiguous()
        R = softdtw.wavefront(D, 0.1)
        geo = softdtw.backward_geometry(B, 128, 128)
        nb, ops = softdtw_bwd_bytes_ops(B, 128, 128)
        bms, by = bound(nb, ops)
        gms = graph_ms(lambda: softdtw.softdtw_backward(D, R, 0.1))
        say("time_softdtw_bwd_two_launch", shape=[B, 128, 128], gamma=0.1,
            layout={"rows": geo.rows, "warps": geo.warps, "tables": geo.tables,
                    "fits": geo.fits, "ring": geo.ring},
            ms=cuda_ms(lambda: softdtw.softdtw_backward(D, R, 0.1)), graph_ms=gms,
            ns_per_diagonal=gms / 255 * 1e6, bound_ms=bms, bound_by=by,
            plain_ms=cuda_ms(lambda: softdtw.softdtw_backward_plain(D, R, 0.1), reps=3,
                             warmup=1),
            forward_graph_ms=graph_ms(lambda: softdtw.wavefront(D, 0.1)))


def retrain_chain_phase(counters, e2e: dict) -> dict:
    """The retraining chain's ends (phase 17): train_eval (evaluation of the
    shipped checkpoints, a short training run), the three probes on the
    shipped tree, promote, import_pose and softdtw_bwd_bench, all writing
    into temporary folders; artifacts/ byte for byte unchanged.  Returns the
    launches of each driven path."""
    import tempfile

    before = tree_digest("artifacts")
    seconds, paths = {}, {}
    with tempfile.TemporaryDirectory() as d:
        staged = retrain_eval_and_train(d, counters, seconds, paths)
        retrain_probes(d, staged, counters, seconds, paths)
        retrain_promote(d, staged, e2e, seconds)
        retrain_import(d, counters, seconds, paths)
        retrain_bwd_bench(counters, seconds, paths)
    unchanged = tree_digest("artifacts") == before
    say("retrain_chain", seconds={k: round(v, 3) for k, v in seconds.items()},
        artifacts_unchanged=unchanged, launches=paths)
    check(unchanged, "retrain_chain: artifacts/ changed")
    return paths


# ---------------------------------------------------------------------------
# 18. preprocess_bf16: preprocess_dtype="bfloat16" and kernel A's bfloat16 variant
# ---------------------------------------------------------------------------

# Odd boxes (tests/test_torch_kernels_cuda.py's, then boxes whose sample
# coordinates all lie in [-1, 1)); they take the first rows of a micro-batch.
ODD_BOXES = ([80.3, 60.7, 9.0, 12.0], [10.0, 10.0, 4.0, 4.0], [150.0, 110.0, 6.5, 3.2],
             [80.0, 60.0, 2.0, 2.0], [-300.0, 60.0, 50.0, 50.0], [500.0, 500.0, 30.0, 40.0],
             [80.0, -200.0, 60.0, 90.0], [80.0, 400.0, 10.0, 10.0], [5e6, -3e7, 20.0, 30.0],
             [-1e9, 1e9, 1e3, 1e3], [3e9, 3e9, 1.0, 1.0], [1e12, 0.0, 5.0, 5.0],
             [80.0, 60.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0], [159.0, 119.0, 1.0, 1.0],
             [80.5, 60.5, 1.0, 0.5], [0.0, 0.0, 1.0, 1.0], [0.05, -0.1, 0.7, 0.9],
             [-0.3, 0.2, 0.5, 0.4], [1e-8, 1e-8, 1e-8, 1e-8])
PREPROCESS_DTYPE_CLIPS = 2      # the bench's clips of 64 frames


def bf16_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How two bfloat16 tensors differ: values off, the share off, the
    largest distance in bfloat16 ulps (steps of the 16-bit pattern) and in
    value."""
    d = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
    off = got != want
    return {"values_off": int(off.sum()), "share_off": float(off.float().mean()),
            "max_ulps": int(d.max()), "max_abs_err": float((got.float() - want.float()).abs().max())}


def preprocess_bf16_phase(clips, boxes, counters) -> tuple[dict, dict]:
    """The bfloat16 crops (phase 18): kernel A's bfloat16 variant against its
    plain version at the main path's shape with the smoke's and odd boxes,
    its times and bound; `_core_fn` of the shipped model at both
    preprocess_dtype values (the launches of each, the keypoint gap, the
    labels' agreement); `bench_preprocess_dtype` at its defaults.  Returns
    (the launches of the two driven calls, the kernels-line entry)."""
    from golfaction_tpu_torch import bench_preprocess_dtype
    from golfaction_tpu_torch.ops import affine, preprocess
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    dev = torch.device("cuda")
    H, W = VIDEO_HW
    pipes = {dt: Pipeline.from_artifacts("artifacts", device="cuda",
                                         overrides=[f"preprocess_dtype={dt}"])
             for dt in ("float32", "bfloat16")}
    cfg = pipes["bfloat16"].cfg
    oh, ow = cfg.pose.input_hw
    fb = cfg.frame_batch
    frames_a = torch.from_numpy(clips[0][:fb]).to(dev)
    boxes_a = affine.box_to_center_scale(torch.from_numpy(boxes[0][:fb]).to(dev),
                                         ow / oh).contiguous()
    odd = boxes_a.clone()
    odd[:len(ODD_BOXES)] = torch.tensor(ODD_BOXES, dtype=torch.float32, device=dev)
    gaps = {}
    for name, bx in (("smoke_boxes", boxes_a), ("odd_boxes", odd)):
        got = preprocess.crop_resize_normalize(frames_a, bx, (oh, ow), dtype=torch.bfloat16)
        want = preprocess.crop_resize_normalize_bf16_reference(frames_a, bx, (oh, ow))
        check(got.dtype == torch.bfloat16 and tuple(got.shape) == (fb, oh, ow, 3),
              f"bfloat16 crops {got.dtype} {tuple(got.shape)}")
        gaps[name] = bf16_gap(got, want)
    say("parity_preprocess_bf16", shape=[fb, H, W, 3], out=[fb, oh, ow, 3],
        odd_boxes=len(ODD_BOXES), gaps=gaps, limit="equal to the bit")
    check(all(g["values_off"] == 0 for g in gaps.values()),
          "bfloat16 preprocess kernel differs from its plain version")

    # The variant's two divisions (a reciprocal and one correction) against
    # IEEE division over every float32 of their domains.
    t0 = time.perf_counter()
    proof = {"/255 on [0, 255]": preprocess.division_mismatches(0.0, 255.0, 255.0, False)}
    for c, (m, sd) in enumerate(zip(preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD)):
        m = np.float32(m)
        proof[f"/std[{c}] on [-mean, 1 - mean]"] = preprocess.division_mismatches(
            float(-m), float(np.float32(1) - m), sd, True)
    say("division_proof_bf16", mismatches={k: v[0] for k, v in proof.items()},
        floats={k: v[1] for k, v in proof.items()}, limit=0,
        seconds=round(time.perf_counter() - t0, 3))
    check(all(v[0] == 0 for v in proof.values()),
          f"bfloat16 preprocess kernel: divisions differ from IEEE division {proof}")

    def kernel():
        return preprocess.crop_resize_normalize(frames_a, boxes_a, (oh, ow), dtype=torch.bfloat16)

    ms, gms = cuda_ms(kernel), graph_ms(kernel)
    plain = cuda_ms(lambda: preprocess.crop_resize_normalize_bf16_reference(frames_a, boxes_a,
                                                                             (oh, ow)), reps=5)
    src = frames_a.permute(0, 3, 1, 2).float().contiguous()
    gx = preprocess._sample_coords(boxes_a, ow, axis=0) / (W - 1) * 2 - 1
    gy = preprocess._sample_coords(boxes_a, oh, axis=1) / (H - 1) * 2 - 1
    grid = torch.stack([gx[:, None, :].expand(-1, oh, -1),
                        gy[:, :, None].expand(-1, -1, ow)], dim=-1).contiguous()

    def library():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True).bfloat16()

    lib, lib_graph = cuda_ms(library), graph_ms(library)
    del src, grid
    nb, ops = preprocess_bytes_ops(boxes_a, H, W, oh, ow, out_bytes=2, ops_per_px=60)
    bms, by = bound(nb, ops)

    # The shipped model's device program at both crop dtypes, each call a
    # driven path of its own.
    T = CLIP_T
    fr = torch.from_numpy(np.stack(clips[2:2 + PREPROCESS_DTYPE_CLIPS])).to(dev)
    bxs = torch.from_numpy(np.stack(boxes[2:2 + PREPROCESS_DTYPE_CLIPS])).to(dev)
    valid = torch.ones((PREPROCESS_DTYPE_CLIPS, T), dtype=torch.bool, device=dev)
    launches, outs = {}, {}
    with torch.inference_mode():
        for dt, pipe in pipes.items():
            pipe._core_fn(fr, bxs, valid)                     # warm
            _zero(counters)
            outs[dt] = pipe._core_fn(fr, bxs, valid)
            launches[dt] = _counted(counters)
    per_call = -(-PREPROCESS_DTYPE_CLIPS * T // fb) * cfg.pose.in_frames
    kb, kf = outs["bfloat16"]["keypoints"], outs["float32"]["keypoints"]
    d = (kb[..., :2] - kf[..., :2]).abs().flatten().float().cpu().numpy()
    labels_equal = float((outs["bfloat16"]["phase_labels"]
                          == outs["float32"]["phase_labels"]).float().mean())
    say("preprocess_dtype_core", clips=PREPROCESS_DTYPE_CLIPS, frames=T,
        launches=launches, kernel_a_calls_per_core_call=per_call,
        kpt_gap_px={"median": float(np.median(d)), "p99": float(np.percentile(d, 99)),
                    "max": float(d.max())},
        phase_labels_equal=labels_equal)
    check(bool(torch.isfinite(kb).all()), "preprocess_dtype_core: non-finite keypoints")
    check(launches["bfloat16"]["preprocess_bf16"] == per_call
          and launches["bfloat16"]["preprocess"] == 0,
          f"bfloat16 crops: kernel A launches {launches['bfloat16']}, expected {per_call} "
          "of the bfloat16 variant and none of the float32 kernel")
    check(launches["float32"]["preprocess"] == per_call
          and launches["float32"]["preprocess_bf16"] == 0,
          f"float32 crops: kernel A launches {launches['float32']}")
    del pipes, fr, outs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    line = _quiet(bench_preprocess_dtype.main, [])
    say("bench_preprocess_dtype", call="python -m golfaction_tpu_torch.bench_preprocess_dtype",
        seconds=round(time.perf_counter() - t0, 3), **line)
    check(all(np.isfinite(line[k]) and line[k] > 0 for k in ("fps_f32", "fps_bf16", "speedup")),
          f"bench_preprocess_dtype: {line}")
    entry = dict(name="crop_resize_normalize_bf16", route="cuda",
                 source="golfaction_tpu_torch/csrc/preprocess.cu",
                 replaces="golfaction_tpu/ops/preprocess.py:106 at dtype=bfloat16 (the "
                          "bfloat16 inner arithmetic of "
                          "golfaction_tpu/ops/pallas/preprocess_kernel.py:49-63)",
                 launches=0, max_abs_err=max(g["max_abs_err"] for g in gaps.values()),
                 ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                 graph_ms=gms, library_graph_ms=lib_graph, shape=[fb, H, W, 3], bytes=nb,
                 ops=ops, **EARLIER["crop_resize_normalize_bf16"], earlier_from=EARLIER_FROM)
    say("time", **{k: entry[k] for k in TIME_KEYS if k in entry})
    return {f"preprocess_dtype_{k}": v for k, v in launches.items()}, entry


# ---------------------------------------------------------------------------
# 15. parallel: data parallelism on torch.distributed
# ---------------------------------------------------------------------------

PARALLEL_CLIPS = 8              # the smoke's six clips and two more from seed 0
PARALLEL_SDTW = (((128, 80), 0.3, None, 21), ((61, 45), 0.3, 4, 5))   # shape, gamma, C, seed


class SmokeClips:
    """The smoke's clips from seed 0 (as smoke_clips, `n` of them), each
    rendered on the card when first read; `read` keeps which were."""

    def __init__(self, n: int):
        rng = np.random.default_rng(0)
        self.kpts = [swing_keypoints(CLIP_T, rng) for _ in range(n)]
        self.boxes = [boxes_of(k) for k in self.kpts]
        self.frames, self.read = {}, set()

    def __len__(self) -> int:
        return len(self.kpts)

    def __getitem__(self, i: int) -> np.ndarray:
        self.read.add(i)
        if i not in self.frames:
            self.frames[i] = render_clip(self.kpts[i], seed=i)
        return self.frames[i]


def skeleton_setup(dev):
    """The DP step's three models at the trainers' default widths (float32,
    dropout 0), random weights from seed 0; AdamW without warmup; the
    global batch (8 swings of 64 frames, seed 0)."""
    from golfaction_tpu_torch import config as cfg_mod, weights
    from golfaction_tpu_torch.models.align import AlignEncoder
    from golfaction_tpu_torch.models.error import ErrorClassifier
    from golfaction_tpu_torch.models.gcn import ActionSegmentationGCN
    from golfaction_tpu_torch.train import data, loops
    from tests import torch_dp

    models = torch.nn.ModuleDict({
        "gcn": ActionSegmentationGCN(cfg_mod.GCNConfig(dropout=0.0, dtype="float32")),
        "error": ErrorClassifier(cfg_mod.ErrorConfig(dtype="float32")),
        "align": AlignEncoder(cfg_mod.AlignConfig(dtype="float32"))})
    gen = torch.Generator().manual_seed(0)
    for m in models.values():
        weights.init_random(m, gen)
    models.to(dev).train()
    opt, sched = loops.make_optimizer(models.parameters(), cfg_mod.TrainConfig(
        warmup_steps=0, total_steps=10))
    batch = torch_dp.build_skeleton_batch(data.make_swing_batch(8, CLIP_T, seed=0,
                                                                fault_prob=0.5), device=dev)
    return models, opt, sched, batch


def _fields(res) -> dict:
    return {"keypoints": res.keypoints, "phase_labels": res.phase_labels,
            "error_probs": res.error_probs, "cost": res.alignment.cost,
            "path": res.alignment.path, "path_length": res.alignment.path_length}


def _zero(counters) -> None:
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0


def parallel_rank(rank: int, world: int, spec: dict) -> dict:
    """One of the `parallel` phase's gloo ranks, all on cuda:0: the sharded
    analyze_batch of the shipped model (a warm call, then a timed one), one
    data-parallel skeleton step, and the sharded soft-DTW (its gradient,
    and milliseconds a forward call); each part's kernel launches."""
    import torch.distributed as dist

    from golfaction_tpu_torch.ops.softdtw_sharded import softdtw_cost_sharded
    from golfaction_tpu_torch.parallel import mesh as mesh_mod, train_step as ts
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
    from golfaction_tpu_torch.types import Skeleton
    from tests import torch_dp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda:0")
    mesh = mesh_mod.make_mesh(device=dev)
    counters = kernel_counters()
    out = {}

    clips = SmokeClips(spec["clips"])
    pipe = Pipeline.from_artifacts("artifacts", overrides=["clip_batch=4"], mesh=mesh)
    ref = Skeleton(keypoints=torch.from_numpy(spec["ref_kpts"]),
                   valid=torch.from_numpy(spec["ref_valid"]))
    pipe.analyze_batch(clips, boxes=clips.boxes, reference=ref)            # warm
    _zero(counters)
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe.analyze_batch(clips, boxes=clips.boxes, reference=ref)
    torch.cuda.synchronize()
    out["analyze"] = {"wall_s": time.perf_counter() - t0, "results": [_fields(r) for r in res],
                      "launches": {k: fn.launches for k, fn in counters.items()},
                      "read": sorted(clips.read), "stats": pipe.last_batch_stats}
    del pipe, clips
    torch.cuda.empty_cache()

    models, opt, sched, batch = skeleton_setup(dev)
    mesh_mod.replicate(models, mesh)
    step = ts.make_dp_train_step(torch_dp.skeleton_loss, opt, mesh, sched)
    _zero(counters)
    aux = step(models, mesh_mod.shard_batch(batch, mesh), 0)
    out["train"] = {"loss": float(aux["loss"]), "grad_norm": float(aux["grad_norm"]),
                    "launches": {k: fn.launches for k, fn in counters.items()}}

    out["softdtw"] = []
    for (shape, gamma, cc, seed) in spec["sdtw"]:
        D = torch.from_numpy(np.random.default_rng(seed).uniform(0, 2, shape).astype(
            np.float32)).to(dev).requires_grad_()
        cost = softdtw_cost_sharded(D, gamma, mesh, col_chunks=cc)
        cost.backward()
        with torch.no_grad():
            walls = []
            for _ in range(3):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                softdtw_cost_sharded(D, gamma, mesh, col_chunks=cc)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        out["softdtw"].append({"cost": float(cost.detach()), "grad": D.grad, "ms": walls})
    return out


def parallel_phase(clips, reference, counters) -> dict:
    """Data parallelism: two gloo ranks sharing the card (spawned, a file
    store) run the shipped model's sharded analyze_batch on 8 clips
    (clip_batch 4, deterministic cuDNN), one data-parallel skeleton step
    and the sharded soft-DTW; this process runs the same analyze_batch and
    step without a mesh, and both again through a one-rank NCCL group.
    Checks: the sharded results equal the one-process ones to the bit, and
    each rank read only its own clips; the two-rank step within rel 1e-4
    of one process; the NCCL-group runs equal the no-mesh runs to the bit;
    the soft-DTW cost within rtol 2e-5 of softdtw_reference and the ranks'
    summed gradients within atol 2e-5 of softdtw_grad_reference.  Returns
    the launches of the ranks' and the NCCL group's runs."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from golfaction_tpu_torch.ops import softdtw
    from golfaction_tpu_torch.parallel import mesh as mesh_mod, train_step as ts
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
    from golfaction_tpu_torch.train import loops
    from tests import torch_dp

    world, dev = 2, torch.device("cuda:0")
    spec = {"clips": PARALLEL_CLIPS, "sdtw": PARALLEL_SDTW,
            "ref_kpts": reference.keypoints.cpu().numpy(),
            "ref_valid": reference.valid.cpu().numpy()}
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        t0 = time.perf_counter()
        ranks = torch_dp.run_ranks(parallel_rank, world, store, (spec,), timeout=420.0)
        ranks_s = time.perf_counter() - t0

        every = SmokeClips(PARALLEL_CLIPS)
        every.frames.update(enumerate(clips))            # the first six, already rendered
        ref = reference
        torch.backends.cudnn.deterministic = True
        try:
            pipe = Pipeline.from_artifacts("artifacts", device="cuda", overrides=["clip_batch=4"])
            pipe.analyze_batch(every, boxes=every.boxes, reference=ref)     # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = [_fields(r) for r in pipe.analyze_batch(every, boxes=every.boxes,
                                                           reference=ref)]
            torch.cuda.synchronize()
            one_wall = time.perf_counter() - t0
            del pipe
            models, opt, sched, batch = skeleton_setup(dev)
            aux = loops.train_step(models, opt, sched, torch_dp.skeleton_loss, batch, 0)
            step_one = (float(aux["loss"]), float(aux["grad_norm"]),
                        [p.detach().clone() for p in models.parameters()])
            del models, opt

            dist.init_process_group("nccl", init_method="file://" + store + "/nccl", rank=0,
                                    world_size=1, device_id=dev)
            try:
                mesh = mesh_mod.make_mesh(device=dev)
                _zero(counters)
                pipe = Pipeline.from_artifacts("artifacts", overrides=["clip_batch=4"],
                                               mesh=mesh)
                nccl = [_fields(r) for r in pipe.analyze_batch(every, boxes=every.boxes,
                                                                reference=ref)]
                del pipe
                models, opt, sched, batch = skeleton_setup(dev)
                aux = ts.make_dp_train_step(torch_dp.skeleton_loss, opt, mesh, sched)(
                    models, mesh_mod.shard_batch(batch, mesh), 0)
                nccl_launches = {k: fn.launches for k, fn in counters.items()}
                step_nccl = (float(aux["loss"]), float(aux["grad_norm"]),
                             [p.detach().clone() for p in models.parameters()])
                del models, opt
            finally:
                dist.destroy_process_group()
        finally:
            torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(store, ignore_errors=True)

    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def same(a: list, b: list) -> list:
        """Fields that are not equal to the bit in some clip."""
        return sorted({k for x, y in zip(a, b) for k in x
                       if not np.array_equal(host(x[k]), host(y[k]))})

    frames = PARALLEL_CLIPS * CLIP_T
    rank_differ = [same(r["analyze"]["results"], one) for r in ranks]
    nccl_differ = same(nccl, one)
    step_rel = [max(abs(r["train"]["loss"] / step_one[0] - 1),
                    abs(r["train"]["grad_norm"] / step_one[1] - 1)) for r in ranks]
    nccl_step_equal = (step_nccl[0] == step_one[0] and step_nccl[1] == step_one[1]
                       and all(torch.equal(a, b) for a, b in zip(step_nccl[2], step_one[2])))
    sdtw = []
    for n, (shape, gamma, cc, seed) in enumerate(PARALLEL_SDTW):
        D = np.random.default_rng(seed).uniform(0, 2, shape)
        want, R = softdtw.softdtw_reference(D.astype(np.float32).astype(np.float64), gamma)
        E = softdtw.softdtw_grad_reference(D.astype(np.float32).astype(np.float64), R, gamma)
        got = [r["softdtw"][n] for r in ranks]
        sdtw.append({"shape": list(shape), "gamma": gamma, "col_chunks": cc or world,
                     "cost": [g["cost"] for g in got], "oracle": want,
                     "cost_rel_err": max(abs(g["cost"] / want - 1) for g in got),
                     "grad_max_abs_err": float(np.abs(sum(g["grad"] for g in got) - E).max()),
                     "ms_per_call": [g["ms"] for g in got]})
    launches = {k: sum(r["analyze"]["launches"][k] + r["train"]["launches"][k] for r in ranks)
                + nccl_launches[k] for k in counters}
    say("parallel", world=world, backend="gloo, both ranks on cuda:0", clips=PARALLEL_CLIPS,
        frames=frames, clip_batch=4, reference=True, ranks_seconds=round(ranks_s, 3),
        frames_per_s={"two_ranks": frames / max(r["analyze"]["wall_s"] for r in ranks),
                      "one_process": frames / one_wall},
        wall_s={"ranks": [r["analyze"]["wall_s"] for r in ranks], "one_process": one_wall},
        clips_read=[r["analyze"]["read"] for r in ranks],
        last_batch_stats=[r["analyze"]["stats"] for r in ranks], differ_in=rank_differ,
        rank_launches=[{"analyze": r["analyze"]["launches"], "train": r["train"]["launches"]}
                       for r in ranks],
        train={"loss": [r["train"]["loss"] for r in ranks], "one_process_loss": step_one[0],
               "grad_norm": [r["train"]["grad_norm"] for r in ranks],
               "one_process_grad_norm": step_one[1], "max_rel_err": max(step_rel), "rtol": 1e-4},
        nccl_world_1={"analyze_differ_in": nccl_differ, "step_equal": nccl_step_equal,
                      "launches": nccl_launches},
        softdtw_sharded=sdtw, launches=launches)
    for r, d in zip(range(world), rank_differ):
        check(not d, f"parallel: rank {r}'s sharded analyze_batch differs from one process "
                     f"in {d}")
    check(all(r["analyze"]["read"] == list(range(k, PARALLEL_CLIPS, world))
              for k, r in enumerate(ranks)), "parallel: a rank read clips not its own")
    check(max(step_rel) <= 1e-4, f"parallel: the two-rank step is {max(step_rel)} off one process")
    check(not nccl_differ, f"parallel: the NCCL group's analyze_batch differs in {nccl_differ}")
    check(nccl_step_equal, "parallel: the NCCL group's step differs from the no-mesh step")
    for e in sdtw:
        check(e["cost_rel_err"] <= 2e-5, f"parallel: sharded soft-DTW cost off at {e['shape']}")
        check(e["grad_max_abs_err"] <= 2e-5, f"parallel: sharded soft-DTW gradient off at "
                                             f"{e['shape']}")
    for k in ("preprocess", "gcn_tail", "softdtw", "softdtw_bwd"):
        check(launches[k] > 0, f"parallel: kernel {k} was not launched")
    return launches


def smoke_clips():
    """The rendered 1080p clips and their boxes, from seed 0."""
    rng = np.random.default_rng(0)
    kp_clips = [swing_keypoints(CLIP_T, rng) for _ in range(2 + BATCH_CLIPS)]
    return [render_clip(k, seed=i) for i, k in enumerate(kp_clips)], [boxes_of(k)
                                                                     for k in kp_clips]


def options_repeat(runs: int) -> int:
    """`python3 chip_smoke.py --options-repeats N`: the options phase (9.)
    N times in one process on the same clips, each time held to the CPU
    (`options_cpu`); a line a run, then a summary.  Exits 1 if a run failed."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    clips, boxes = smoke_clips()
    counters = kernel_counters()
    failed = 0
    for run in range(runs):
        try:
            options_phase(clips, boxes, counters)
            say("options_repeat", run=run, ok=True)
        except SmokeFailure as e:
            failed += 1
            say("options_repeat", run=run, ok=False, failure=str(e))
    say("options_repeat_summary", runs=runs, failed=failed)
    return 1 if failed else 0


def group_norm_only() -> int:
    """`python3 chip_smoke.py --group-norm`: the build and kernel G's phase
    alone (its occupancy, then `group_norm_phase` on the shipped model and a
    micro-batch of the smoke's crops), and G's `time` line."""
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from golfaction_tpu_torch.ops import _kernels, affine, preprocess
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    _kernels.build_all(("group_norm",))
    say("resources", ptxas={"group_norm": _kernels.resource_usage("group_norm")},
        group_norm=group_norm_occupancy())
    pipe = Pipeline.from_artifacts("artifacts", device="cuda")
    oh, ow = pipe.cfg.pose.input_hw
    clips, boxes = smoke_clips()
    fb = pipe.cfg.frame_batch
    dev = torch.device("cuda")
    frames = torch.from_numpy(clips[0][:fb]).to(dev)
    bx = affine.box_to_center_scale(torch.from_numpy(boxes[0][:fb]).to(dev), ow / oh)
    with torch.inference_mode():
        crops = preprocess.crop_resize_normalize(frames, bx.contiguous(), (oh, ow))
    entry = group_norm_phase(pipe.pose_model, crops)
    say("time", **{k: entry[k] for k in TIME_KEYS if k in entry})
    return 0


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "a CUDA card", file=sys.stderr)
        return 2
    from golfaction_tpu_torch.ops import (_kernels, gcn_tail, heatmap, preprocess, requant,
                                          softdtw)
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
    from golfaction_tpu_torch.types import Skeleton
    from tests import torch_dp

    wall0 = time.perf_counter()
    phase_seconds, lap0 = {}, [wall0]

    def lap(name: str) -> None:
        """Host seconds since the last lap, the device drained first."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        phase_seconds[name] = round(now - lap0[0], 3)
        lap0[0] = now

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, tf32_matmul=False, tf32_cudnn=False)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.build_all(_kernels.SOURCES + _kernels.HOST_SOURCES)
    say("build", seconds=round(time.perf_counter() - t0, 3),
        sources=list(_kernels.SOURCES + _kernels.HOST_SOURCES))
    occ = _kernels.bind("gcn_tail", "gcn_tail_blocks_per_sm", "iiii")
    crop_occ = _kernels.bind("preprocess", "crop_resize_normalize_blocks_per_sm", "i")
    say("resources", ptxas={n: _kernels.resource_usage(n)
                            for n in ("preprocess", "gcn_tail", "softdtw", "softdtw_bwd",
                                      "requant", "group_norm")},
        blocks_per_sm={"crop_resize_normalize": crop_occ(0),
            "crop_resize_normalize_bf16": crop_occ(1),
            "gcn_tail [rows, taps, gates, apply]": {
                C: [occ(i, C, 17, max(C // 4, 8)) for i in range(4)]
                for C in (64, 128, 256)},
            "softdtw_wavefront": wavefront_occupancy(softdtw),
            "softdtw_backward": backward_occupancy(softdtw)},
        requant=requant_occupancy(requant), group_norm=group_norm_occupancy())
    lap("device_build")
    pipe = Pipeline.from_artifacts("artifacts", device="cuda")     # the shipped dtype
    pipe32 = Pipeline.from_artifacts("artifacts", device="cuda", overrides=FLOAT32)
    cfg = pipe.cfg
    oh, ow = cfg.pose.input_hw
    H, W = VIDEO_HW
    clips, boxes = smoke_clips()
    say("render", clips=len(clips), frames=CLIP_T, hw=list(VIDEO_HW),
        seconds=round(time.perf_counter() - t0, 3))

    lap("load_render")
    # 3. parity -------------------------------------------------------------
    from golfaction_tpu_torch.ops import affine

    err = {}
    fb = cfg.frame_batch
    frames_a = torch.from_numpy(clips[0][:fb]).to(dev)
    boxes_a = affine.box_to_center_scale(torch.from_numpy(boxes[0][:fb]).to(dev),
                                         ow / oh).contiguous()
    boxes_off = boxes_a.clone()
    boxes_off[::2, :2] = torch.tensor([40.0, H - 30.0], device=dev)   # leave the frame
    errs = []
    for bx in (boxes_a, boxes_off):
        got = preprocess.crop_resize_normalize(frames_a, bx, (oh, ow))
        want = preprocess.crop_resize_normalize_reference(frames_a, bx, (oh, ow))
        errs.append(float((got - want).abs().max()))
    err["preprocess"] = max(errs)
    say("parity_preprocess", shape=[fb, H, W, 3], out=[fb, oh, ow, 3], max_abs_err=errs,
        atol=1e-4)
    check(err["preprocess"] <= 1e-4, "preprocess kernel disagrees with its plain version")

    gen = torch.Generator().manual_seed(0)
    la_tail = torch.tensor([CLIP_T, CLIP_T - 9, 23, CLIP_T], dtype=torch.int32, device=dev)
    tail_x, errs = [], []
    for blk in pipe.gcn_model.blocks:
        x = torch.randn((BATCH_CLIPS, CLIP_T, 17, blk.tail.C), generator=gen).to(dev)
        tail_x.append(x)
        got = gcn_tail.gcn_block_tail(x, la_tail, blk.tail)
        want = gcn_tail.gcn_block_tail_plain(x, la_tail, blk.tail)
        errs.append(float((got - want).abs().max()))
    err["gcn_tail"] = max(errs)
    say("parity_gcn_tail", C=[b.tail.C for b in pipe.gcn_model.blocks], B=BATCH_CLIPS,
        T=CLIP_T, la=la_tail.tolist(), max_abs_err=errs, atol=1e-3)
    check(err["gcn_tail"] <= 1e-3, "GCN tail kernel disagrees with its plain version")

    errs, rel = [], []
    for Ta, Tb in ((64, 64), (128, 64)):
        e = torch.nn.functional.normalize(torch.randn((8, Ta + Tb, 128), generator=gen), dim=-1)
        D = softdtw.pairwise_sqdist(e[:, :Ta], e[:, Ta:]).to(dev).contiguous()
        for gamma in (cfg.align.gamma, 0.0):
            got = softdtw.wavefront(D, gamma)
            want = softdtw.wavefront_plain(D, gamma)
            errs.append(float((got - want).abs().max()))
            rel.append(float(((got - want).abs() / want.abs().clamp(min=1e-30)).max()))
            check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                  f"wavefront kernel disagrees at {Ta}x{Tb}, gamma {gamma}")
            if gamma == 0.0:
                la = torch.full((8,), Ta, dtype=torch.int32)
                lb = torch.full((8,), Tb, dtype=torch.int32)
                pg, lg = softdtw._backtrack(got, la, lb)
                pw, lw = softdtw._backtrack(want, la, lb)
                check(torch.equal(pg, pw) and torch.equal(lg, lw),
                      f"hard-DTW paths differ at {Ta}x{Tb}")
    err["softdtw"] = max(errs)
    say("parity_softdtw", B=8, shapes=[[64, 64], [128, 64]], gammas=[cfg.align.gamma, 0.0],
        max_abs_err=errs, max_rel_err=rel, rtol=1e-5, atol=1e-5, paths="exact")

    with torch.inference_mode():
        hm_a = pipe32.pose_model(preprocess.crop_resize_normalize(frames_a, boxes_a, (oh, ow)))
    hh, hw_ = cfg.pose.heatmap_hw
    check(tuple(hm_a.shape) == (fb, 17, hh, hw_), f"pose heatmaps {tuple(hm_a.shape)}")
    gaps = {}
    for name, maps in (("pose_net", hm_a),
                       ("edge_rows", torch.from_numpy(decode_edge_rows(hh, hw_)).to(dev))):
        got = heatmap.decode_heatmaps(maps, "udp")
        gaps[name] = decode_gap(got, heatmap.decode_heatmaps_plain(maps, "udp"))
        check(gaps[name]["peaks_equal"] and gaps[name]["scores_equal"],
              f"decode kernel picks other peaks or scores than its plain version ({name})")
        check(gaps[name]["max_xy_err"] <= 1e-4, f"decode kernel x/y off its plain version ({name})")
        if name == "edge_rows":
            check(got[0].tolist() == [0.0, 0.0, 0.0], "all-zero heatmap does not decode to (0, 0)")
            check(got[1, :2].round().tolist() == [hw_ // 2, hh // 3], "a tie's later maximum won")
    err["decode"] = max(g["max_xy_err"] for g in gaps.values())
    say("parity_decode", shape=[fb, 17, hh, hw_], edge_rows=12, gaps=gaps, peaks="exact",
        scores="exact", xy_atol=1e-4)

    bwd_errs = []
    for B_, Ta, Tb in ((96, 48, 48), (8, 128, 64), (2, 600, 20)):
        e = torch.nn.functional.normalize(torch.randn((B_, Ta + Tb, 128), generator=gen), dim=-1)
        D = softdtw.pairwise_sqdist(e[:, :Ta], e[:, Ta:]).to(dev).contiguous()
        R = softdtw.wavefront(D, cfg.align.gamma)
        got = softdtw.softdtw_backward(D, R, cfg.align.gamma)
        want = softdtw.softdtw_backward_plain(D, R, cfg.align.gamma)
        scale = float(want.abs().max())
        bwd_errs.append({"shape": [B_, Ta, Tb], "layout": "one launch" if softdtw.backward_geometry(
                             B_, Ta, Tb).fits else "two launches",
                         "max_abs_err": float((got - want).abs().max()),
                         "max_rel_err": float(((got - want).abs()
                                               / want.abs().clamp(min=1e-6 * scale)).max()),
                         "largest_E": scale})
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-6 * scale),
              f"soft-DTW backward kernel disagrees at {B_}x{Ta}x{Tb}")
        Dg = D.clone().requires_grad_()
        (g,) = torch.autograd.grad(softdtw.softdtw_cost(Dg, cfg.align.gamma).sum(), Dg)
        check(torch.equal(g, got), "autograd of softdtw_cost is not the kernel's E")
    err["softdtw_bwd"] = max(b["max_abs_err"] for b in bwd_errs)
    say("parity_softdtw_bwd", gamma=cfg.align.gamma, results=bwd_errs, rtol=1e-4,
        atol="1e-6 of the largest E", autograd="equal to E")

    lap("parity")
    # 4. main path ----------------------------------------------------------
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res_ref = pipe.analyze(clips[1])                    # host motion-energy boxes
    reference = pipe.extract_skeleton(res_ref)
    res_cmp = pipe.analyze(clips[0], boxes=boxes[0], reference=reference)
    res_batch = pipe.analyze_batch(clips[2:], boxes=boxes[2:], reference=reference)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    say("main", config="full_pipeline+artifacts", seconds=round(main_s, 3), launches=launches,
        global_launches_per_call={"preprocess": 1, "gcn_tail": 4, "softdtw": 1},
        decode_tracking=cfg.pose.decode_tracking, mode_features=cfg.error.mode_features)
    for k in ("preprocess", "gcn_tail", "softdtw"):      # the tracked decode has no kernel
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")

    check_results([res_ref, res_cmp, *res_batch], reference)
    # The boxes analyze took from the C++ library, against the numpy body on
    # the clip's first 16 frames (a 1080p numpy median of all 64 takes GBs).
    from golfaction_tpu_torch.pipeline import video_io

    head = clips[1][:16]
    nb_gap = float(np.abs(video_io.estimate_person_boxes(head)
                          - video_io.estimate_person_boxes(head, use_native=False)).max())
    say("native_boxes", frames=16, hw=list(VIDEO_HW), max_px_vs_numpy=nb_gap, atol_px=1.0)
    check(nb_gap <= 1.0, "C++ motion boxes more than 1 px off the numpy body")
    compare_determinism(pipe32, clips[2:], boxes[2:], reference)
    logger_check(pipe, clips[0], boxes[0])
    say("main_checks", results=2 + len(res_batch), ok=True,
        phase_labels=res_cmp.phase_labels[:8].tolist(),
        error_probs=[round(float(v), 6) for v in res_cmp.error_probs],
        cost=float(res_cmp.alignment.cost), path_length=int(res_cmp.alignment.path_length))

    lap("main")
    # The same program on the CPU (plain versions) on a small input.
    cpu = Pipeline.from_artifacts("artifacts", device="cpu", overrides=FLOAT32)
    small = [c[:20] for c in clips[2:4]]
    small_boxes = [b[:20] for b in boxes[2:4]]
    ref_small = Skeleton(keypoints=reference.keypoints[:40].cpu(),
                         valid=reference.valid[:40].cpu())
    r_gpu = pipe32.analyze_batch(small, boxes=small_boxes, reference=ref_small)
    r_cpu = cpu.analyze_batch(small, boxes=small_boxes, reference=ref_small)
    diffs = {"keypoints": 0.0, "phase_logits": 0.0, "error_probs": 0.0, "cost_rel": 0.0}
    for g, c in zip(r_gpu, r_cpu):
        for k in ("keypoints", "phase_logits", "error_probs"):
            diffs[k] = max(diffs[k], float((getattr(g, k).cpu() - getattr(c, k)).abs().max()))
        diffs["cost_rel"] = max(diffs["cost_rel"], float(
            (g.alignment.cost.cpu() - c.alignment.cost).abs() / c.alignment.cost.abs()))
        check(torch.equal(g.phase_labels.cpu(), c.phase_labels), "phase labels differ from CPU")
        check(torch.equal(g.alignment.path.cpu(), c.alignment.path), "path differs from CPU")
    say("reference_cpu", frames=20, clips=2, dtype="float32", max_diff=diffs,
        atol={"keypoints": 1e-2, "phase_logits": 1e-3, "error_probs": 1e-4, "cost_rel": 1e-4})
    check(diffs["keypoints"] <= 1e-2 and diffs["phase_logits"] <= 1e-3
          and diffs["error_probs"] <= 1e-4 and diffs["cost_rel"] <= 1e-4,
          "card and CPU disagree on the small input")

    lap("reference_cpu")
    # 5. times --------------------------------------------------------------
    entries = []
    nb, ops = preprocess_bytes_ops(boxes_a, H, W, oh, ow)
    ms = cuda_ms(lambda: preprocess.crop_resize_normalize(frames_a, boxes_a, (oh, ow)))
    gms = graph_ms(lambda: preprocess.crop_resize_normalize(frames_a, boxes_a, (oh, ow)))
    plain = cuda_ms(lambda: preprocess.crop_resize_normalize_reference(frames_a, boxes_a,
                                                                        (oh, ow)), reps=5)
    src = frames_a.permute(0, 3, 1, 2).float().contiguous()
    gx = preprocess._sample_coords(boxes_a, ow, axis=0) / (W - 1) * 2 - 1     # [B, ow]
    gy = preprocess._sample_coords(boxes_a, oh, axis=1) / (H - 1) * 2 - 1     # [B, oh]
    grid = torch.stack([gx[:, None, :].expand(-1, oh, -1),
                        gy[:, :, None].expand(-1, -1, ow)], dim=-1).contiguous()
    def library():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    lib, lib_graph = cuda_ms(library), graph_ms(library)
    del src
    bms, by = bound(nb, ops)
    entries.append(dict(name="crop_resize_normalize", route="cuda",
                        source="golfaction_tpu_torch/csrc/preprocess.cu",
                        replaces="golfaction_tpu/ops/pallas/preprocess_kernel.py:127",
                        launches=launches["preprocess"], max_abs_err=err["preprocess"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                        graph_ms=gms, library_graph_ms=lib_graph, shape=[fb, H, W, 3], bytes=nb,
                        ops=ops, **EARLIER["crop_resize_normalize"], earlier_from=EARLIER_FROM))

    lap("times_preprocess")
    ms = gms = plain = nb = ops = 0.0
    for blk, x in zip(pipe.gcn_model.blocks, tail_x):
        la_full = torch.full((BATCH_CLIPS,), CLIP_T, dtype=torch.int32, device=dev)
        ms += cuda_ms(lambda: gcn_tail.gcn_block_tail(x, la_full, blk.tail))
        gms += graph_ms(lambda: gcn_tail.gcn_block_tail(x, la_full, blk.tail), calls=5)
        plain += cuda_ms(lambda: gcn_tail.gcn_block_tail_plain(x, la_full, blk.tail), reps=5)
        b_, o_ = gcn_tail_bytes_ops(BATCH_CLIPS, CLIP_T, 17, blk.tail)
        nb, ops = nb + b_, ops + o_
    bms, by = bound(nb, ops)
    entries.append(dict(name="gcn_block_tail", route="cuda",
                        source="golfaction_tpu_torch/csrc/gcn_tail.cu",
                        replaces="golfaction_tpu/ops/pallas/gcn_kernel.py:319",
                        launches=launches["gcn_tail"], max_abs_err=err["gcn_tail"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                        graph_ms=gms,
                        shape="six blocks, x [4, 64, 17, C], C in (64,64,128,128,256,256)",
                        bytes=nb, ops=ops, **EARLIER["gcn_block_tail"],
                        earlier_from=EARLIER_FROM))

    lap("times_gcn_tail")
    e = torch.nn.functional.normalize(torch.randn((BATCH_CLIPS, 2 * CLIP_T, 128),
                                                  generator=gen), dim=-1)
    D = softdtw.pairwise_sqdist(e[:, :CLIP_T], e[:, CLIP_T:]).to(dev).contiguous()
    gam = cfg.align.gamma
    ms = sum(cuda_ms(lambda g=g: softdtw.wavefront(D, g)) for g in (gam, 0.0))
    per_call = {g: graph_ms(lambda g=g: softdtw.wavefront(D, g)) for g in (gam, 0.0)}
    gms = sum(per_call.values())
    # The same calls with D prefetched from device memory into a register
    # ring and R written cell by cell, instead of both staged in shared memory.
    ring = softdtw.wavefront_geometry(BATCH_CLIPS, CLIP_T, CLIP_T)._replace(staged=False)
    ring_ms = {f"gamma {g}": graph_ms(lambda g=g: softdtw.launch_wavefront(D, g, ring))
               for g in (gam, 0.0)}
    plain = sum(cuda_ms(lambda g=g: softdtw.wavefront_plain(D, g), reps=5) for g in (gam, 0.0))
    nb = ops = 0.0
    for g in (gam, 0.0):
        b_, o_ = wavefront_bytes_ops(BATCH_CLIPS, CLIP_T, CLIP_T, g)
        nb, ops = nb + b_, ops + o_
    bms, by = bound(nb, ops)
    entries.append(dict(name="softdtw_wavefront", route="cuda",
                        source="golfaction_tpu_torch/csrc/softdtw.cu",
                        replaces="golfaction_tpu/ops/pallas/softdtw_kernel.py:218",
                        launches=launches["softdtw"], max_abs_err=err["softdtw"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                        graph_ms=gms, ns_per_diagonal={
                            f"gamma {g}": t / (2 * CLIP_T - 1) * 1e6 for g, t in per_call.items()},
                        ring_graph_ms=ring_ms,
                        shape="D [4, 64, 64], gamma 0.1 then 0", bytes=nb, ops=ops,
                        **EARLIER["softdtw_wavefront"], earlier_from=EARLIER_FROM))

    M, HW = hm_a.shape[0] * hm_a.shape[1], hh * hw_
    nb, ops = decode_bytes_ops(M, HW)
    ms = cuda_ms(lambda: heatmap.decode_heatmaps(hm_a, "udp"))
    gms = graph_ms(lambda: heatmap.decode_heatmaps(hm_a, "udp"))
    plain = cuda_ms(lambda: heatmap.decode_heatmaps_plain(hm_a, "udp"), reps=5)
    bms, by = bound(nb, ops)
    entries.append(dict(name="decode_heatmaps", route="cuda",
                        source="golfaction_tpu_torch/csrc/decode.cu",
                        replaces="golfaction_tpu/ops/pallas/decode_kernel.py:117",
                        launches=0, max_abs_err=err["decode"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                        graph_ms=gms,
                        shape=f"heatmaps [{fb}, 17, {hh}, {hw_}] (one micro-batch)",
                        bytes=nb, ops=ops))

    B_, Ta = 3 * 32, 48                  # one train_align step: cat([Dab, Daa, Dbb]) at batch 32
    e = torch.nn.functional.normalize(torch.randn((B_, 2 * Ta, 128), generator=gen), dim=-1)
    D = softdtw.pairwise_sqdist(e[:, :Ta], e[:, Ta:]).to(dev).contiguous()
    R = softdtw.wavefront(D, gam)
    nb, ops = softdtw_bwd_bytes_ops(B_, Ta, Ta)
    ms = cuda_ms(lambda: softdtw.softdtw_backward(D, R, gam))
    gms = graph_ms(lambda: softdtw.softdtw_backward(D, R, gam))
    # The same call through the two-launch layout (weights to device memory,
    # the chain through a cp.async ring), which larger tables take.
    two = softdtw.backward_geometry(B_, Ta, Ta)._replace(fits=False, ring=8)
    two_gms = graph_ms(lambda: softdtw.launch_backward(D, R, gam, two))
    plain = cuda_ms(lambda: softdtw.softdtw_backward_plain(D, R, gam), reps=3, warmup=1)
    fwd_ms = graph_ms(lambda: softdtw.wavefront(D, gam))
    bms, by = bound(nb, ops)
    entries.append(dict(name="softdtw_backward", route="cuda",
                        source="golfaction_tpu_torch/csrc/softdtw_bwd.cu",
                        replaces="golfaction_tpu/ops/pallas/softdtw_kernel.py:241",
                        launches=0, max_abs_err=err["softdtw_bwd"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                        graph_ms=gms, ns_per_diagonal=gms / (2 * Ta - 1) * 1e6,
                        two_launch_graph_ms=two_gms,
                        shape=f"D, R [{B_}, {Ta}, {Ta}], gamma {gam} (one train_align step); "
                              f"the forward wavefront at this shape takes {fwd_ms:.4f} ms "
                              f"in a graph",
                        bytes=nb, ops=ops, **EARLIER["softdtw_backward"],
                        earlier_from=EARLIER_FROM))
    for en in entries:
        say("time", **{k: en[k] for k in TIME_KEYS if k in en})

    lap("times_softdtw_decode")
    pipe.analyze_batch(clips[2:], boxes=boxes[2:], reference=reference)     # warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.analyze_batch(clips[2:], boxes=boxes[2:], reference=reference)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    say("e2e", call="analyze_batch", clips=BATCH_CLIPS, frames=BATCH_CLIPS * CLIP_T,
        hw=list(VIDEO_HW), reference=True, wall_s=walls, frames_per_s=BATCH_CLIPS * CLIP_T / wall,
        smoke_seconds=round(time.perf_counter() - wall0, 3))
    lap("e2e")
    breakdown(pipe, clips[2:], boxes[2:], reference)
    time_gcn_tail_passes(pipe.gcn_model.blocks, tail_x)
    lap("breakdown_passes")

    # 10-13. the shipped dtype, the overlapped batch, streaming and the CLI,
    # the end-to-end score ------------------------------------------------
    with torch.inference_mode():
        crops = preprocess.crop_resize_normalize(frames_a, boxes_a, (oh, ow))
    shipped_bf16_phase(pipe, pipe32, cpu, clips, boxes, crops)
    del pipe32, cpu
    lap("shipped_bf16")
    group_norm_entry = group_norm_phase(pipe.pose_model, crops)
    say("time", **{k: group_norm_entry[k] for k in TIME_KEYS if k in group_norm_entry})
    del crops
    lap("group_norm")
    paths = {"main": launches,
             "batch_overlap": batch_overlap_phase(clips, boxes, reference, counters)}
    lap("batch_overlap")
    paths["stream"], paths["cli"] = stream_cli_phase(pipe, clips[0], counters)
    lap("stream_cli")
    del pipe
    torch.cuda.empty_cache()
    paths["e2e_score"], e2e_metrics = e2e_score_phase(counters)
    lap("e2e_score")

    # 6-9. the single-peak pipeline, the trainers, the int8 path, the options ----
    torch.cuda.empty_cache()
    paths["single_peak"] = single_peak_phase(clips, boxes, counters)
    lap("single_peak")
    paths["train"] = train_phase(counters)
    lap("train")
    paths["int8_path"], requant_entry = int8_phase(counters, err)
    lap("int8_path")
    entries.append(requant_entry)
    say("time", **{k: requant_entry[k] for k in TIME_KEYS if k in requant_entry})
    torch.cuda.empty_cache()
    paths["options"] = options_phase(clips, boxes, counters)
    lap("options")
    torch.cuda.empty_cache()
    paths["bench"] = bench_phase()
    lap("bench")
    torch.cuda.empty_cache()
    paths["parallel"] = parallel_phase(clips, reference, counters)
    lap("parallel")
    torch.cuda.empty_cache()
    paths["cascade"] = cascade_phase(counters)
    lap("cascade")
    torch.cuda.empty_cache()
    paths.update(retrain_chain_phase(counters, e2e_metrics))
    lap("retrain_chain")
    torch.cuda.empty_cache()
    bf16_paths, bf16_entry = preprocess_bf16_phase(clips, boxes, counters)
    paths.update(bf16_paths)
    entries.append(bf16_entry)
    lap("preprocess_bf16")
    entries.append(group_norm_entry)
    names = ("preprocess", "gcn_tail", "softdtw", "decode", "softdtw_bwd", "requant",
             "preprocess_bf16", "group_norm")
    for en, k in zip(entries, names):
        en["launches"] = sum(p.get(k, 0) for p in paths.values())
        check(en["launches"] > 0, f"kernel {k} was launched on no driven path")
    say("launches", by_path=paths, phase_seconds=phase_seconds,
        smoke_seconds=round(time.perf_counter() - wall0, 3))

    # Only what this run counted, measured or (bound_ms) computed from its inputs.
    print(json.dumps({"kernels": [{k: en[k] for k in KERNEL_KEYS} for en in entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--options-repeats"]:
        sys.exit(options_repeat(int(sys.argv[2])))
    if sys.argv[1:2] == ["--group-norm"]:
        sys.exit(group_norm_only())
    sys.exit(main())
