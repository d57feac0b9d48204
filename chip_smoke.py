#!/usr/bin/env python3
"""Drive golfaction_tpu_torch on one CUDA card and hold its kernels to their
plain PyTorch versions.

    python3 chip_smoke.py

Phases (each prints one line; any failure exits non-zero):
  1. device    the card's name and power limit (nvidia-smi)
  2. build     nvcc of every kernel source, all started together
  3. parity    each kernel against its plain version at the main path's
               shapes, float32 with TF32 off
  4. main      the shipped model (artifacts/) at full width: analyze,
               compare-mode analyze and analyze_batch of 4 clips with a
               reference, on 64-frame 1080p clips rendered from a seed;
               output checks, launch counts, and the same program on the
               CPU (plain versions) on a small input as the reference
  5. times     kernel, plain and library times (CUDA events) at the main
               path's shapes, each kernel's bound, and end-to-end frames/s
Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

A kernel's `launches` counts calls of its wrapper.  The GCN tail's call is
three __global__ launches (frame tiles, per-clip gates, apply); the others'
is one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
CLIP_T, VIDEO_HW, BATCH_CLIPS = 64, (1080, 1920), 4


class SmokeFailure(RuntimeError):
    pass


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

def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() over `reps` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def preprocess_bytes_ops(boxes: torch.Tensor, H: int, W: int, oh: int, ow: int):
    """Bytes the warp must move: the source pixels its taps touch (3 B each)
    plus the float32 output; ops: 47 float operations per output pixel."""
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
    out = b.shape[0] * oh * ow * 3 * 4
    return touched + out + b.numel() * 4, 47.0 * b.shape[0] * oh * ow


def gcn_tail_bytes_ops(B: int, T: int, V: int, w) -> tuple[float, float]:
    """x read and out written once, la and the packed weights read once;
    ops counted per row (the C x C branch product dominates) plus the
    per-frame and per-joint gate MLPs."""
    C, M = w.C, w.M
    rows = B * T * V
    nbytes = 2 * rows * C * 4 + B * 4 + w.packed.numel() * 4
    per_row = 2 * C * C + 60 * C
    gates = B * (T + V) * (2 * C * M + 2 * M * C + 10 * M) + B * 4 * C * M
    return nbytes, rows * per_row + gates


def wavefront_bytes_ops(B: int, Ta: int, Tb: int, gamma: float):
    return 2 * B * Ta * Tb * 4, B * Ta * Tb * (17 if gamma > 0 else 3)


def breakdown(pipe, clips, boxes, reference) -> None:
    """Where one analyze_batch chunk spends its time: host stage times
    (each ends in a synchronize), then a torch.profiler trace of the device
    programs with the device's busy share and its costliest kernels."""
    from torch.profiler import ProfilerActivity, profile

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
        fr = stage("to_device_ms", lambda: pipe._to_device([p[0] for p in prep]))
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

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # Kernel rows only: operator rows carry their kernels' time again.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    window_ms = stages["core_ms"] + stages["align_ms"]      # the same work, unprofiled
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    say("profile", region="core+align of one chunk", profiled_wall_ms=wall_ms,
        unprofiled_wall_ms=window_ms, device_busy_ms=busy_ms if kernels else "not measured",
        device_idle_share=(1 - busy_ms / window_ms) if kernels else "not measured",
        top=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "a CUDA card", file=sys.stderr)
        return 2
    from golfaction_tpu_torch.ops import _kernels, gcn_tail, preprocess, softdtw
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
    from golfaction_tpu_torch.types import Skeleton

    wall0 = time.perf_counter()
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
    _kernels.build_all()
    say("build", seconds=round(time.perf_counter() - t0, 3), sources=list(_kernels.SOURCES))

    pipe = Pipeline.from_artifacts("artifacts", device="cuda")
    cfg = pipe.cfg
    oh, ow = cfg.pose.input_hw
    H, W = VIDEO_HW
    rng = np.random.default_rng(0)
    kp_clips = [swing_keypoints(CLIP_T, rng) for _ in range(2 + BATCH_CLIPS)]
    clips = [render_clip(k, seed=i) for i, k in enumerate(kp_clips)]
    boxes = [boxes_of(k) for k in kp_clips]
    say("render", clips=len(clips), frames=CLIP_T, hw=list(VIDEO_HW),
        seconds=round(time.perf_counter() - t0, 3))

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

    # 4. main path ----------------------------------------------------------
    counters = {"preprocess": preprocess.crop_resize_normalize,
                "gcn_tail": gcn_tail.gcn_block_tail, "softdtw": softdtw.wavefront}
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
        global_launches_per_call={"preprocess": 1, "gcn_tail": 3, "softdtw": 1},
        decode_tracking=cfg.pose.decode_tracking, mode_features=cfg.error.mode_features)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")

    from golfaction_tpu_torch.config import NUM_ERRORS, NUM_PHASES

    lb = int(reference.valid.sum())
    for r in [res_ref, res_cmp, *res_batch]:
        check(isinstance(r.keypoints, torch.Tensor), f"analyze_batch returned {r!r}")
        T = r.valid.shape[0]
        check(tuple(r.keypoints.shape) == (T, 17, 3), "keypoint shape")
        check(tuple(r.phase_logits.shape) == (T, NUM_PHASES), "phase logit shape")
        check(tuple(r.error_probs.shape) == (NUM_ERRORS,), "error prob shape")
        check(bool(torch.isfinite(r.keypoints).all() and torch.isfinite(r.phase_logits).all()
                   and torch.isfinite(r.error_probs).all()), "non-finite output")
        lab = r.phase_labels[r.valid]
        check(bool(((lab >= 0) & (lab < NUM_PHASES)).all()), "phase label out of range")
        if r is res_ref:
            continue
        a = r.alignment
        la, n = int(r.valid.sum()), int(a.path_length)
        check(max(la, lb) <= n <= la + lb - 1, f"path length {n} for {la}x{lb}")
        p = a.path[:n].cpu()
        steps = p[1:] - p[:-1]
        check(p[0].tolist() == [0, 0] and p[-1].tolist() == [la - 1, lb - 1], "path ends")
        check(bool(((steps >= 0) & (steps <= 1)).all() and (steps.sum(1) >= 1).all()),
              "path not monotone")
        check(bool(torch.isfinite(a.cost)), "alignment cost not finite")
    say("main_checks", results=2 + len(res_batch), ok=True,
        phase_labels=res_cmp.phase_labels[:8].tolist(),
        error_probs=[round(float(v), 6) for v in res_cmp.error_probs],
        cost=float(res_cmp.alignment.cost), path_length=int(res_cmp.alignment.path_length))

    # The same program on the CPU (plain versions) on a small input.
    cpu = Pipeline.from_artifacts("artifacts", device="cpu")
    small = [c[:20] for c in clips[2:4]]
    small_boxes = [b[:20] for b in boxes[2:4]]
    ref_small = Skeleton(keypoints=reference.keypoints[:40].cpu(),
                         valid=reference.valid[:40].cpu())
    r_gpu = pipe.analyze_batch(small, boxes=small_boxes, reference=ref_small)
    r_cpu = cpu.analyze_batch(small, boxes=small_boxes, reference=ref_small)
    diffs = {"keypoints": 0.0, "phase_logits": 0.0, "error_probs": 0.0, "cost_rel": 0.0}
    for g, c in zip(r_gpu, r_cpu):
        for k in ("keypoints", "phase_logits", "error_probs"):
            diffs[k] = max(diffs[k], float((getattr(g, k).cpu() - getattr(c, k)).abs().max()))
        diffs["cost_rel"] = max(diffs["cost_rel"], float(
            (g.alignment.cost.cpu() - c.alignment.cost).abs() / c.alignment.cost.abs()))
        check(torch.equal(g.phase_labels.cpu(), c.phase_labels), "phase labels differ from CPU")
        check(torch.equal(g.alignment.path.cpu(), c.alignment.path), "path differs from CPU")
    say("reference_cpu", frames=20, clips=2, max_diff=diffs,
        atol={"keypoints": 1e-2, "phase_logits": 1e-3, "error_probs": 1e-4, "cost_rel": 1e-4})
    check(diffs["keypoints"] <= 1e-2 and diffs["phase_logits"] <= 1e-3
          and diffs["error_probs"] <= 1e-4 and diffs["cost_rel"] <= 1e-4,
          "card and CPU disagree on the small input")

    # 5. times --------------------------------------------------------------
    entries = []
    nb, ops = preprocess_bytes_ops(boxes_a, H, W, oh, ow)
    ms = cuda_ms(lambda: preprocess.crop_resize_normalize(frames_a, boxes_a, (oh, ow)))
    plain = cuda_ms(lambda: preprocess.crop_resize_normalize_reference(frames_a, boxes_a,
                                                                        (oh, ow)), reps=5)
    src = frames_a.permute(0, 3, 1, 2).float().contiguous()
    gx = preprocess._sample_coords(boxes_a, ow, axis=0) / (W - 1) * 2 - 1     # [B, ow]
    gy = preprocess._sample_coords(boxes_a, oh, axis=1) / (H - 1) * 2 - 1     # [B, oh]
    grid = torch.stack([gx[:, None, :].expand(-1, oh, -1),
                        gy[:, :, None].expand(-1, -1, ow)], dim=-1).contiguous()
    lib = cuda_ms(lambda: F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                        align_corners=True))
    del src
    bms, by = bound(nb, ops)
    entries.append(dict(name="crop_resize_normalize", route="cuda",
                        source="golfaction_tpu_torch/csrc/preprocess.cu",
                        replaces="golfaction_tpu/ops/pallas/preprocess_kernel.py:127",
                        launches=launches["preprocess"], max_abs_err=err["preprocess"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                        shape=[fb, H, W, 3], bytes=nb, ops=ops))

    ms = plain = nb = ops = 0.0
    for blk, x in zip(pipe.gcn_model.blocks, tail_x):
        la_full = torch.full((BATCH_CLIPS,), CLIP_T, dtype=torch.int32, device=dev)
        ms += cuda_ms(lambda: gcn_tail.gcn_block_tail(x, la_full, blk.tail))
        plain += cuda_ms(lambda: gcn_tail.gcn_block_tail_plain(x, la_full, blk.tail), reps=5)
        b_, o_ = gcn_tail_bytes_ops(BATCH_CLIPS, CLIP_T, 17, blk.tail)
        nb, ops = nb + b_, ops + o_
    bms, by = bound(nb, ops)
    entries.append(dict(name="gcn_block_tail", route="cuda",
                        source="golfaction_tpu_torch/csrc/gcn_tail.cu",
                        replaces="golfaction_tpu/ops/pallas/gcn_kernel.py:319",
                        launches=launches["gcn_tail"], max_abs_err=err["gcn_tail"],
                        ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                        shape="six blocks, x [4, 64, 17, C], C in (64,64,128,128,256,256)",
                        bytes=nb, ops=ops))

    e = torch.nn.functional.normalize(torch.randn((BATCH_CLIPS, 2 * CLIP_T, 128),
                                                  generator=gen), dim=-1)
    D = softdtw.pairwise_sqdist(e[:, :CLIP_T], e[:, CLIP_T:]).to(dev).contiguous()
    gam = cfg.align.gamma
    ms = sum(cuda_ms(lambda g=g: softdtw.wavefront(D, g)) for g in (gam, 0.0))
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
                        shape="D [4, 64, 64], gamma 0.1 then 0", bytes=nb, ops=ops))
    for en in entries:
        say("time", **{k: en[k] for k in ("name", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "shape")})

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
    breakdown(pipe, clips[2:], boxes[2:], reference)

    print(json.dumps({"kernels": [{k: v for k, v in en.items()
                                   if k not in ("shape", "bytes", "ops")}
                                  for en in entries]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
