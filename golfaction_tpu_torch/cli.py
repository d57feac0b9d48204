"""Command-line interface of the port, mirroring the JAX package's `cli.py`:

    python -m golfaction_tpu_torch.cli analyze swing.mp4 [--reference pro.mp4]
        [--checkpoint artifacts] [--out res.json] [--render overlay.mp4] [--report]
    python -m golfaction_tpu_torch.cli compare swing.mp4 pro.mp4 [--out-video cmp.mp4]
    python -m golfaction_tpu_torch.cli stream swing.mp4|clip.npy|camera:N
    python -m golfaction_tpu_torch.cli train {pose,gcn,align,error} [--steps N]
    python -m golfaction_tpu_torch.cli bench [bench.py's flags]

Every subcommand takes --checkpoint, --preset, --set KEY=VALUE (repeatable)
and --device (default cuda; cpu runs the kernels' plain versions).  For
analyze, compare and stream the checkpoint is an artifacts tree of npz
checkpoints (the shipped model's form; without one the weights are random
from seed 0, as the JAX CLI's); for train it is a step checkpoint (.pt) of an
earlier run to resume, and --set edits the model's section of the preset.
`bench` runs golfaction_tpu_torch/bench.py with the other arguments and
--device.  Outputs are JSON on stdout; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from golfaction_tpu_torch import checkpoint, weights
from golfaction_tpu_torch import config as cfg_mod
from golfaction_tpu_torch.pipeline import report as report_mod
from golfaction_tpu_torch.pipeline import streaming, video_io, visualize
from golfaction_tpu_torch.pipeline.orchestrator import Pipeline
from golfaction_tpu_torch.types import to_numpy


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _pipeline(args, extra_buckets=()):
    """(Pipeline, per-fault thresholds or 0.5) of the subcommand's options."""
    sets = list(args.set)
    if extra_buckets:
        buckets = cfg_mod.apply_overrides(cfg_mod.get_config(args.preset), sets).length_buckets
        sets.append(f"length_buckets={tuple(sorted({*buckets, *extra_buckets}))}")
    if not args.checkpoint:
        cfg = cfg_mod.apply_overrides(cfg_mod.get_config(args.preset), sets)
        return Pipeline(cfg, device=args.device), 0.5
    pipe = Pipeline.from_artifacts(args.checkpoint, args.preset, device=args.device,
                                   overrides=sets)
    _log(f"restored params from {args.checkpoint}")
    if pipe.error_thresholds is None:
        return pipe, 0.5
    _log("using calibrated per-fault error thresholds")
    return pipe, to_numpy(pipe.error_thresholds)


def cmd_analyze(args):
    pipe, thr = _pipeline(args)
    reference = None
    if args.reference:
        _log(f"analyzing reference swing {args.reference} ...")
        reference = pipe.extract_skeleton(pipe.analyze(args.reference))
    _log(f"analyzing {args.video} ...")
    res = pipe.analyze(args.video, reference=reference, error_threshold=thr)
    T = int(to_numpy(res.valid).sum())
    out = {
        "num_frames": T,
        "keypoints": to_numpy(res.keypoints)[:T].tolist(),
        "phase_labels": [cfg_mod.SWING_PHASES[i] for i in to_numpy(res.phase_labels)[:T]],
        "error_probs": dict(zip(cfg_mod.SWING_ERRORS,
                                to_numpy(res.error_probs).round(4).tolist())),
        "error_flags": [name for name, f in zip(cfg_mod.SWING_ERRORS,
                                                to_numpy(res.error_flags)) if f],
    }
    if res.alignment is not None:
        L = int(res.alignment.path_length)
        out["alignment"] = {"cost": float(res.alignment.cost),
                            "path": to_numpy(res.alignment.path)[:L].tolist()}
    if args.report:
        rep = report_mod.build_report(res, error_threshold=thr,
                                      reference_name=args.reference or "reference swing")
        out["report"] = rep
        _log(report_mod.format_report(rep))
    if args.render:
        if args.video.endswith(".npy"):
            frames, fps = np.load(args.video), 30.0
        else:
            frames, fps = video_io.load_video(args.video)
        visualize.write_video(args.render, visualize.render_analysis(frames, res), fps=fps)
        _log(f"wrote overlay video {args.render}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
        _log(f"wrote {args.out}")
        print(json.dumps({k: v for k, v in out.items() if k != "keypoints"}))
    else:
        print(json.dumps(out))


def cmd_compare(args):
    """A swing against a reference swing: the report and an aligned
    side-by-side video."""
    pipe, thr = _pipeline(args)
    _log(f"analyzing reference {args.reference} ...")
    ref_res = pipe.analyze(args.reference)
    _log(f"analyzing {args.video} ...")
    res = pipe.analyze(args.video, reference=pipe.extract_skeleton(ref_res),
                       error_threshold=thr)
    rep = report_mod.build_report(res, error_threshold=thr, reference_name=args.reference)
    _log(report_mod.format_report(rep))
    if args.out_video:
        frames_a, _ = video_io.load_video(args.video)
        frames_b, _ = video_io.load_video(args.reference)
        panels = visualize.render_comparison(
            frames_a, res.keypoints, frames_b, ref_res.keypoints, res.alignment.path,
            int(res.alignment.path_length), max_pairs=args.max_pairs)
        visualize.write_video(args.out_video, panels, fps=12)
        _log(f"wrote comparison video {args.out_video}")
        rep["comparison_video"] = args.out_video
    print(json.dumps(rep))


def cmd_stream(args):
    """Incremental analysis of a live or simulated frame source: one JSON
    line a frame, then the latency summary on stderr."""
    pipe, _ = _pipeline(args, extra_buckets=(args.window,))
    sa = streaming.StreamAnalyzer(pipe, window=args.window, hop=args.hop)
    push_t: dict[int, float] = {}
    latencies: list[tuple[int, float]] = []
    n_pushed = 0
    t0 = time.perf_counter()

    def emit(results, flushing=False):
        for r in results:
            lat = time.perf_counter() - (push_t.pop(r["frame_index"], t0) if flushing
                                         else push_t.pop(r["frame_index"]))
            latencies.append((r["frame_index"], lat))
            line = {"frame_index": r["frame_index"], "phase": r["phase"],
                    "latency_ms": round(lat * 1e3, 1)}
            if args.keypoints and not flushing:
                line["keypoints"] = np.asarray(r["keypoints"]).round(2).tolist()
            print(json.dumps(line), flush=True)

    for frame in video_io.frame_source(args.source, realtime=args.realtime,
                                       max_frames=args.max_frames, npy_fps=args.fps):
        push_t[n_pushed] = time.perf_counter()
        n_pushed += 1
        emit(sa.push(frame))
    emit(sa.flush(), flushing=True)
    wall = time.perf_counter() - t0
    # The steady state leaves out the first window (start-up and backlog).
    steady = [lat for i, lat in latencies if i >= args.window]
    _log(json.dumps({
        "frames": n_pushed,
        "throughput_fps": round(n_pushed / wall, 1),
        "startup_latency_s": round(latencies[0][1], 3) if latencies else None,
        "steady_latency_ms_mean": round(float(np.mean(steady)) * 1e3, 1) if steady else None,
        "steady_latency_ms_p95": (round(float(np.percentile(steady, 95)) * 1e3, 1)
                                  if steady else None),
        "host_boxes": sa.host_boxes,
        "host_box_ms_per_hop": round(sa.host_box_s / max(sa.windows_processed, 1) * 1e3, 3),
    }))


def cmd_train(args):
    from golfaction_tpu_torch.train import loops

    tc = cfg_mod.TrainConfig(total_steps=args.steps, batch_size=args.batch_size,
                             checkpoint_dir=args.checkpoint_dir)
    cfg = cfg_mod.apply_overrides(cfg_mod.get_config(args.preset), args.set)
    trainer = getattr(loops, f"train_{args.model}")
    state, history = trainer(getattr(cfg, args.model), tc, resume_from=args.checkpoint,
                             device=args.device)
    for h in history:
        _log(json.dumps(h))
    os.makedirs(tc.checkpoint_dir, exist_ok=True)
    path = checkpoint.save_params_npz(
        os.path.join(tc.checkpoint_dir, f"{args.model}.npz"),
        weights.to_flax({args.model: state.params})[args.model])
    print(json.dumps({"model": args.model, "steps": state.step, "final": history[-1],
                      "checkpoint": path}))


def cmd_bench(args, bench_args):
    from golfaction_tpu_torch import bench

    rc = bench.main([*bench_args, "--device", args.device])
    if rc:
        sys.exit(rc)


def _common(p, checkpoint_help="artifacts tree of trained npz checkpoints"):
    p.add_argument("--checkpoint", help=checkpoint_help)
    p.add_argument("--preset", default="full_pipeline")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="config override, e.g. --set frame_batch=16 "
                        "--set pose.dtype=float32 (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="golfaction_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="analyze a swing video")
    a.add_argument("video")
    a.add_argument("--reference", help="pro swing video to align against")
    a.add_argument("--out", help="write full JSON result to file")
    a.add_argument("--render", metavar="OUT_MP4",
                   help="write an overlay video (skeleton + phase labels)")
    a.add_argument("--report", action="store_true",
                   help="include a coach-style swing report (phases, tempo, "
                        "faults, comparison)")
    _common(a)
    a.set_defaults(fn=cmd_analyze)

    c = sub.add_parser("compare", help="align two swings: report + side-by-side video")
    c.add_argument("video", help="the swing to review")
    c.add_argument("reference", help="the reference (pro) swing")
    c.add_argument("--out-video", help="write aligned side-by-side mp4")
    c.add_argument("--max-pairs", type=int, default=48,
                   help="max aligned frame pairs in the video")
    _common(c)
    c.set_defaults(fn=cmd_compare)

    s = sub.add_parser("stream", help="incremental analysis of a live/simulated frame "
                                      "source; JSONL per frame + latency summary")
    s.add_argument("source", help="video file, .npy array, or camera:N device")
    s.add_argument("--window", type=int, default=64)
    s.add_argument("--hop", type=int, default=16)
    s.add_argument("--realtime", action="store_true",
                   help="pace file decode at native fps (live simulation)")
    s.add_argument("--fps", type=float, default=30.0,
                   help="assumed capture fps for .npy sources under --realtime")
    s.add_argument("--max-frames", type=int, default=None)
    s.add_argument("--keypoints", action="store_true",
                   help="include keypoints in each JSONL line")
    _common(s)
    s.set_defaults(fn=cmd_stream)

    t = sub.add_parser("train", help="train one model on synthetic swings")
    t.add_argument("model", choices=["pose", "gcn", "align", "error"])
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--checkpoint-dir",
                   default=os.path.join(tempfile.gettempdir(), "golfaction_ckpt"))
    _common(t, checkpoint_help="step checkpoint (.pt) of an earlier run to resume")
    t.set_defaults(fn=cmd_train)

    b = sub.add_parser("bench", help="run the benchmark harness (golfaction_tpu_torch/bench.py; "
                                     "its flags follow)")
    b.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    b.set_defaults(fn=cmd_bench)

    args, extra = p.parse_known_args(argv)
    if args.cmd == "bench":
        args.fn(args, extra)
        return
    if extra:
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    args.fn(args)


if __name__ == "__main__":
    main()
