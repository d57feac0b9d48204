"""Time `Pipeline.analyze_batch` of the PyTorch port over 12 1080p clips in 3
chunks (clip_batch 4, a reference swing), once per variant, each in a fresh
process, on one CUDA card:

  * `tree:<dir>`: the port as it stands in <dir> (e.g. a `git archive` of an
    earlier commit) — for the parent, the pageable copy on the compute
    stream;
  * `stager`: this checkout's `_Stager` (pinned ring, copy thread, side
    stream, the compute stream waiting on the copy's event);
  * `pinned`: the same pinned ring with no side stream and no copy thread:
    for each chunk the main thread fills the slots, the card copies them on
    the compute stream (non_blocking), then the chunk's programs are issued;
    the host fills the next chunk while the card runs this one.

    git archive <commit> golfaction_tpu_torch | tar -x -C archive_check/parent
    python tools/overlap_compare.py --out chiprun_out/overlap.json \\
        tree:archive_check/parent stager pinned pinned stager tree:archive_check/parent

Frames are random (the models' outputs do not matter here); every variant
loads the shipped weights from --artifacts.  Each variant prints one JSON line:
frames/s of each timed call after a warm one, and the card's idle share over
one call from torch.profiler kernel rows (copies left out).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses
import json
import os
import subprocess
import sys
import time

CLIPS, CHUNK, T, HW = 12, 4, 64, (1080, 1920)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Deferred:
    """A one-worker executor whose task runs on the caller when its result
    is asked for: a chunk is staged just before its programs are issued,
    so the host fills the next chunk while the card runs this one."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        fut = cf.Future()
        real_result = fut.result

        def result(timeout=None):
            if not fut.done():
                fut.set_result(fn(*args))
            return real_result(timeout)

        fut.result = result
        return fut


def _pinned_only(orch):
    """Patch `orch` so that analyze_batch stages through the pinned ring with
    neither a copy thread nor a side stream."""
    import torch

    class PinnedOnly(orch._Stager):
        def __init__(self, device):
            super().__init__(device)
            self.stream = torch.cuda.current_stream(device)

    class Executors:
        @staticmethod
        def ThreadPoolExecutor(max_workers=None):
            if max_workers == 1:
                return _Deferred()
            return cf.ThreadPoolExecutor(max_workers=max_workers)

        as_completed = staticmethod(cf.as_completed)
        Future = cf.Future

    orch._Stager = PinnedOnly
    orch.cf = Executors


def run_variant(variant: str, reps: int, artifacts: str) -> dict:
    tree = variant.split(":", 1)[1] if variant.startswith("tree:") else ROOT
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from golfaction_tpu_torch import types
    from golfaction_tpu_torch.pipeline import orchestrator as orch

    if variant == "pinned":
        _pinned_only(orch)
    pipe = orch.Pipeline.from_artifacts(artifacts, device="cuda")
    pipe.cfg = dataclasses.replace(pipe.cfg, clip_batch=CHUNK)
    rng = np.random.default_rng(0)
    four = [rng.integers(0, 256, (T, *HW, 3), dtype=np.uint8) for _ in range(CHUNK)]
    box = np.array([HW[1] * 0.4, HW[0] * 0.2, HW[1] * 0.2, HW[0] * 0.6], np.float32)
    boxes = [np.tile(box, (T, 1))] * CHUNK
    ref_k = rng.uniform(0, 500, (T, 17, 3)).astype(np.float32)
    reference = types.Skeleton(keypoints=torch.from_numpy(ref_k).cuda(),
                               valid=torch.ones(T, dtype=torch.bool, device="cuda"))
    clips, clip_boxes = four * (CLIPS // CHUNK), boxes * (CLIPS // CHUNK)

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.analyze_batch(clips, boxes=clip_boxes, reference=reference)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()                                            # warm
    walls = [call() for _ in range(reps)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = call()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()   # kernel rows only
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0 and "Memcpy" not in e.key
                  and "Memset" not in e.key)
    return {"variant": variant, "frames": CLIPS * T, "chunks": CLIPS // CHUNK,
            "walls_s": walls, "frames_per_s": [CLIPS * T / w for w in walls],
            "median_frames_per_s": float(np.median([CLIPS * T / w for w in walls])),
            "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / 1e3 / (wall * 1e3),
            "copy_ms": list(getattr(pipe, "last_copy_ms", []) or [])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--artifacts", default=os.path.join(ROOT, "artifacts"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_variant(args.variants[0], args.reps, args.artifacts)), flush=True)
        return 0
    rows = []
    for v in args.variants:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", "--reps",
                            str(args.reps), "--artifacts", args.artifacts, v],
                           capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout, p.stderr, file=sys.stderr)
            return p.returncode
        rows.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
