"""Run one cell of the benchmark once, on this machine's card:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json's `workloads`) names
a configuration file (benchmark/configs/<config>.json) and a traffic file
(benchmark/traffic/<traffic>.json); each metric is read by
benchmark/metrics/<metric>.py.  Set-up builds the system and the pool of
clips on the card from the seed and warms up every request shape; then the
window runs the closed loop for --seconds (with --trace 1 under the
profiler for the traffic's first `trace_requests` requests); then sampled
requests' outputs are held to the plain reference (benchmark/check.py).

Prints one JSON line last on standard output: correct, attempted, failed,
metrics (the cell's end-to-end metrics at --trace 0, its per-layer metrics
at --trace 1), device, [breakdown], checked.  Exits 3 without a result when
no card (or too few) is there, and 4 when a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark.trace import Spans  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# The profiler's trace is exported here and read back (then deleted): inside
# the checkout, whatever TMPDIR holds or lacks.
TRACE_DIR = os.path.join(CACHE, "trace")
# Readings of a traced window at most: the profiler now and then loses records.
TRACE_ATTEMPTS = 3
FORBIDDEN = ("jax", "jaxlib", "flax", "golfaction_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration file, traffic file) of a cell."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, c["file"])) as f:
        conf = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return w, conf, traffic


def metric_units(spec: dict, workload: str, trace: bool) -> dict:
    """{name: unit} of the cell's per-layer (trace) or end-to-end metrics."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return {m["name"]: m["unit"] for m in group if workload in m.get("workloads", [workload])}


class Run:
    """What one run gives the metric readers: the window's requests, the
    traced requests and their trace, the stated configuration (the file's
    "pipeline" section, with the module name of its pose reference under
    "pose_reference"), the pool."""

    def __init__(self):
        self.done, self.traced, self.trace = [], [], None
        self.t0 = self.t1 = self.setup_s = 0.0
        self.stated = self.peaks = None
        self.image_hw = self.ref_frames = None
        self.tail_weights = []
        self._pool, self._crop_boxes = None, {}

    def inputs(self, item):
        """(frames, boxes, valid) of a request item (chunk, clip or None)."""
        frames, boxes, valid = self._pool[item[0]]
        if item[1] is None:
            return frames, boxes, valid
        k = item[1]
        return frames[k:k + 1], boxes[k:k + 1], valid[k:k + 1]

    def request_shape(self, item) -> tuple:
        return tuple(self.inputs(item)[2].shape)

    def crop_boxes(self, item):
        """Centre-scale boxes [N*T, 4] of every frame the request crops."""
        if item not in self._crop_boxes:
            from benchmark.reference import decode
            p = self.stated["pose"]
            b = self.inputs(item)[1]
            self._crop_boxes[item] = decode.center_scale(
                b.reshape(-1, 4).float(), p["input_hw"][1] / p["input_hw"][0]).cpu()
        return self._crop_boxes[item]


def _card(device) -> dict:
    import torch

    kind = torch.cuda.get_device_name(device)
    out = {"platform": "gpu", "kind": kind, "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        print(f"[device] {smi[0] if smi else kind}", file=sys.stderr)
    except (OSError, subprocess.SubprocessError):
        print(f"[device] {kind}", file=sys.stderr)
    return out


def _thresholds(conf: dict, root: str, device):
    """The fault thresholds [E] the configuration states (benchmark's own read)."""
    import torch

    th = conf["thresholds"]
    if isinstance(th, (int, float)):
        return torch.full((len(conf["faults"]),), float(th), device=device)
    with open(os.path.join(root, th)) as f:
        d = json.load(f)
    return torch.tensor([float(d.get(k, 0.5)) for k in conf["faults"]], device=device)


class Session:
    """A cell set up for one seed: the system, the pool on the card, the
    system's analysis of the reference swing, and `issue(item)`, which sends
    one request through the per-chunk program.  With `program` False, only
    the weights and the pool (for the control, benchmark/control.py)."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device, root: str = ROOT,
                 program: bool = True):
        import numpy as np
        import torch

        from benchmark import render, system, traffic as gen
        from benchmark.reference import pose_reference

        self.conf, self.traffic, self.seed, self.root = conf, traffic, seed, root
        self.dev = torch.device(device)
        self.run = run = Run()
        run.stated = dict(conf["pipeline"], pose_reference=pose_reference(conf).__name__)
        run.image_hw = tuple(traffic["image_hw"])
        run.ref_frames = traffic["render_frames"]
        self.phases = {}
        self.spans = Spans()
        t = time.perf_counter()
        with torch.inference_mode():
            self.pipe, self.state = system.build(conf, seed, self.dev, root, program)
            self.phases["weights"] = -t + (t := time.perf_counter())
            s = render.render_swing(seed, traffic["render_frames"], run.image_hw)
            self.phases["render"] = -t + (t := time.perf_counter())
            base = torch.from_numpy(s.frames).to(self.dev)
            base_boxes = torch.from_numpy(np.asarray(s.boxes, np.float32)).to(self.dev)
            self.plan = gen.plan(traffic, seed)
            run._pool = [gen.build_chunk(base, base_boxes, clips)
                         for _, clips in self.plan.chunks]
            valid = torch.ones((1, base.shape[0]), dtype=torch.bool, device=self.dev)
            self.ref_swing = {"frames": base[None], "boxes": base_boxes[None], "valid": valid}
            if program:
                out = self.pipe._core_fn(base[None], base_boxes[None], valid)
                self.ref_swing.update(keypoints=out["keypoints"], kpt_aux=out.get("kpt_aux"))
                self.ref = (out["keypoints"][0], valid[0])
        self.phases["pool"] = time.perf_counter() - t
        self.thresholds = _thresholds(conf, root, self.dev)

    def lengths(self, item) -> list:
        clips = self.plan.chunks[item[0]][1]
        return [c.length for c in clips] if item[1] is None else [clips[item[1]].length]

    def issue(self, item):
        """One request -> (outputs, valid frames, valid length of each clip)."""
        from benchmark import system

        frames, boxes, valid = self.run.inputs(item)
        out = system.request(self.pipe, frames, boxes, valid, self.ref, self.spans)
        lengths = self.lengths(item)
        return out, sum(lengths), lengths

    def warm_up(self) -> list:
        """Each request shape of this traffic, twice; -> the shapes."""
        import torch

        shapes: dict = {}
        for item in self.plan.items:
            shapes.setdefault(self.run.request_shape(item), item)
        with torch.inference_mode():
            for item in shapes.values():
                for _ in range(2):
                    self.issue(item)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return sorted(shapes)

    def measure(self, seconds: float, trace: bool) -> None:
        """The window: --seconds of the closed loop; with `trace`, its first
        `trace_requests` requests under the profiler (`traced`), read once the
        window has closed (`whole_trace`)."""
        import torch

        from benchmark import traffic as gen, window

        run, t = self.run, self.traffic
        order = gen.request_order(self.plan.items, self.seed)
        cuda = self.dev.type == "cuda"
        with torch.inference_mode():
            run.t0 = time.perf_counter()
            end = run.t0 + seconds
            if trace:
                if not cuda:
                    raise ValueError("a traced run reads the card's trace: it needs a card")
                taken = self.traced(order)
                run.done = list(run.traced)
            run.done += window.closed_loop(self.issue, order, t["in_flight"],
                                           lambda n, now: now >= end, self.dev)
        run.t1 = end
        self.memory_peak = torch.cuda.max_memory_allocated(self.dev) if cuda else 0
        if trace:
            first = run.traced
            run.trace = whole_trace(taken, lambda: self.traced(order), read_trace)
            if run.traced is not first:        # traced anew, after the window
                run.done += run.traced

    def traced(self, order) -> tuple:
        """`trace_requests` requests of the closed loop under the profiler,
        padded on both sides (benchmark.trace.pad), into `run.traced`, with
        the program's recorder emptied first -> (profile, span edges)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from benchmark import program_spans, trace as tr, window

        t = self.traffic
        program_spans.reset()
        self.spans = Spans(self.dev, on=True)
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
            tr.pad(self.dev, tr.LEAD)
            with self.spans.span("bench.window"):
                self.run.traced = window.closed_loop(
                    self.issue, order, t["in_flight"],
                    lambda n, now: n >= t["trace_requests"], self.dev, self.spans)
            tr.pad(self.dev, tr.TAIL, tr.TAIL_PAUSE_S)
        edges, self.spans = self.spans.edges, Spans()
        return prof, edges

    def picked(self) -> list:
        """The window's requests whose outputs are checked, drawn from the seed."""
        from benchmark import traffic as gen

        done = self.run.done
        k = min(self.traffic["check_requests"], len(done))
        idx = gen.seed_rng(self.seed, 3).choice(len(done), size=k, replace=False)
        return [done[i] for i in sorted(idx.tolist())]

    def judge(self, outputs: list, ref_swing: dict = None) -> dict:
        """outputs: [(item, outputs)] -> the check's numbers.  Frees the
        system first: the reference runs after it, in blocks."""
        import torch

        from benchmark import check, counts
        from benchmark.reference.pipeline import Reference

        self.pipe = None
        for d in self.run.done:
            d.out = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        reference = Reference(self.conf, self.state, self.dev)
        self.run.tail_weights = [counts.tail_parameters(b) for b in reference.gcn.blocks]
        by_item: dict = {}
        for item, out in outputs:
            by_item.setdefault(item, []).append(out)
        items = [(*self.run.inputs(it), outs) for it, outs in by_item.items()]
        with torch.inference_mode():
            return check.judge(reference, items, ref_swing or self.ref_swing, self.thresholds)


def read_trace(taken: tuple):
    """(profile, span edges) -> benchmark.trace.Trace, by way of a file inside
    the checkout (deleted once read)."""
    from benchmark.trace import Trace

    prof, edges = taken
    os.makedirs(TRACE_DIR, exist_ok=True)
    return Trace.from_profiler(prof, os.path.join(TRACE_DIR, f"window_{os.getpid()}.json"), edges)


def whole_trace(taken, take, read, attempts: int = TRACE_ATTEMPTS):
    """read(taken); where the profiler lost records inside the window
    (benchmark.trace.Lost), trace anew with take() and read that, up to
    `attempts` readings in all, each loss named on stderr."""
    from benchmark.trace import Lost

    for attempt in range(1, attempts + 1):
        try:
            return read(taken)
        except Lost as e:
            print(f"[trace] reading {attempt} of {attempts}: {e}", file=sys.stderr)
            if attempt == attempts:
                raise
            taken = take()


def execute(conf: dict, traffic: dict, seed: int, seconds: float, trace: bool,
            device="cuda", root: str = ROOT, metrics: dict = None) -> dict:
    """One run of a cell: set-up, window, check.  Returns the result dict
    (`correct`, `attempted`, `failed`, `metrics`, `device`[, `breakdown`],
    `checked`).  `metrics`: {reader name: unit} of the metrics to report."""
    import torch

    from benchmark import check, counts

    dev = torch.device(device)
    if dev.type == "cuda":
        card = _card(dev)
        peaks = counts.peaks(card["kind"])
        from golfaction_tpu_torch.ops import _kernels
        _kernels.build_all()
    else:
        card, peaks = {"platform": "cpu", "kind": "cpu", "count": 1}, None
    session = Session(conf, traffic, seed, dev, root)
    run = session.run
    run.peaks = peaks
    t = time.perf_counter()
    shapes = session.warm_up()
    run.setup_s = time.perf_counter() - _T_START
    phases = dict(session.phases, warm_up=time.perf_counter() - t)
    print(f"[setup] {run.setup_s:.3f} s ({', '.join(f'{k} {v:.2f}' for k, v in phases.items())}); "
          f"{len(run._pool)} chunks in the pool; request shapes {shapes}", file=sys.stderr)
    session.measure(seconds, trace)
    t = time.perf_counter()
    print(f"[window] {len(run.done)} requests; {t - run.t1:+.3f} s past its end"
          + (f"; traced {len(run.traced)}" if trace else ""), file=sys.stderr)
    picked = [(d.item, d.out) for d in session.picked()]
    numbers = session.judge(picked)
    print(f"[check] {len(picked)} requests in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    correct, shown = check.verdict(numbers, conf["limits"])

    result = {"correct": bool(correct), "attempted": len(run.done), "failed": 0}
    values = {}
    for name, unit in (metrics or {}).items():
        v = importlib.import_module(f"benchmark.metrics.{name}").read(run)
        if v is not None:
            values[name] = {"value": float(v), "unit": unit}
    result["metrics"] = values
    result["device"] = dict(card, memory_peak_bytes=int(session.memory_peak))
    if trace and run.trace is not None:
        result["device"].update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s())
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checked"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                         for k, v in shown.items()}
    return result


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    spec = load_spec()
    w, conf, traffic = cell(spec, args.workload)
    # Build and kernel caches inside the checkout, at fixed paths.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: the cell needs {w['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = execute(conf, traffic, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                     metrics=metric_units(spec, args.workload, bool(args.trace)))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in result["checked"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
