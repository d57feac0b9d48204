"""Name the (clip, fault) flags that flip between programs of the shipped model.

Scores the stratified fault set that `demo_e2e` scores,

    make_fault_balanced_batch(10, 48, seed=993000, image_hw=(540, 960),
                              render=True, clean=20,
                              scene_families=TRAIN_SCENE_FAMILIES)

clip by clip (each against the reference swing of seed 991000) through any
of these runs:

  * jax_bf16: the JAX package on the CPU at its shipped config, the GCN at
    float32 (the program its TPU path runs, ROADMAP reference behaviour
    (vii));
  * jax_bf16_kept: the same program compiled with every bfloat16 rounding
    kept (xla_allow_excess_precision off; XLA's default may keep values
    wider than bfloat16 inside fusions), the JAX package's own second
    bfloat16 program;
  * jax_f32: the jax_bf16 config with every model at float32;
  * port_bf16, port_f32: the PyTorch port on the CPU at both dtypes;
  * cuda_bf16, cuda_f32: the port on the card at both dtypes.

It prints each run's largest and mean gap to the jax_bf16 run over every
(clip, fault) and how many flags differ.  For every (clip, fault) whose flag
differs from the jax_bf16 run in any run, it prints each run's probability,
the fault's threshold (artifacts/error_thresholds.json) and the margin
|p - thr|, and whether each flipped run's probability lies within the JAX
package's own spread on that clip of the jax_bf16 probability: the spread
between its bfloat16 and float32 probabilities (the largest
|p_jax_bf16 - p_jax_f32| over the clip's faults) and the larger of that and
the spread between its two bfloat16 programs.  Then each run's per-fault F1
beside artifacts/demo/e2e_metrics.json's.

    python tools/fault_flips.py [--per-fault 10] [--save runs.json]
    python tools/fault_flips.py --device cuda --runs cuda_bf16,cuda_f32 --save card.json
    python tools/fault_flips.py --load card.json [--runs ...]

The JAX runs need JAX and the JAX package, which are imported only for them;
the card runs need a card.  `--load` merges the runs of earlier calls
(matched clip by clip on a hash of the rendered frames, which the report
prints where they differ).  The CPU runs at default sizes take tens of
minutes: `--per-fault` and `--clean` cut the set.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES, HW = 48, (540, 960)
F32 = ["pose.dtype='float32'", "gcn.dtype='float32'", "align.dtype='float32'",
       "error.dtype='float32'", "refine.dtype='float32'"]
RUNS = ("jax_bf16", "jax_bf16_kept", "jax_f32", "port_bf16", "port_f32", "cuda_bf16",
        "cuda_f32")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def stratified_clips(per_fault: int, clean: int, seed: int = 993_000):
    """demo_e2e's stratified set, one clip at a time."""
    from golfaction_tpu_torch.train import data

    return data.iter_fault_balanced(per_fault, FRAMES, seed=seed, image_hw=HW, render=True,
                                    clean=clean, scene_families=data.TRAIN_SCENE_FAMILIES)


def reference_frames() -> np.ndarray:
    from golfaction_tpu_torch.train import data

    return data.make_swing_batch(1, FRAMES, seed=991_000, image_hw=HW, render=True,
                                 fault_prob=0.0,
                                 scene_families=data.TRAIN_SCENE_FAMILIES)[0].frames


def _rounding_kept(jitted):
    """`jitted`, compiled for each new set of argument shapes with every
    bfloat16 rounding kept."""
    import jax

    cache = {}

    def call(*args):
        key = tuple((np.shape(a), str(getattr(a, "dtype", type(a))))
                    for a in jax.tree.leaves(args))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return cache[key](*args)

    return call


class JaxRun:
    """The JAX package's pipeline from the artifacts; `probs(frames)` -> [E]."""

    def __init__(self, artifacts: str, extra: list, ref: np.ndarray, kept: bool = False):
        import jax
        jax.config.update("jax_platforms", "cpu")
        from golfaction_tpu import config as jcfg
        from golfaction_tpu.pipeline import orchestrator as jorch
        from golfaction_tpu.train import checkpoint as jckpt

        sets = [f"video_hw={HW}", f"length_buckets=({FRAMES},)"] + extra
        cfg = jckpt.config_for_artifacts(
            jcfg.apply_overrides(jcfg.get_config("full_pipeline"), sets), artifacts)
        self.pipe = jorch.Pipeline(cfg, seed=0)
        self.pipe.params = jckpt.load_pipeline_params(artifacts, like=self.pipe.params)
        if kept:
            self.pipe._core = _rounding_kept(self.pipe._core)
            self.pipe._align_refine = _rounding_kept(self.pipe._align_refine)
        self.ref = self.pipe.extract_skeleton(self.pipe.analyze(ref))

    def probs(self, frames: np.ndarray) -> np.ndarray:
        return np.asarray(self.pipe.analyze(frames, reference=self.ref).error_probs)


class PortRun:
    """The port's pipeline from the artifacts on `device`."""

    def __init__(self, artifacts: str, extra: list, ref: np.ndarray, device: str):
        from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

        sets = [f"video_hw={HW}", f"length_buckets=({FRAMES},)"] + extra
        self.pipe = Pipeline.from_artifacts(artifacts, device=device, overrides=sets)
        self.ref = self.pipe.extract_skeleton(self.pipe.analyze(ref))

    def probs(self, frames: np.ndarray) -> np.ndarray:
        return self.pipe.analyze(frames, reference=self.ref).error_probs.cpu().numpy()


def make_run(name: str, artifacts: str, ref: np.ndarray):
    extra = {"bf16": ["gcn.dtype='float32'"] if name.startswith("jax") else [],
             "f32": F32}[name.split("_")[1]]
    if name.startswith("jax"):
        return JaxRun(artifacts, extra, ref, kept=name.endswith("kept"))
    return PortRun(artifacts, extra, ref, "cuda" if name.startswith("cuda") else "cpu")


def score(runs: list, artifacts: str, per_fault: int, clean: int) -> dict:
    """{"hashes": [clip], "truth": [clip][E], "probs": {run: [clip][E]}}."""
    ref = reference_frames()
    pipes = {}
    for name in runs:
        t0 = time.perf_counter()
        pipes[name] = make_run(name, artifacts, ref)
        _log(f"{name}: built and reference analyzed in {time.perf_counter() - t0:.1f} s")
    out = {"hashes": [], "truth": [], "probs": {name: [] for name in runs}}
    for i, s in enumerate(stratified_clips(per_fault, clean)):
        t0 = time.perf_counter()
        out["hashes"].append(hashlib.sha1(s.frames.tobytes()).hexdigest()[:16])
        out["truth"].append(np.asarray(s.error_flags, np.float32).tolist())
        for name, run in pipes.items():
            out["probs"][name].append(np.asarray(run.probs(s.frames), np.float64).tolist())
        _log(f"clip {i}: {time.perf_counter() - t0:.1f} s")
    return out


def merge(into: dict, other: dict) -> list:
    """Adds `other`'s runs to `into`; returns the clips whose frames differ."""
    if not into.get("hashes"):
        into.update(hashes=other["hashes"], truth=other["truth"], probs={})
    check = len(other["hashes"]) == len(into["hashes"])
    if not check or other["truth"] != into["truth"]:
        raise SystemExit("the loaded runs scored another clip set")
    into["probs"].update(other["probs"])
    return [i for i, (a, b) in enumerate(zip(into["hashes"], other["hashes"])) if a != b]


def report(res: dict, thresholds: np.ndarray) -> dict:
    """Prints each run against jax_bf16, the flips and the per-fault F1;
    returns the verdict."""
    from golfaction_tpu_torch import config as cfg_mod
    from golfaction_tpu_torch.train import metrics

    truth = np.asarray(res["truth"]) > 0.5
    p = {name: np.asarray(res["probs"][name]) for name in res["probs"]}
    cols = [n for n in RUNS if n in p]
    base = p["jax_bf16"]
    flag = {name: v > thresholds for name, v in p.items()}
    # The JAX package's own spread on each clip: the largest gap over its
    # faults between its bfloat16 program and its float32 one, and between
    # its two bfloat16 programs.
    spread = {k: np.abs(base - p[k]).max(axis=1) for k in ("jax_f32", "jax_bf16_kept") if k in p}
    print("against jax_bf16 over every (clip, fault): largest and mean |p - p_jax_bf16|, "
          "flags that differ")
    pairs = {}
    for n in cols[1:]:
        d = np.abs(p[n] - base)
        pairs[n] = {"max": float(d.max()), "mean": float(d.mean()),
                    "flags_differ": int((flag[n] != flag["jax_bf16"]).sum())}
        print(f"  {n:14s} {d.max():.5f} {d.mean():.5f} {pairs[n]['flags_differ']:3d}")
    print(f"\n{'clip':>4} {'fault':15s} {'truth':5s} {'thr':>5s} "
          + " ".join(f"{n:>13s}" for n in cols)
          + "  spread vs " + ", ".join(spread))
    flips = []
    for c, e in zip(*np.nonzero(np.any([flag[n] != flag["jax_bf16"] for n in cols], axis=0))):
        fault = cfg_mod.SWING_ERRORS[e]
        thr = float(thresholds[e])
        flipped = [n for n in cols if flag[n][c, e] != flag["jax_bf16"][c, e]]
        gap = {n: abs(float(p[n][c, e] - base[c, e])) for n in flipped}
        fl = {"clip": int(c), "fault": fault, "truth": bool(truth[c, e]), "threshold": thr,
              "flipped_in": flipped, "probs": {n: float(p[n][c, e]) for n in cols},
              "margin": {n: abs(float(p[n][c, e]) - thr) for n in cols},
              "clip_spread": {k: float(v[c]) for k, v in spread.items()},
              # Inside the bfloat16-to-float32 spread: every flipped run's
              # probability within that spread of jax_bf16's; inside the
              # JAX package's bfloat16 spread: within the larger of both.
              "inside_f32_spread": (all(g <= spread["jax_f32"][c] for g in gap.values())
                                    if "jax_f32" in spread else None),
              "inside_jax_spread": (all(g <= max(v[c] for v in spread.values())
                                        for g in gap.values()) if spread else None)}
        flips.append(fl)
        print(f"{c:4d} {fault:15s} {str(bool(truth[c, e])):5s} {thr:5.2f} "
              + " ".join(f"{p[n][c, e]:13.5f}" for n in cols)
              + "  " + ", ".join(f"{v[c]:.5f}" for v in spread.values()))
        print("     margin |p - thr|           "
              + " ".join(f"{abs(p[n][c, e] - thr):13.5f}" for n in cols)
              + f"  flipped in {', '.join(flipped)}; inside the f32 spread "
              f"{fl['inside_f32_spread']}, the JAX spread {fl['inside_jax_spread']}")
    f1 = {n: {k: v["f1"] for k, v in metrics.error_detection_per_fault(
        p[n], truth, thresholds).items()} for n in cols}
    shipped = {}
    path = os.path.join(ROOT, "artifacts", "demo", "e2e_metrics.json")
    if os.path.exists(path):
        with open(path) as f:
            shipped = {k: v["f1"] for k, v in
                       json.load(f)["error_detection_per_fault"].items()}
    print(f"\nper-fault F1   " + " ".join(f"{n:>13s}" for n in ["jax_tpu"] + cols))
    for fault in cfg_mod.SWING_ERRORS:
        print(f"{fault:16s}" + f"{shipped.get(fault, float('nan')):12.4f} "
              + " ".join(f"{f1[n][fault]:13.4f}" for n in cols))
    verdict = {"clips": len(truth), "against_jax_bf16": pairs, "flips": flips,
               "per_fault_f1": f1, "per_fault_f1_jax_tpu": shipped}
    for k in ("inside_f32_spread", "inside_jax_spread"):
        verdict[f"flips_{k}"] = sum(bool(fl[k]) for fl in flips)
    print(json.dumps({k: verdict[k] for k in ("clips", "flips_inside_f32_spread",
                                              "flips_inside_jax_spread")}
                     | {"flips": len(flips)}))
    return verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default=os.path.join(ROOT, "artifacts"))
    ap.add_argument("--per-fault", type=int, default=10)
    ap.add_argument("--clean", type=int, default=None,
                    help="fault-free clips (default: twice --per-fault)")
    ap.add_argument("--device", default="cpu", help="cuda adds the card's runs")
    ap.add_argument("--runs", default=None,
                    help="comma-separated runs to score (default: the four CPU "
                         "runs, and the card's with --device cuda)")
    ap.add_argument("--load", action="append", default=[],
                    help="a --save file of an earlier call to merge (repeatable)")
    ap.add_argument("--save", help="write the scored runs (JSON) here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch  # noqa: F401  (the port's runs)

    from golfaction_tpu_torch import checkpoint

    clean = 2 * args.per_fault if args.clean is None else args.clean
    if args.runs is not None:
        runs = [r for r in args.runs.split(",") if r]
    elif args.load:
        runs = []
    else:
        runs = list(RUNS[:4]) + (list(RUNS[4:]) if args.device == "cuda" else [])
    unknown = set(runs) - set(RUNS)
    if unknown:
        raise SystemExit(f"unknown runs {sorted(unknown)}; choose from {RUNS}")
    res = score(runs, args.artifacts, args.per_fault, clean) if runs else {}
    if args.save:
        with open(args.save, "w") as f:
            json.dump(res, f)
    for path in args.load:
        with open(path) as f:
            other = json.load(f)
        differ = merge(res, other)
        if differ:
            print(f"{path}: the rendered frames differ from this call's on clips {differ}")
    if "jax_bf16" not in res.get("probs", {}):
        print("no jax_bf16 run to compare with; scored runs saved only")
        return 0
    report(res, checkpoint.load_error_thresholds(args.artifacts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
