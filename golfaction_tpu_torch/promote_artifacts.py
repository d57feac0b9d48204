"""Promote a staged artifacts tree into a destination tree: the port's
counterpart of the JAX package's `scripts/promote_artifacts.py`.

Used at the end of a retraining chain (train_eval -> probes -> cascade ->
calibrate -> demo_e2e on a staging folder): gates on the staged
`demo/e2e_metrics.json` (`--gate fault=minF1 ...`, `overall` the pooled
error F1; a miss exits 1 unless `--force`), then copies the staged `demo/`
folder, writes each staged `params/<name>.npz` to the destination as a
float16 npz (the committed form), and copies `pose_meta.json`,
`error_thresholds.json` and the three `probe_*.json`.

The port reads and writes npz only.  A staged tree that holds an Orbax step
folder (`params/<name>/step_*`) is refused, as is a destination that holds
one: the JAX package would load such a folder in preference to the promoted
npz, and where the JAX script deletes it, the port names it and leaves the
decision to the user.  Both checks, and the gate, come before anything is
written; `demo/` is copied (merged into the destination's) before any file
of the destination is overwritten.  The destination `--artifacts` has no
default.

    python -m golfaction_tpu_torch.promote_artifacts --staged <dir> --artifacts <dest>
        --gate chicken_wing=0.7 casting=0.8 overall=0.85
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from golfaction_tpu_torch import checkpoint

SIDECARS = ("pose_meta.json", "error_thresholds.json", "probe_arm_gain.json",
            "probe_heatmap_modes.json", "probe_heatmap_spread.json")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--staged", required=True)
    ap.add_argument("--artifacts", required=True, help="the destination tree")
    ap.add_argument("--models", nargs="*", default=["pose", "gcn", "error", "align"])
    ap.add_argument("--gate", nargs="*", default=[],
                    help="fault=minF1 pairs checked against the staged "
                         "demo/e2e_metrics.json per-fault table; 'overall' checks the "
                         "pooled error F1")
    ap.add_argument("--force", action="store_true",
                    help="promote even if a gate fails (prints the misses)")
    return ap.parse_args(argv)


def gate_misses(staged: str, gates, log=_log) -> list:
    """[(name, F1, threshold)] of every gate the staged e2e metrics miss."""
    if not gates:
        return []
    with open(os.path.join(staged, "demo", "e2e_metrics.json")) as f:
        m = json.load(f)
    per_fault = m.get("error_detection_per_fault", {})
    misses = []
    for spec in gates:
        name, thr = spec.split("=")
        thr = float(thr)
        if name == "overall":
            got = float(m.get("error_detection", {}).get("f1", 0.0))
        else:
            got = float(per_fault.get(name, {}).get("f1", 0.0))
        log(f"gate {name}: {got:.3f} >= {thr:.2f} ... {'ok' if got >= thr else 'MISS'}")
        if got < thr:
            misses.append((name, got, thr))
    return misses


def main(argv=None) -> dict:
    """Gate, then promote; prints the JAX script's last line and returns it.
    Exits 1 on a gate miss without --force."""
    args = parse_args(argv)
    staged, art = args.staged, args.artifacts
    if checkpoint._inside(art, staged) or checkpoint._inside(staged, art):
        raise ValueError(f"--staged {staged} and --artifacts {art} overlap")
    checkpoint.refuse_step_dirs(staged)
    if os.path.isdir(art):
        checkpoint.refuse_step_dirs(art)

    misses = gate_misses(staged, args.gate)
    if misses and not args.force:
        _log("gate failed; not promoting (use --force to override)")
        sys.exit(1)

    demo_src = os.path.join(staged, "demo")
    if os.path.isdir(demo_src):
        shutil.copytree(demo_src, os.path.join(art, "demo"), dirs_exist_ok=True)
        _log("copied demo artifacts")
    os.makedirs(os.path.join(art, "params"), exist_ok=True)
    promoted = []
    for name in args.models:
        src = os.path.join(staged, "params", f"{name}.npz")
        if not os.path.exists(src):
            _log(f"{name}: nothing staged, keeping current")
            continue
        dst = os.path.join(art, "params", f"{name}.npz")
        checkpoint.save_params_npz(dst, checkpoint.restore_params_npz(src, cast=None))
        promoted.append(name)
        _log(f"{name}: {src} -> {dst} (float16)")
    for fname in SIDECARS:
        src = os.path.join(staged, fname)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(art, fname))
            _log(f"copied {fname}")
    line = {"promoted": args.models, "gate_misses": [list(x) for x in misses]}
    print(json.dumps(line))
    return {**line, "written": promoted}


if __name__ == "__main__":
    main()
