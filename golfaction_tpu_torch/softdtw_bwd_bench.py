"""First-call and step time of batched soft-DTW gradients: the port's
counterpart of the JAX package's `scripts/softdtw_bwd_bench.py`.

It times what that script computes: the gradient in `ea` and `eb` of
`softdtw_cost(pairwise_sqdist(ea, eb), gamma).sum()` over B pairs of
T-frame embedding sequences (B costs), at the alignment trainer's design
point, two ways:

  kernel  forward through kernel C, backward through kernel E
          (`ops/softdtw.softdtw_cost`): the JAX script's "pallas" key;
  plain   the plain versions on the same device (`softdtw_cost(...,
          plain=True)`: `wavefront_plain`, then `softdtw_backward_plain`):
          the JAX script's "scan" key.

`compile_s` is the first call, the nvcc build of the kernels included when
the build cache is cold; `step_s` the mean of `--iters` further calls, each
ended by a synchronize.  The plain path stops taking steps once its wall
time passes `--scan-timeout` and then says so (`timed_out`, the steps it
took and its seconds, a lower bound of what the full count would take); a
call already started runs to its end.  The JSON line also carries kernel
E's launch geometry at this shape (`ops/softdtw.backward_geometry`): from
T = 128 on, E takes its two-launch layout.

    python -m golfaction_tpu_torch.softdtw_bwd_bench --B 64 --T 128 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from golfaction_tpu_torch import checkpoint
from golfaction_tpu_torch.ops import softdtw
from golfaction_tpu_torch.pipeline.orchestrator import resolve_device


def inputs(B: int, T: int, dim: int, device) -> tuple:
    """ea, eb [B, T, dim] float32, normal draws of numpy seed 0 (the JAX
    script's)."""
    rng = np.random.default_rng(0)
    ea = torch.from_numpy(rng.normal(size=(B, T, dim)).astype(np.float32)).to(device)
    eb = torch.from_numpy(rng.normal(size=(B, T, dim)).astype(np.float32)).to(device)
    return ea, eb


def grad_fn(path: str, gamma: float):
    """(ea, eb) -> (d loss / d ea, d loss / d eb) of the loss through
    `path` ("kernel" or "plain")."""
    plain = path == "plain"

    def grad(ea, eb):
        ea = ea.detach().requires_grad_()
        eb = eb.detach().requires_grad_()
        loss = softdtw.softdtw_cost(softdtw.pairwise_sqdist(ea, eb), gamma, plain).sum()
        return torch.autograd.grad(loss, (ea, eb))

    return grad


def measure(path: str, ea, eb, gamma: float, iters: int, timeout: float = float("inf")) -> dict:
    """{"compile_s", "step_s"} of `path`; with "timed_out", "steps" and
    "seconds" when the wall time passed `timeout` before `iters` steps."""
    grad = grad_fn(path, gamma)

    def sync():
        if ea.device.type == "cuda":
            torch.cuda.synchronize(ea.device)

    sync()
    t0 = time.perf_counter()
    grad(ea, eb)
    sync()
    compile_s = time.perf_counter() - t0
    steps = []
    while len(steps) < iters and compile_s + sum(steps) <= timeout:
        t0 = time.perf_counter()
        grad(ea, eb)
        sync()
        steps.append(time.perf_counter() - t0)
    out = {"compile_s": round(compile_s, 4),
           "step_s": round(float(np.mean(steps)), 6) if steps else None}
    if len(steps) < iters:
        out.update(timed_out=True, steps=len(steps), seconds=round(compile_s + sum(steps), 3))
        print(f"{path}: stopped after {len(steps)} of {iters} steps, past the "
              f"{timeout:.0f} s bound", file=sys.stderr, flush=True)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--T", type=int, default=128)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--scan-timeout", type=float, default=600.0,
                    help="seconds after which the plain path takes no further step and "
                         "reports the steps it took")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.out:
        checkpoint.refuse_inside(args.out)
    device = resolve_device(args.device)
    ea, eb = inputs(args.B, args.T, args.dim, device)
    geo = softdtw.backward_geometry(args.B, args.T, args.T)
    out = {"B": args.B, "T": args.T, "dim": args.dim, "gamma": args.gamma,
           "iters": args.iters, "device": str(device),
           "backward_geometry": {"rows": geo.rows, "warps": geo.warps, "fits": geo.fits,
                                 "ring": geo.ring}}
    for path, timeout in (("kernel", float("inf")), ("plain", args.scan_timeout)):
        out[path] = measure(path, ea, eb, args.gamma, args.iters, timeout)
        r = out[path]
        step = "n/a" if r["step_s"] is None else f"{r['step_s'] * 1e3:.2f}ms"
        print(f"{path}: first call {r['compile_s']:.2f}s  step {step}", file=sys.stderr,
              flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
