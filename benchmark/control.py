"""The check's two readings, on the card at a cell's own size:

    python3 -m benchmark.control --workload <name> --program-seeds a,b,... \
        --control-seeds x,y,z [--seconds 4]

For each program seed, a run of the system as `benchmark.run` makes it (a
short window at the cell's load) and the check's numbers of as many of its
requests as a run checks: the lower readings.  For each control seed, the
plain reference at the precision one step below the configuration's
(float8 for bfloat16, TF32 for float32; reference.nets.Numerics) put in
the system's place on the same traffic, and the same numbers: the upper
readings.  One JSON line a seed, then one of the worst program reading and
the least control reading of each number.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import check
from benchmark import run as bench


def program_numbers(conf, traffic, seed, seconds, device) -> dict:
    s = bench.Session(conf, traffic, seed, device)
    s.warm_up()
    s.measure(seconds, False)
    return s.judge([(d.item, d.out) for d in s.picked()])


def control_numbers(conf, traffic, seed, device) -> dict:
    import torch

    from benchmark import traffic as gen
    from benchmark.reference.pipeline import Reference

    s = bench.Session(conf, traffic, seed, device, program=False)
    low = Reference(conf, s.state, s.dev, lowp=True)
    rs = s.ref_swing
    with torch.inference_mode():
        kp, aux = low.pose(rs["frames"], rs["boxes"])
        ref_swing = dict(rs, keypoints=kp, kpt_aux=aux)
        ref = (kp[0], rs["valid"][0])
        order = gen.request_order(s.plan.items, seed)
        outputs = []
        for _ in range(traffic["check_requests"]):
            item = next(order)
            frames, boxes, valid = s.run.inputs(item)
            outputs.append((item, check.control_request(low, frames, boxes, valid, ref,
                                                        s.thresholds)))
    del low
    return s.judge(outputs, ref_swing)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda:0")
    a = p.parse_args(argv)
    _, conf, traffic = bench.cell(bench.load_spec(), a.workload)
    if a.device.startswith("cuda"):
        from golfaction_tpu_torch.ops import _kernels
        _kernels.build_all()
    lower, upper = {}, {}
    for side, seeds in (("program", a.program_seeds), ("control", a.control_seeds)):
        for seed in [int(x) for x in seeds.split(",") if x]:
            t = time.perf_counter()
            nums = (program_numbers(conf, traffic, seed, a.seconds, a.device) if side == "program"
                    else control_numbers(conf, traffic, seed, a.device))
            print(json.dumps({"side": side, "seed": seed, "seconds": time.perf_counter() - t,
                              "numbers": nums}), flush=True)
            into = lower if side == "program" else upper
            for k, v in nums.items():
                into[k] = max(into.get(k, v), v) if side == "program" else min(into.get(k, v), v)
    print(json.dumps({"workload": a.workload, "program_worst": lower, "control_least": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
