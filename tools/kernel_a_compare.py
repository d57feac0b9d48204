"""Kernel A of this tree against kernel A of another tree, on the card.

Builds `<parent>/golfaction_tpu_torch/csrc/preprocess.cu` (for example an
earlier commit unpacked with `git archive`) with this tree's nvcc flags,
then, at the main path's shape and at small and odd ones (seeded frames and
boxes, some boxes partly outside the frame), and with the smoke's 20 odd
boxes (chip_smoke.ODD_BOXES) on 120x160 frames:

  * whether this tree's float32 crops equal the other tree's to the bit, and
    whether its float32 kernel's machine code (`cuobjdump -sass`) is the
    other tree's, instruction for instruction;
  * whether this tree's bfloat16 variant equals its plain version and the
    other tree's variant to the bit;
  * the float32 kernel and the bfloat16 variant of both trees, in a CUDA
    graph, in turns (other float32, this float32, other bfloat16, this
    bfloat16, other float32 again), each launched through its tree's C
    entry point into one output tensor allocated beforehand.

    python tools/kernel_a_compare.py --parent archive_check/parent

The other tree's launch functions take the normalization as
(mean[3], std[3]) for both kernels.  Prints one JSON line; needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((64, 1080, 1920, 256, 192), (3, 120, 160, 64, 48), (2, 90, 130, 33, 31),
          (1, 64, 64, 17, 5), (5, 200, 300, 40, 36))
ODD_SHAPES = ((120, 160, 64, 48), (120, 160, 33, 31))


def build(source: str, out_dir: str, stem: str) -> tuple[ctypes.CDLL, str]:
    """`source` compiled with the port's nvcc flags into out_dir/lib<stem>.so;
    the library (it stays mapped once the file is gone) and ptxas's log."""
    from golfaction_tpu_torch.ops import _kernels

    so = os.path.join(out_dir, f"lib{stem}.so")
    proc = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so), proc.stdout + proc.stderr


def sass(so: str, kernel: str) -> list[str] | None:
    """The SASS instructions of `kernel` in a library (`cuobjdump -sass`),
    None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    for part in text.split("Function : ")[1:]:
        if kernel in part.split("\n", 1)[0]:
            return [m.group(1).strip() for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+([^;]*;)", part)]
    return []


def bind(lib: ctypes.CDLL, symbol: str, floats: int):
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] * floats
                   + [ctypes.c_void_p])
    return fn


def inputs(b: int, h: int, w: int, seed: int, dev, boxes=None):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
    if boxes is None:
        boxes = np.stack([rng.uniform(-0.1 * w, 1.1 * w, b), rng.uniform(-0.1 * h, 1.1 * h, b),
                          rng.uniform(0.1 * w, 0.8 * w, b), rng.uniform(0.2 * h, 1.2 * h, b)],
                         axis=-1)
    return frames, torch.as_tensor(np.asarray(boxes, np.float32)).to(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from golfaction_tpu_torch.bench import graph_ms
    from golfaction_tpu_torch.ops import _kernels, preprocess

    dev = torch.device("cuda")
    f32_kernel = "crop_resize_normalize_kernel"
    with tempfile.TemporaryDirectory() as tmp:
        lib, _ = build(os.path.join(args.parent, "golfaction_tpu_torch/csrc/preprocess.cu"),
                       tmp, "preprocess_parent")
        other_sass = sass(os.path.join(tmp, "libpreprocess_parent.so"), f32_kernel)
    _kernels.build_all(("preprocess",))
    this_sass = sass(str(_kernels._lib_path("preprocess")), f32_kernel)
    other = {torch.float32: bind(lib, "crop_resize_normalize_launch", 6),
             torch.bfloat16: bind(lib, "crop_resize_normalize_bf16_launch", 6)}
    norm = (*preprocess.IMAGENET_MEAN, *preprocess.IMAGENET_STD)
    this_norm = {torch.float32: norm,
                 torch.bfloat16: (*norm, *preprocess.division_reciprocals(
                     preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD))}
    this = {dt: _kernels.bind("preprocess", sym, "pppiiiii" + "f" * len(this_norm[dt]) + "p")
            for dt, sym in ((torch.float32, "crop_resize_normalize_launch"),
                            (torch.bfloat16, "crop_resize_normalize_bf16_launch"))}
    cases = [(f"{b}x{h}x{w}->{oh}x{ow}", b, h, w, oh, ow, None) for b, h, w, oh, ow in SHAPES]
    cases += [(f"odd_boxes {len(chip_smoke.ODD_BOXES)}x{h}x{w}->{oh}x{ow}",
               len(chip_smoke.ODD_BOXES), h, w, oh, ow, chip_smoke.ODD_BOXES)
              for h, w, oh, ow in ODD_SHAPES]
    out = {}
    for name, b, h, w, oh, ow, odd in cases:
        frames, boxes = inputs(b, h, w, b, dev, odd)
        ref = {dt: torch.empty((b, oh, ow, 3), dtype=dt, device=dev) for dt in other}
        mine = {dt: torch.empty((b, oh, ow, 3), dtype=dt, device=dev) for dt in other}

        def launcher(fn, dst, nm, what):
            def run():
                rc = fn(frames.data_ptr(), boxes.data_ptr(), dst.data_ptr(), b, h, w, oh, ow,
                        *nm, torch.cuda.current_stream().cuda_stream)
                _kernels.check(rc, what)
            return run

        def run_other(dt):
            return launcher(other[dt], ref[dt], norm, f"the other tree's kernel A ({dt})")

        def run_this(dt):
            return launcher(this[dt], mine[dt], this_norm[dt], f"kernel A ({dt})")

        for dt in other:
            run_other(dt)()
        got = {dt: preprocess.crop_resize_normalize(frames, boxes, (oh, ow), dtype=dt)
               for dt in other}
        plain = preprocess.crop_resize_normalize_bf16_reference(frames, boxes, (oh, ow))
        torch.cuda.synchronize()
        out[name] = {
            "float32_equal_to_other": bool(torch.equal(got[torch.float32], ref[torch.float32])),
            "bf16_equal_to_plain": bool(torch.equal(got[torch.bfloat16], plain)),
            "bf16_equal_to_other": bool(torch.equal(got[torch.bfloat16], ref[torch.bfloat16])),
            "graph_ms": {"other_f32": graph_ms(run_other(torch.float32)),
                         "f32": graph_ms(run_this(torch.float32)),
                         "other_bf16": graph_ms(run_other(torch.bfloat16)),
                         "bf16": graph_ms(run_this(torch.bfloat16)),
                         "other_f32_again": graph_ms(run_other(torch.float32))}}
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": power,
                      "float32_sass_instructions": len(this_sass) if this_sass else None,
                      "float32_sass_equal_to_other": None if this_sass is None
                      else bool(this_sass) and this_sass == other_sass,
                      "shapes": out}))
    return 0 if all(v[k] for v in out.values() for k in v if k.endswith(("other", "plain"))) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
