"""Kernel A of this tree against kernel A of another tree, on the card.

Builds `<parent>/golfaction_tpu_torch/csrc/preprocess.cu` (for example an
earlier commit unpacked with `git archive`) with this tree's nvcc flags,
then, at the main path's shape and at small and odd ones (seeded frames and
boxes, some boxes partly outside the frame):

  * whether this tree's float32 crops equal the other tree's to the bit;
  * whether this tree's bfloat16 variant equals its plain version to the bit;
  * the float32 kernel of both trees and the bfloat16 variant, in a CUDA
    graph, in turns (other, this, bfloat16, other again).

    python tools/kernel_a_compare.py --parent archive_check/parent

Prints one JSON line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((64, 1080, 1920, 256, 192), (3, 120, 160, 64, 48), (2, 90, 130, 33, 31),
          (1, 64, 64, 17, 5), (5, 200, 300, 40, 36))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from golfaction_tpu_torch.bench import graph_ms
    from golfaction_tpu_torch.ops import _kernels, preprocess

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "libpreprocess_parent.so")
        subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
                        os.path.join(args.parent, "golfaction_tpu_torch/csrc/preprocess.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)          # stays mapped once the file is gone
    other = lib.crop_resize_normalize_launch
    other.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float] * 6 + [
        ctypes.c_void_p]
    norm = (*preprocess.IMAGENET_MEAN, *preprocess.IMAGENET_STD)
    out = {}
    for b, h, w, oh, ow in SHAPES:
        rng = np.random.default_rng(b)
        frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)
        boxes = torch.from_numpy(np.stack(
            [rng.uniform(-0.1 * w, 1.1 * w, b), rng.uniform(-0.1 * h, 1.1 * h, b),
             rng.uniform(0.1 * w, 0.8 * w, b), rng.uniform(0.2 * h, 1.2 * h, b)],
            axis=-1).astype(np.float32)).to(dev)
        ref = torch.empty((b, oh, ow, 3), dtype=torch.float32, device=dev)

        def run_other():
            rc = other(frames.data_ptr(), boxes.data_ptr(), ref.data_ptr(), b, h, w, oh, ow,
                       *norm, torch.cuda.current_stream().cuda_stream)
            _kernels.check(rc, "the other tree's kernel A")

        def run_f32():
            return preprocess.crop_resize_normalize(frames, boxes, (oh, ow))

        def run_bf16():
            return preprocess.crop_resize_normalize(frames, boxes, (oh, ow), dtype=torch.bfloat16)

        run_other()
        got = run_f32()
        bf = run_bf16()
        plain = preprocess.crop_resize_normalize_bf16_reference(frames, boxes, (oh, ow))
        torch.cuda.synchronize()
        out[f"{b}x{h}x{w}->{oh}x{ow}"] = {
            "float32_equal_to_other": bool(torch.equal(got, ref)),
            "bf16_equal_to_plain": bool(torch.equal(bf, plain)),
            "graph_ms": {"other_f32": graph_ms(run_other), "f32": graph_ms(run_f32),
                         "bf16": graph_ms(run_bf16), "other_f32_again": graph_ms(run_other)}}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shapes": out}))
    return 0 if all(v["float32_equal_to_other"] and v["bf16_equal_to_plain"]
                    for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
