"""What holds kernel A's bfloat16 variant back, on the card: timing-only
builds of its source, each with one part of its work taken out.

Each variant is the source with text replaced (wrong bits; for timing only,
never part of the port), built with the port's nvcc flags, all builds
started together.  For each: ptxas's registers and spills of the variant's
kernel, its SASS instruction count where the toolkit has `cuobjdump`, and
its milliseconds in a CUDA graph (golfaction_tpu_torch.bench.graph_ms) at
the main path's shape, [64, 1080, 1920, 3] -> [64, 256, 192, 3] with the
smoke's first clip and boxes (chip_smoke.py), timed in turns: this tree's
float32 kernel and a plain copy of the frames (the card's practical rate
for moving bytes), then the variants in order, then in reverse order.
Beside them the bytes of the 32-byte sectors the variant's taps touch, and
the least time for them at the data sheet's 3.35 TB/s and at the copy's
rate.

    python tools/kernel_a_breakdown.py --parent archive_check/parent

takes apart the other tree's variant (the design of a shared tile with
crop_resize_normalize_kernel: `sample_pixel_bf16`) and this tree's
(`pixel_bf16`); a design whose text a variant does not find is skipped with
a note.  Prints one JSON line; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "golfaction_tpu_torch/csrc/preprocess.cu"
KERNEL = "crop_resize_normalize_bf16_kernel"

# The design with a shared tile: per value two __fdiv_rn, three roundings
# (hat weights, both row values), twelve one-byte loads a pixel.
SHARED_TILE = {
    "divisions_as_multiplies": [(
        "__fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.0f), nm.mean[ch]), nm.stdv[ch])",
        "__fmul_rn(__fsub_rn(__fmul_rn(v, 255.0f), nm.mean[ch]), nm.stdv[ch])")],
    "no_roundings": [(
        "  return __bfloat162float(__float2bfloat16_rn(v));",
        "  return v;")],
    "three_loads": [(
        "    const float t0 = round_bf16(__fadd_rn(__fmul_rn(x.w0, "
        "byte_to_float(__ldg(f + off[0] + ch))),\n"
        "                                          __fmul_rn(x.w1, "
        "byte_to_float(__ldg(f + off[1] + ch)))));\n"
        "    const float t1 = round_bf16(__fadd_rn(__fmul_rn(x.w0, "
        "byte_to_float(__ldg(f + off[2] + ch))),\n"
        "                                          __fmul_rn(x.w1, "
        "byte_to_float(__ldg(f + off[3] + ch)))));",
        "    const unsigned b = __ldg(f + off[0] + ch);\n"
        "    const float t0 = round_bf16(__fadd_rn(__fmul_rn(x.w0, byte_to_float(b)),\n"
        "                                          __fmul_rn(x.w1, byte_to_float(b ^ 1u))));\n"
        "    const float t1 = round_bf16(__fadd_rn(__fmul_rn(x.w0, byte_to_float(b ^ 2u)),\n"
        "                                          __fmul_rn(x.w1, byte_to_float(b ^ 3u))));")],
}
SHARED_TILE["all_three"] = [p for v in SHARED_TILE.values() for p in v]

# The window design: divisions by reciprocal and one correction, two
# windows of two 8-byte loads a pixel, row taps from shared memory, 32
# registers.
WINDOWS = {
    "divisions_as_multiplies": [(
        "divide_guarded(__fsub_rn(divide(v, 255.0f, nm.r255), nm.mean[ch]), nm.stdv[ch],\n"
        "                       nm.rstd[ch])",
        "__fmul_rn(__fsub_rn(__fmul_rn(v, nm.r255), nm.mean[ch]), nm.rstd[ch])")],
    "one_window": [(
        "  load_window(base, y.off1 + x.off, last, lo1, hi1);",
        "  lo1 = lo0 ^ 0x01010101u;\n  hi1 = hi0 ^ 0x0101u;")],
    "registers_free": [(
        "__launch_bounds__(kThreads, 8) crop_resize_normalize_bf16_kernel",
        "__launch_bounds__(kThreads) crop_resize_normalize_bf16_kernel")],
    "no_byte_arithmetic": [(
        "    const float t0 = row_value(big(lo0, ch), ch == 0 ? big(lo0, 3) : big(hi0, ch - 1), x);\n"
        "    const float t1 = row_value(big(lo1, ch), ch == 0 ? big(lo1, 3) : big(hi1, ch - 1), x);",
        "    const float t0 = __uint_as_float(((lo0 ^ hi0) >> ch) & 0x3F7FFFFFu);\n"
        "    const float t1 = __uint_as_float(((lo1 ^ hi1) >> ch) & 0x3F7FFFFFu);")],
    "four_byte_loads": [
        ("const unsigned lead = (unsigned)(reinterpret_cast<uintptr_t>(f) & 7);",
         "const unsigned lead = (unsigned)(reinterpret_cast<uintptr_t>(f) & 3);"),
        ("const unsigned last = (lead + frame_bytes - 1) & ~7u;",
         "const unsigned last = (lead + frame_bytes - 1) & ~3u;"),
        ("  const unsigned w = j & ~7u;\n"
         "  const uint2 a = __ldg(reinterpret_cast<const uint2*>(base + w));\n"
         "  const uint2 b = __ldg(reinterpret_cast<const uint2*>(base + min(w + 8, last)));\n"
         "  const bool up = j & 4;   // the window starts in a's second half\n"
         "  const unsigned w0 = up ? a.y : a.x, w1 = up ? b.x : a.y, w2 = up ? b.y : b.x;\n",
         "  const unsigned w = j & ~3u;\n"
         "  const unsigned w0 = __ldg(reinterpret_cast<const unsigned*>(base + w));\n"
         "  const unsigned w1 = __ldg(reinterpret_cast<const unsigned*>(base + min(w + 4, last)));\n"
         "  const unsigned w2 = __ldg(reinterpret_cast<const unsigned*>(base + min(w + 8, last)));\n")],
    "l2_prefetch_256": [
        ("  const uint2 a = __ldg(reinterpret_cast<const uint2*>(base + w));\n"
         "  const uint2 b = __ldg(reinterpret_cast<const uint2*>(base + min(w + 8, last)));\n",
         "  uint2 a, b;\n"
         "  asm(\"ld.global.nc.L2::256B.v2.u32 {%0, %1}, [%2];\"\n"
         "      : \"=r\"(a.x), \"=r\"(a.y) : \"l\"(base + w));\n"
         "  asm(\"ld.global.nc.L2::256B.v2.u32 {%0, %1}, [%2];\"\n"
         "      : \"=r\"(b.x), \"=r\"(b.y) : \"l\"(base + min(w + 8, last)));\n")],
    "blocks_of_128": [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
        ("__launch_bounds__(kThreads, 8) crop_resize_normalize_bf16_kernel",
         "__launch_bounds__(kThreads, 16) crop_resize_normalize_bf16_kernel")],
    "rows_2": [("constexpr int kRows = 4;", "constexpr int kRows = 2;")],
    "rows_8": [("constexpr int kRows = 4;", "constexpr int kRows = 8;")],
}
WINDOWS["loads_only"] = WINDOWS["no_byte_arithmetic"] + WINDOWS["divisions_as_multiplies"]
DESIGNS = (("shared_tile", SHARED_TILE, 6), ("windows", WINDOWS, 10))


def sector_bytes(boxes, H: int, W: int, oh: int, ow: int) -> int:
    """Bytes of the 32-byte sectors of the frames that the variant's windows
    touch: each tap row (clamped into the frame) times the sectors of the
    columns' windows [3s, 3s + 5] in it."""
    import numpy as np

    from golfaction_tpu_torch.ops import preprocess

    b = boxes.detach().cpu().float()
    cx = preprocess._sample_coords(b, ow, axis=0).numpy()
    cy = preprocess._sample_coords(b, oh, axis=1).numpy()
    total = 0
    for f in range(len(b)):
        i = np.clip(np.floor(cx[f]), -2, W).astype(np.int64)
        s = np.minimum(np.maximum(i, 0), max(W - 2, 0))
        y = np.clip(np.floor(cy[f]), -2, H).astype(np.int64)
        rows = np.unique(np.concatenate([np.where((y >= 0) & (y < H), y, 0),
                                         np.where((y + 1 >= 0) & (y + 1 < H), y + 1, 0)]))
        base = (f * H + rows)[:, None] * 3 * W
        first, last = (base + 3 * s) // 32, (base + 3 * s + 5) // 32
        total += 32 * len(np.unique(np.concatenate([first.ravel(), last.ravel()])))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the other tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    import chip_smoke
    from golfaction_tpu_torch.bench import graph_ms
    from golfaction_tpu_torch.ops import _kernels, affine, preprocess
    from kernel_a_compare import bind, build, sass

    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp()
    jobs, notes = {}, []
    for tree, root in (("other", args.parent), ("this", ROOT)):
        text = open(os.path.join(root, SRC)).read()
        design = next(((n, v, f) for n, v, f in DESIGNS
                       if all(o in text for o, _ in next(iter(v.values())))), None)
        if design is None:
            notes.append(f"{tree}: no known design of the variant")
            continue
        dname, variants, floats = design
        for vname, patches in (("as_is", []), *variants.items()):
            src, missing = text, [o for o, _ in patches if o not in text]
            if missing:
                notes.append(f"{tree} {vname}: text not found")
                continue
            for o, n in patches:
                src = src.replace(o, n)
            path = os.path.join(tmp, f"{tree}_{vname}.cu")
            with open(path, "w") as fh:
                fh.write(src)
            jobs[(tree, dname, vname, floats)] = path
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda k: build(jobs[k], tmp, f"{k[0]}_{k[2]}"),
                                        jobs)))

    # The smoke's first clip at the main path's shape.
    kp = chip_smoke.swing_keypoints(chip_smoke.CLIP_T, np.random.default_rng(0))
    frames = torch.from_numpy(chip_smoke.render_clip(kp, seed=0)).to(dev)
    oh, ow = 256, 192
    boxes = affine.box_to_center_scale(torch.from_numpy(chip_smoke.boxes_of(kp)).to(dev),
                                       ow / oh).contiguous()
    B, H, W, _ = frames.shape
    mean, std = preprocess.IMAGENET_MEAN, preprocess.IMAGENET_STD
    recips = preprocess.division_reciprocals(mean, std)
    out = torch.empty((B, oh, ow, 3), dtype=torch.bfloat16, device=dev)
    copy = torch.empty_like(frames)
    runs = {"f32": lambda: preprocess.crop_resize_normalize(frames, boxes, (oh, ow)),
            "copy": lambda: copy.copy_(frames)}
    rows = {}
    for key, (lib, log) in built.items():
        tree, dname, vname, floats = key
        fn = bind(lib, "crop_resize_normalize_bf16_launch", floats)
        norm = (*mean, *std) + (recips if floats == 10 else ())

        def run(fn=fn, norm=norm, name=f"{tree} {vname}"):
            rc = fn(frames.data_ptr(), boxes.data_ptr(), out.data_ptr(), B, H, W, oh, ow, *norm,
                    torch.cuda.current_stream().cuda_stream)
            _kernels.check(rc, name)

        name = f"{tree}:{dname}:{vname}"
        runs[name] = run
        ptx = next((r for r in _kernels.ptxas_rows(log) if r["kernel"] == KERNEL), {})
        code = sass(os.path.join(tmp, f"lib{tree}_{vname}.so"), KERNEL)
        rows[name] = {"registers": ptx.get("registers"), "spill_bytes": ptx.get("spill_bytes"),
                      "sass_instructions": None if code is None
                      else len([i for i in code if not i.startswith("NOP")])}
    order = list(runs)
    times = {k: [] for k in order}
    for turn in (order, order[::-1]):
        for k in turn:
            times[k].append(graph_ms(runs[k]))
    for k in rows:
        rows[k]["graph_ms"] = times[k]
    shutil.rmtree(tmp, ignore_errors=True)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    # The bytes the variant must move at DRAM's 32-byte sectors, over the
    # data sheet's rate and over the rate of a plain copy of the frames.
    moved = sector_bytes(boxes, H, W, oh, ow) + out.numel() * 2 + boxes.numel() * 4
    copy_rate = 2 * frames.numel() / (min(times["copy"]) * 1e-3)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": power,
                      "shape": [B, H, W, 3], "out": [B, oh, ow, 3],
                      "f32_graph_ms": times["f32"], "copy_graph_ms": times["copy"],
                      "copy_bytes_per_s": copy_rate, "sector_bytes": moved,
                      "sector_floor_ms": moved / 3.35e12 * 1e3,
                      "at_copy_rate_ms": moved / copy_rate * 1e3,
                      "variants": rows, "notes": notes}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
