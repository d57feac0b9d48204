"""How far the JAX package's jitted pipeline at preprocess_dtype="bfloat16"
lands from the same pipeline run as written, and where the port lands, on
the CPU.

The golden fixture's widths (tests/golden/common.py) in float32 with the
port's seed-0 random parameters carried into JAX (`weights.to_flax`), at
pose.in_frames 1 and 3, the fixture's first clip with its numpy motion
boxes.  For each, the largest keypoint gap (image px) of the pose stage
(`_pose_fn`) between:

  * jit: the JAX package's `_pose_fn` jitted, as `analyze` runs it (XLA
    computes the crops' sample coordinates with reciprocal multiplies and
    fused multiply-adds);
  * as_written: the same function op by op (`jax.disable_jit`), every
    operation rounded as the source states it;
  * port: the port's `_pose_fn` on the CPU;

and the share of bfloat16 crop values on which the jitted crop
(`crop_resize_normalize(..., dtype=bfloat16)` under jit) differs from the
as-written one at the pipeline's boxes, and the largest gap of the same two
at float32.

    python tools/bf16_crop_spread.py

Needs JAX and the JAX package (it compares the two); about half a minute.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from golfaction_tpu.ops import affine as jaffine
    from golfaction_tpu.ops import preprocess as jpre
    from golfaction_tpu.pipeline import orchestrator as jorch
    from golfaction_tpu.pipeline import video_io as jvideo
    from golfaction_tpu_torch import weights
    from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
    from tests.golden.common import GOLDEN_CFG, fixture_clips
    from tests.torch_parity import port_config

    clip = fixture_clips()[0]
    out = {}
    for nf in (1, 3):
        jcfg = dataclasses.replace(GOLDEN_CFG, preprocess_dtype="bfloat16",
                                   pose=dataclasses.replace(GOLDEN_CFG.pose, in_frames=nf))
        tc = port_config(jcfg)
        sd = torch_orch.init_params(tc, seed=0)
        tpipe = torch_orch.Pipeline(tc, sd, device="cpu")
        jpipe = jorch.Pipeline(jcfg, params=weights.to_flax(sd))
        frames, boxes, _ = jpipe._prepare(clip, jvideo.estimate_person_boxes(clip,
                                                                            use_native=False))
        f, b = jnp.asarray(frames), jnp.asarray(boxes)
        jit = np.asarray(jpipe._pose_only(jpipe.params, f, b))
        with jax.disable_jit():
            written = np.asarray(jpipe._pose_fn(jpipe.params, f, b))
        with torch.inference_mode():
            port = tpipe._pose_fn(torch.from_numpy(frames)[None],
                                  torch.from_numpy(np.asarray(boxes))[None])[0][0].numpy()
        cs = jaffine.box_to_center_scale(b, jcfg.pose.input_hw[1] / jcfg.pose.input_hw[0])

        def crop(x, y, dtype=jnp.bfloat16):
            return jpre.crop_resize_normalize(x, y, jcfg.pose.input_hw,
                                              dtype=dtype).astype(jnp.float32)

        crops_jit = np.asarray(jax.jit(crop)(f, cs))
        crops_written = np.asarray(crop(f, cs))
        f32_jit = np.asarray(jax.jit(crop, static_argnums=2)(f, cs, jnp.float32))
        f32_written = np.asarray(crop(f, cs, jnp.float32))
        out[f"in_frames_{nf}"] = {
            "kpt_max_px": {"jit_vs_as_written": float(np.abs(jit - written).max()),
                           "port_vs_as_written": float(np.abs(port - written).max()),
                           "port_vs_jit": float(np.abs(port - jit).max())},
            "crop_values_that_differ_jit_vs_as_written": float(
                (crops_jit != crops_written).mean()),
            "float32_crop_max_gap_jit_vs_as_written": float(
                np.abs(f32_jit - f32_written).max())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
