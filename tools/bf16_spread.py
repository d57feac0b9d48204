"""How far apart bfloat16 programs of the shipped pose model land, on the CPU.

One clip of 16 frames (270x480, the seed of tests/test_torch_e2e_score.py)
through the shipped model from artifacts/ in the JAX package and in the
PyTorch port, and the share of (frame, joint) keypoints within 0.5 px and
the median gap for every pair of:

  * jax_bf16: the JAX package's program at the shipped dtype (gcn float32,
    the program its TPU path runs), compiled as it compiles by default
    (XLA may keep values wider than bfloat16 inside fusions);
  * jax_bf16_kept: the same program compiled with every bfloat16 rounding
    kept (xla_allow_excess_precision off);
  * jax_f32, port_f32: both packages at float32;
  * port_bf16: the port at the shipped dtype;
  * port_bf16_nchw: the same with contiguous NCHW inputs to the
    convolutions, so that oneDNN sums in another order.

    python tools/bf16_spread.py [--artifacts artifacts]

Needs JAX and the JAX package (it compares the two); several minutes.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, HW = 16, (270, 480)
F32 = ["pose.dtype='float32'", "gcn.dtype='float32'", "align.dtype='float32'",
       "error.dtype='float32'", "refine.dtype='float32'"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", default=os.path.join(ROOT, "artifacts"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from golfaction_tpu import config as jcfg
    from golfaction_tpu.pipeline import orchestrator as jorch
    from golfaction_tpu.pipeline import video_io as jvideo
    from golfaction_tpu.train import checkpoint as jckpt
    from golfaction_tpu.train import data as jdata
    from golfaction_tpu_torch.models import pose as tpose
    from golfaction_tpu_torch.pipeline import orchestrator as torch_orch

    s = jdata.make_swing_batch(1, T, seed=995_000, image_hw=HW, render=True, fault_prob=0.0)[0]
    boxes = jvideo.estimate_person_boxes(s.frames, use_native=False)
    sets = [f"video_hw={HW}", f"length_buckets=({T},)"]
    frames, boxes, valid = jvideo.pad_to_bucket(s.frames, boxes, (T,))
    kp = {}
    for name, extra in (("jax_bf16", ["gcn.dtype='float32'"]), ("jax_f32", F32)):
        cfg = jckpt.config_for_artifacts(
            jcfg.apply_overrides(jcfg.get_config("full_pipeline"), sets + extra), args.artifacts)
        jp = jorch.Pipeline(cfg, seed=0)
        jp.params = jckpt.load_pipeline_params(args.artifacts, like=jp.params)
        call = (jp.params, jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(valid))
        kp[name] = np.asarray(jp._core(*call)["keypoints"])
        if name == "jax_bf16":
            kept = jp._core.lower(*call).compile(
                compiler_options={"xla_allow_excess_precision": False})
            kp["jax_bf16_kept"] = np.asarray(kept(*call)["keypoints"])
    inputs = [torch.from_numpy(np.array(a))[None] for a in (frames, boxes, valid)]
    for name, extra in (("port_bf16", []), ("port_f32", F32)):
        tp = torch_orch.Pipeline.from_artifacts(args.artifacts, device="cpu",
                                                overrides=sets + extra)
        with torch.no_grad():
            kp[name] = tp._core_fn(*inputs)["keypoints"][0].numpy()
            if name == "port_bf16":
                forward = tpose.SameConv2d.forward
                tpose.SameConv2d.forward = lambda self, x: forward(self, x.contiguous())
                try:
                    kp["port_bf16_nchw"] = tp._core_fn(*inputs)["keypoints"][0].numpy()
                finally:
                    tpose.SameConv2d.forward = forward
    names = list(kp)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            gap = np.linalg.norm(kp[a][..., :2] - kp[b][..., :2], axis=-1)
            print(f"{a:15s} vs {b:15s} share within 0.5 px {np.mean(gap <= 0.5):.4f}  "
                  f"median {np.median(gap):.4f} px  max {gap.max():.2f} px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
