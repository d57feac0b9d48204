"""How far apart float32 programs of the multi-device dry run's tiny config
land, on the CPU.

The config and the six clips of tests/test_torch_parallel.py (the JAX dry
run's: 5-7 frames of 96x128, tracked decode, mode features, refiner on)
through the JAX package's jitted analyze_batch with a reference, the same
clips through its analyze op by op (jax.disable_jit), and through the port's
analyze_batch.  For each clip it prints the largest keypoint x/y gap in px
and the relative cost gap of:

  * port: the port against the jitted JAX run;
  * jax_eager: the JAX op-by-op run against the jitted one; its cost is the
    port's alignment (equal to JAX's at float32) of the op-by-op keypoints
    against that of the jitted keypoints.

    python tools/f32_spread.py

Needs JAX and the JAX package (it compares the two); about four minutes.
"""

from __future__ import annotations

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

    from golfaction_tpu import types as jtypes
    from golfaction_tpu.pipeline import orchestrator as jorch
    from golfaction_tpu_torch import types as ttypes
    from golfaction_tpu_torch.pipeline import orchestrator as torch_orch
    from golfaction_tpu_torch.pipeline import video_io as tvideo
    from tests.test_torch_parallel import J_PIPE
    from tests.torch_parity import port_config, port_params

    jpipe = jorch.Pipeline(J_PIPE, seed=0)
    tpipe = torch_orch.Pipeline(port_config(J_PIPE), port_params(jpipe.params), device="cpu")
    rng = np.random.default_rng(0)
    clips = [rng.integers(0, 255, (5 + i % 3, 96, 128, 3)).astype(np.uint8) for i in range(6)]
    boxes = [tvideo.estimate_person_boxes(c, use_native=False) for c in clips]
    ref_k = tpipe.analyze(clips[0], boxes=boxes[0]).keypoints.numpy().copy()
    ref_k[..., :2] += np.random.default_rng(7).normal(0, 2.0, ref_k[..., :2].shape).astype(
        np.float32)
    ref_v = np.ones(ref_k.shape[0], bool)
    jit = jpipe.analyze_batch(clips, boxes=boxes, reference=jtypes.Skeleton(
        keypoints=jnp.asarray(ref_k), valid=jnp.asarray(ref_v)))
    port = tpipe.analyze_batch(clips, boxes=boxes, reference=ttypes.Skeleton(
        keypoints=torch.from_numpy(ref_k), valid=torch.from_numpy(ref_v)))
    ref_t, ref_vt = torch.from_numpy(ref_k), torch.from_numpy(ref_v)

    def cost(kpts, res):
        """The port's alignment of keypoints `kpts` of result `res`."""
        with torch.inference_mode():
            a = tpipe._align_refine_fn(torch.from_numpy(np.array(kpts, np.float32)),
                                       torch.from_numpy(np.array(res.valid)), ref_t, ref_vt,
                                       torch.from_numpy(np.array(res.phase_logits)))
        return float(a["cost"])

    rows = []
    for i, (c, b) in enumerate(zip(clips, boxes)):
        with jax.disable_jit():
            eager = jpipe.analyze(c, boxes=b)
        kj = np.asarray(jit[i].keypoints)
        cj = float(jit[i].alignment.cost)
        rows.append({
            "clip": i,
            "port_px": float(np.abs(port[i].keypoints.numpy()[..., :2] - kj[..., :2]).max()),
            "port_cost_rel": abs(float(port[i].alignment.cost) / cj - 1),
            "jax_eager_px": float(np.abs(np.asarray(eager.keypoints)[..., :2]
                                         - kj[..., :2]).max()),
            "jax_eager_cost_rel": abs(cost(eager.keypoints, jit[i]) / cost(kj, jit[i]) - 1)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({k: max(r[k] for r in rows) for k in rows[0] if k != "clip"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
