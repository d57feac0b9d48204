"""The system under test, as the benchmark drives it: golfaction_tpu_torch's
`Pipeline` and its per-chunk device program (`_pose_fn`, `_heads_fn`, then
`_align_batch_fn` against a reference swing), which `analyze_batch` runs on
each chunk of clips once they are on the card.

Each call into a layer runs inside a span of the benchmark's own
("bench.pose", "bench.heads", "bench.align"; benchmark.trace.Spans), so
that a traced run can give each layer its device time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from benchmark.reference import nets, pose_reference
from benchmark.reference import weights as ref_weights
from benchmark.trace import Spans

NO_SPANS = Spans()


def _plain(v):
    """A config value as JSON has it (tuples -> lists)."""
    return json.loads(json.dumps(v))


def build(conf: dict, seed: int, device, root: str, program: bool = True):
    """The configured Pipeline and the state dicts both sides load.

    conf["weights"]: "artifacts" loads `<root>/<conf["artifacts"]>` through
    `Pipeline.from_artifacts` (the system converts the npz files itself; the
    benchmark converts them again for the reference), "seed" draws random
    weights on the device from `seed` and hands them to `Pipeline(cfg,
    params=...)`; the pose net's are drawn for the net that conf's pose
    reference module builds.  Raises when the system's config differs from
    conf["pipeline"], the configuration as stated (check_config).  With
    `program` False only the state dicts are made (the Pipeline is None)."""
    from golfaction_tpu_torch.config import apply_overrides, get_config
    from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

    stated = conf["pipeline"]
    if conf["weights"] == "artifacts":
        tree = os.path.join(root, conf["artifacts"])
        state = ref_weights.from_artifacts(tree)
        if not program:
            return None, state
        pipe = Pipeline.from_artifacts(tree, conf["preset"], device=device,
                                       overrides=conf["overrides"])
    elif conf["weights"] == "seed":
        state = ref_weights.random_state(reference_modules(conf), seed, device)
        if not program:
            return None, state
        cfg = apply_overrides(get_config(conf["preset"]), list(conf["overrides"]))
        pipe = Pipeline(cfg, params=state, device=device)
    else:
        raise ValueError(f"weights={conf['weights']!r}: 'artifacts' or 'seed'")
    unstated = check_config(pipe.cfg, stated)
    if unstated:
        print(f"[config] not stated, at their defaults: "
              f"{', '.join(f'{k}={v!r}' for k, v in unstated.items())}", file=sys.stderr)
    return pipe, state


def _differences(ran: dict, stated: dict, default: dict, at: str = "") -> tuple[dict, dict]:
    """({key: system's value} of keys that differ, {key: value} of keys
    unstated at their defaults), dotted."""
    diff, unstated = {}, {}
    for k in sorted(set(ran) | set(stated)):
        key = at + k
        if k not in stated and k in default and ran[k] == default[k]:
            unstated[key] = ran[k]
        elif k not in stated or k not in ran:
            diff[key] = ran.get(k)
        elif isinstance(ran[k], dict) and isinstance(stated[k], dict):
            d, u = _differences(ran[k], stated[k], default.get(k, {}), key + ".")
            diff.update(d)
            unstated.update(u)
        elif ran[k] != stated[k]:
            diff[key] = ran[k]
    return diff, unstated


def check_config(cfg, stated: dict) -> dict:
    """The system's config dataclass `cfg` against the file's "pipeline"
    section `stated`, section by section: a key the file states matches the
    system's value exactly; a key the system has and the file does not state
    is accepted only at its dataclass default (`type(cfg)()`, nested).  Any
    other difference raises.  -> {dotted key: value} of the keys accepted
    unstated."""
    ran, default = _plain(dataclasses.asdict(cfg)), _plain(dataclasses.asdict(type(cfg)()))
    diff, unstated = _differences(ran, stated, default)
    if diff:
        raise ValueError(f"the system runs another configuration than the file states: {diff}")
    return unstated


def reference_modules(conf: dict, lowp: bool = False) -> dict:
    """{model: reference module} of the configuration file `conf`, the pose
    net from its pose reference module."""
    stated, num = conf["pipeline"], nets.Numerics(lowp)
    return {"pose": pose_reference(conf).PoseNet(stated["pose"], num),
            "gcn": nets.GCN(stated["gcn"], num),
            "align": nets.AlignEncoder(stated["align"], num),
            "error": nets.ErrorHead(stated["error"], num)}


def core(pipe, frames, boxes, valid, spans=NO_SPANS) -> dict:
    """`_core_fn` as its two stages, each in its own span."""
    with spans.span("bench.pose"):
        kpts, aux = pipe._pose_fn(frames, boxes)
    with spans.span("bench.heads"):
        return pipe._heads_fn(kpts, aux, valid)


def compare(pipe, out: dict, valid, ref, spans=NO_SPANS) -> dict:
    """`_align_batch_fn` against the reference swing `ref` (keypoints, valid),
    refining the error logits as `analyze_batch` does."""
    with spans.span("bench.align"):
        return pipe._align_batch_fn(out["keypoints"], valid, ref[0], ref[1],
                                    out["phase_logits"], out.get("kpt_aux"))


def request(pipe, frames, boxes, valid, ref, spans=NO_SPANS) -> dict:
    """One request through the per-chunk program: the outputs that a client
    gets (keypoints, aux, phase logits and labels, refined error logits and
    the flags `analyze_batch` thresholds from them with the pipeline's
    thresholds, alignment cost, path and its length)."""
    out = core(pipe, frames, boxes, valid, spans)
    a = compare(pipe, out, valid, ref, spans)
    flags = torch.sigmoid(a["error_logits"]) > pipe._thresholds(None)
    return {"keypoints": out["keypoints"], "kpt_aux": out.get("kpt_aux"),
            "phase_logits": out["phase_logits"], "phase_labels": out["phase_labels"],
            "error_logits": a["error_logits"], "error_flags": flags, "cost": a["cost"],
            "path": a["path"], "path_length": a["path_length"]}
