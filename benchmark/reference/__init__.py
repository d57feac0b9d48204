"""The plain reference the benchmark holds the system to: plain PyTorch, importing nothing of
the system under test, of JAX or of the JAX package.

A configuration file may name the module of its pose network under the key
"pose_reference"; without it the pose net is `benchmark.reference.nets`'s
SimpleBaseline ResNet.  The module provides `PoseNet(c, num)` (crops ->
float32 heatmaps, with the system's state-dict names) and `pose_flops(p)`
(the matrix FLOPs of one crop), and `pose_reference` hands it to every site
that builds, weights, checks or counts the pose net.
"""

from __future__ import annotations

import importlib

PACKAGE = "benchmark.reference."
DEFAULT_POSE = PACKAGE + "nets"
POSE_PROVIDES = ("PoseNet", "pose_flops")


def pose_reference(conf: dict):
    """The pose reference module that the configuration file `conf` names."""
    name = conf.get("pose_reference", DEFAULT_POSE)
    if not isinstance(name, str) or not name.startswith(PACKAGE) or name == PACKAGE:
        raise ValueError(f"pose_reference={name!r}: a module under {PACKAGE!r}")
    mod = importlib.import_module(name)
    missing = [f for f in POSE_PROVIDES if not callable(getattr(mod, f, None))]
    if missing:
        raise ValueError(f"pose_reference={name!r} lacks {', '.join(missing)}: a pose "
                         f"reference module provides PoseNet(c, num) and pose_flops(p)")
    return mod
