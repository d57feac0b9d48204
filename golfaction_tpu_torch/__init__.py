"""golfaction_tpu_torch — the golf-swing analysis framework on PyTorch and
CUDA (NVIDIA Hopper), ported from the JAX package `golfaction_tpu`.

Public surface:
    Pipeline                    pipeline.orchestrator.Pipeline
    Pipeline.from_artifacts     the shipped model from artifacts/
    config.get_config(preset)   the five named presets
"""

from golfaction_tpu_torch import config, graph, types
from golfaction_tpu_torch.config import get_config
from golfaction_tpu_torch.types import AlignmentResult, AnalysisResult, Skeleton

__all__ = ["Pipeline", "config", "graph", "types", "get_config", "Skeleton",
           "AlignmentResult", "AnalysisResult"]


def __getattr__(name):
    if name == "Pipeline":
        from golfaction_tpu_torch.pipeline.orchestrator import Pipeline

        return Pipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
