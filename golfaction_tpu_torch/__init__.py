"""golfaction_tpu_torch — the golf-swing analysis framework on PyTorch and
CUDA (NVIDIA Hopper), ported from the JAX package `golfaction_tpu`.

Public surface:
    analyze(video)              one clip through a cached preset Pipeline
    Pipeline                    pipeline.orchestrator.Pipeline
    Pipeline.from_artifacts     the shipped model from artifacts/
    StreamAnalyzer, analyze_stream, build_report, format_report
    config.get_config(preset)   the five named presets
"""

from golfaction_tpu_torch import config, graph, types
from golfaction_tpu_torch.config import get_config
from golfaction_tpu_torch.types import AlignmentResult, AnalysisResult, Skeleton

__all__ = ["analyze", "Pipeline", "config", "graph", "types", "get_config", "Skeleton",
           "AlignmentResult", "AnalysisResult"]


def __getattr__(name):
    # Lazy imports keep `import golfaction_tpu_torch` light.
    if name in ("analyze", "Pipeline"):
        from golfaction_tpu_torch.pipeline import orchestrator

        return getattr(orchestrator, name)
    if name in ("StreamAnalyzer", "analyze_stream"):
        from golfaction_tpu_torch.pipeline import streaming

        return getattr(streaming, name)
    if name in ("build_report", "format_report"):
        from golfaction_tpu_torch.pipeline import report

        return getattr(report, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
