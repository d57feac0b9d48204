"""The port stands alone: no module of golfaction_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax, orbax, the JAX package or the JAX
package's scripts (as `scripts.<name>` or by a script's bare name)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "golfaction_tpu", "scripts")
SCRIPT_MODULES = {p.stem for p in (ROOT / "scripts").glob("*.py")}
PKG = ROOT / "golfaction_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "build" not in p.relative_to(PKG).parts) + [ROOT / "chip_smoke.py"]


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    return (any(name == f or name.startswith(f + ".") for f in FORBIDDEN)
            or name.split(".")[0] in SCRIPT_MODULES)


def test_sources_found():
    assert len(SOURCES) > 20
    found = {str(p.relative_to(PKG)) for p in SOURCES[:-1]}
    assert {"train/__init__.py", "train/data.py", "train/loops.py", "train/losses.py",
            "train/metrics.py", "cli.py", "demo_e2e.py", "pipeline/streaming.py",
            "pipeline/report.py", "pipeline/visualize.py", "models/precision.py",
            "utils/profiling.py", "utils/logging.py", "train/import_weights.py",
            "bench.py", "parallel/__init__.py", "parallel/mesh.py", "parallel/comm.py",
            "parallel/train_step.py", "ops/softdtw_sharded.py", "cascade_finetune.py",
            "calibrate_thresholds.py", "train_eval.py", "_probe_common.py", "probe_arm_gain.py",
            "probe_heatmap_modes.py", "probe_heatmap_spread.py", "promote_artifacts.py",
            "import_pose.py", "softdtw_bwd_bench.py"} <= found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_catches_the_jax_package():
    assert _forbidden("golfaction_tpu") and _forbidden("golfaction_tpu.ops.softdtw")
    assert _forbidden("jax.numpy") and not _forbidden("golfaction_tpu_torch.ops")
    assert _forbidden("scripts.probe_arm_gain") and _forbidden("_probe_common")
    assert _forbidden("probe_heatmap_modes") and not _forbidden("golfaction_tpu_torch._probe_common")
