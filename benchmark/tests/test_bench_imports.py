"""Nothing the benchmark loads imports JAX or the JAX package, and the
reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

from benchmark import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_sources_import_nothing_of_the_port_or_jax():
    ref = os.path.join(HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            bad = _imports(os.path.join(ref, name)) & {"golfaction_tpu_torch", *run.FORBIDDEN}
            assert not bad, (name, bad)


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                bad = _imports(os.path.join(dirpath, name)) & set(run.FORBIDDEN)
                assert not bad, (name, bad)


def test_forbidden_modules_compares_whole_top_level_names():
    sys.modules["golfaction_tpu_torch_fake_probe"] = sys.modules["os"]
    try:
        assert "golfaction_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["golfaction_tpu_torch_fake_probe"]


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port(tmp_path):
    code = """
import json, sys, torch
torch.set_num_threads(2)
import benchmark.reference.pipeline, benchmark.check, benchmark.counts
port = sorted(m for m in sys.modules if m.split('.')[0] == 'golfaction_tpu_torch')
from benchmark import run
from benchmark.tests.conftest import load, tiny_pipeline, tiny_traffic
conf = tiny_pipeline(load('configs', 'full_pipeline'))
res = run.execute(conf, tiny_traffic(), 2 ** 32 + 9, 0.5, False, device='cpu',
                  metrics={'frames_per_s': 'frames/s', 'setup_s': 's'})
print(json.dumps({'port_in_reference': port, 'forbidden': run.forbidden_modules(),
                  'correct': res['correct']}))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"port_in_reference": [], "forbidden": [], "correct": True}


def test_without_a_card_the_run_exits_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "shipped.resident_chunks", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
