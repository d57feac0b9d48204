"""The control: the plain reference one precision step below the
configuration's, put in the system's place, fails the check.

On the CPU at a tiny size its numbers stand above the system's; on the card
(marked `cuda`), at the cell's own size, its run comes out not correct
against the cell's limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, control
from benchmark import run as bench
from benchmark.tests.conftest import load, tiny_pipeline, tiny_traffic


def test_the_control_reads_above_the_system_at_a_tiny_size():
    conf = tiny_pipeline(load("configs", "full_pipeline"))
    seed = 2 ** 31 + 99
    program = control.program_numbers(conf, tiny_traffic(), seed, 0.3, "cpu")
    low = control.control_numbers(conf, tiny_traffic(), seed, "cpu")
    for k in ("kpt_p50_px", "phase_logit_gap", "cost_rel_gap", "error_logit_gap"):
        assert low[k] > 3 * program[k], (k, low[k], program[k])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["shipped.resident_chunks", "full_pipeline.resident_chunks"])
def test_the_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    _, conf, traffic = bench.cell(bench.load_spec(), workload)
    numbers = control.control_numbers(conf, traffic, 2 ** 32 + 5, "cuda:0")
    correct, _ = check.verdict(numbers, conf["limits"])
    assert not correct, numbers
