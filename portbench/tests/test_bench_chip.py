"""On the card, at each cell's own size: sound runs of the program pass
every limit, and the control (the plain reference with TF32 products put
in the program's place) fails at least one.

    python3 -m pytest portbench/tests/test_bench_chip.py -q -m cuda
"""

import time

import pytest

from portbench import control
from portbench.core import compare, harness, spec

CELLS = ["mse-train-20k", "zinb-train-20k", "mse-serve-atlas",
         "zinb-serve-atlas"]
SEEDS = (101, 202, 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = spec.workload(name)
    config = spec.config(cell["config"])
    fn = (control.train_readings if cell["traffic_kind"] == "train_resident"
          else control.serve_readings)
    for seed in SEEDS:
        ctx = harness.Context(cell, config, seed, 0.0, False, card,
                              time.perf_counter())
        got = fn(ctx)
        ok, checks = compare.judge(got["program"], cell["limits"])
        assert ok, (seed, checks)
        ok, checks = compare.judge(got["control_tf32"], cell["limits"])
        assert not ok, (seed, checks)
