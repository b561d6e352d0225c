"""Tests of the benchmark.  On the CPU they run the cells at tiny widths
through the program's plain paths; tests marked ``cuda`` need the card and
run there at the cells' own sizes:

    python3 -m pytest portbench/tests -q            # CPU: the card tests skip
    python3 -m pytest portbench/tests -q -m cuda    # on the card
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided in the test, not
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def tiny(cell_name: str):
    """(cell, config) of a cell at widths a CPU test holds."""
    from portbench.core import spec
    cell = copy.deepcopy(spec.workload(cell_name))
    cfg = copy.deepcopy(spec.config(cell["config"]))
    cfg["model"].update(input_dim=64, fc_dim=16, n_categories=7, n_arm=3)
    cfg["train"].update(batch_size=32, epochs_per_jit=2, eval_every=2)
    if cell["traffic_kind"] == "train_resident":
        cell["params"].update(n_train=128, n_val=40)
        # the cell's numbers at these widths: a few dead categories carry
        # the coupling term (~1e11 of the loss), so the leaf changes of
        # three Adam steps read up to ~0.02 on sound runs, the first
        # step's loss and gradients up to ~1e-4; every fault the tests
        # plant reads 0.1 or more on one of the numbers
        cell["limits"] = {"loss1": 1e-3, "grad": 1e-2,
                          "grad_diff_median": 1e-3, "change": 0.05,
                          "steps_unapplied": 0}
    else:
        cell["params"].update(n_atlas=3000, min_cells=20, max_cells=300,
                              n_sizes=10, warm_sizes=[300, 20],
                              sample_from=20, sample=5, trace_requests=4)
    return cell, cfg


@pytest.fixture
def tiny_cell():
    return tiny
