"""BENCHMARK.json against its files: every cell, configuration and
per-layer metric is found by its name, and the file keeps to the limits
of its contract."""

import json
import re

import pytest

from portbench.core import guard, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1] == "portbench/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_cells_found_by_name(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        cell = spec.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert hasattr(spec.traffic(cell["traffic_kind"]), "run")
        assert cell["limits"], w["name"]


def test_configs_found_by_name(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = spec.config(c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert cfg["dtype"] in ("float32", "bfloat16")
        assert c["source"].startswith("https://") and len(c["source"]) <= 200


def test_metrics_found_by_name(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = {}
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert callable(spec.metric_reader(m["name"]).read)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"orchestrator", "runner", "step", "kernels",
                           "device"}


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end_for(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = spec.per_layer_for(bench, w["name"])
        assert per and all(m["moves"] in e2e for m in per)
        # a kernel's roofline beside the whole step's share of the peak
        moved = {m["moves"] for m in per if m["name"].endswith("_roofline")
                 or "_roofline." in m["name"]}
        for e in moved:
            assert any("mfu" in m["name"] and m["moves"] == e for m in per)


def test_bad_names_are_refused():
    for bad in ("../x", "a/b", "", " x", "x y"):
        with pytest.raises(ValueError):
            spec.check_name(bad)


def test_forbidden_modules_compare_top_level_names_whole():
    assert guard.forbidden_modules(["dvae_tpu_torch", "dvae_tpu_torch.ops",
                                    "torch", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["jax.numpy", "dvae_tpu.ops", "flax",
                                    "jaxlib"]) == ["dvae_tpu", "flax", "jax",
                                                   "jaxlib"]


def test_a_metric_reports_the_quantity_its_name_begins_with(bench):
    assert spec.quantity("train_cells_per_s.zinb") == "train_cells_per_s"
    assert spec.quantity("setup_s") == "setup_s"
    # a cell reports each quantity under one name at most
    for w in bench["workloads"]:
        names = [m["name"] for m in spec.end_to_end_for(bench, w["name"])]
        quantities = [spec.quantity(n) for n in names]
        assert len(quantities) == len(set(quantities)), w["name"]
