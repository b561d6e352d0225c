"""``core/spans.py`` and the metrics that read the program's spans, on
hand-made Chrome-trace events: nested spans, overlapping device
intervals, clipping to the slice's window, and ``None`` where the spans
or the device trace are absent."""

import random

import pytest

from portbench.core import spans, spec
from portbench.core.harness import Readings
from portbench.core.trace import TraceSlice, merge

NEW = {"train": ["step_host_ms.train", "idle_in_step.train",
                 "idle_in_runner.train", "idle_in_validate.train"],
       "serve": ["drain_host_ms.serve", "idle_in_enqueue.serve",
                 "idle_in_drain.serve", "idle_in_finish.serve"]}
ZINB = [n + ".zinb" for n in NEW["train"]]


def _span(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _kernel(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}


def _slice(events, t0=0.0, t1=200.0):
    return TraceSlice([_span("portbench.slice", t0, t1 - t0)] + events)


def _readings(sl, cells=0):
    return Readings({}, "float32", {"slice_served_cells": cells}, sl, {})


def _read(name, sl, cells=0):
    return spec.metric_reader(name).read(_readings(sl, cells))


# a chunk: runner [0, 100] holding steps [10, 40] and [50, 80], the
# kernels [15, 20] and [60, 90] (the second overlapped by [70, 85]);
# then a validation [120, 160] with a kernel [130, 150]
TRAIN = [_span("dvae.runner", 0, 100), _span("dvae.step", 10, 30),
         _span("dvae.step.forward", 10, 10), _span("dvae.step", 50, 30),
         _span("dvae.validate", 120, 40),
         _span("dvae.step", 10, 30, cat="gpu_user_annotation"),
         _kernel(15, 5), _kernel(60, 30), _kernel(70, 15, cat="gpu_memcpy"),
         _kernel(130, 20, cat="gpu_memset")]


def test_intervals_by_name_host_side_only():
    sl = _slice(TRAIN)
    assert spans.intervals(sl, "step") == [(10.0, 40.0), (50.0, 80.0)]
    assert spans.intervals(sl, "step.forward") == [(10.0, 20.0)]
    assert spans.intervals(sl, "eval.drain") == []


def test_intervals_clipped_to_the_window():
    sl = _slice([_span("dvae.step", -20, 50), _span("dvae.step", 90, 60),
                 _span("dvae.step", 150, 10), _kernel(0, 1)], 0.0, 100.0)
    assert spans.intervals(sl, "step") == [(0.0, 30.0), (90.0, 100.0)]


def test_nested_spans_and_exclusions():
    sl = _slice(TRAIN)
    # steps: [10, 40] less [15, 20], [50, 80] less [60, 80]
    assert spans.idle_inside(sl, ["step"]) == pytest.approx(35.0)
    # runner outside steps: [0, 10], [40, 50], [80, 100] less [80, 90]
    assert spans.idle_inside(sl, ["runner"], ["step"]) == pytest.approx(
        30.0)
    assert spans.idle_inside(sl, ["validate"]) == pytest.approx(20.0)
    assert _read("idle_in_step.train", sl) == pytest.approx(17.5)
    assert _read("idle_in_runner.train", sl) == pytest.approx(15.0)
    assert _read("idle_in_validate.train", sl) == pytest.approx(10.0)
    assert _read("step_host_ms.train", sl) == pytest.approx(0.030)


def test_overlapping_device_intervals_count_once():
    sl = _slice([_span("dvae.eval.drain", 0, 100), _kernel(10, 30),
                 _kernel(20, 30), _kernel(45, 10, cat="gpu_memcpy")])
    assert spans.idle_inside(sl, ["eval.drain"]) == pytest.approx(55.0)


def test_idle_inside_the_split_adds_up_to_the_whole():
    """Step, runner outside steps and validation, with the idle outside
    every span ([100, 120], [160, 200]), make the slice's device idle."""
    sl = _slice(TRAIN)
    parts = sum(_read(n, sl) for n in NEW["train"][1:])
    assert parts == pytest.approx(42.5)
    assert parts + 100.0 * 60.0 / 200.0 == pytest.approx(
        _read("device_idle.train", sl))


def test_serve_readers():
    ev = [_span("dvae.eval", 0, 100), _span("dvae.eval.batch", 0, 20),
          _span("dvae.eval.batch", 20, 20), _span("dvae.eval.drain", 50, 30),
          _span("dvae.eval.finish", 80, 15), _kernel(5, 40),
          _kernel(55, 10, cat="gpu_memcpy")]
    sl = _slice(ev, 0.0, 100.0)
    assert _read("idle_in_enqueue.serve", sl) == pytest.approx(5.0)
    assert _read("idle_in_drain.serve", sl) == pytest.approx(20.0)
    assert _read("idle_in_finish.serve", sl) == pytest.approx(15.0)
    # 30 µs of drains over 2,000 cells
    assert _read("drain_host_ms.serve", sl, cells=2000) == pytest.approx(
        0.030 / 2.0)
    assert _read("drain_host_ms.serve", sl, cells=0) is None


def test_span_under_busy_device_reads_zero():
    sl = _slice([_span("dvae.step", 10, 30), _kernel(0, 50)], 0.0, 50.0)
    assert _read("idle_in_step.train", sl) == 0.0


@pytest.mark.parametrize("name", NEW["train"] + ZINB + NEW["serve"])
def test_absent_spans_read_none(name):
    """A program without the spans (the parent of the change that added
    them), a CPU slice without device events, and no slice: no reading."""
    plain = _slice([_span("portbench.train", 0, 100), _kernel(5, 40)])
    cpu = _slice([s for s in TRAIN if s["cat"] == "user_annotation"])
    for sl in (plain, cpu, None):
        assert _read(name, sl, cells=1000) is None


@pytest.mark.parametrize("name", ZINB)
def test_zinb_twins_read_as_the_mse_metric(name):
    sl = _slice(TRAIN)
    assert _read(name, sl) == _read(name[:-len(".zinb")], sl)


def test_new_metrics_listed_with_their_cells():
    bench = spec.benchmark()
    by = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW["train"]:
        assert by[name]["workloads"] == ["mse-train-20k"]
        assert by[name + ".zinb"]["workloads"] == ["zinb-train-20k"]
        assert by[name + ".zinb"]["moves"] == "train_cells_per_s.zinb"
    for name in NEW["serve"]:
        assert by[name]["workloads"] == ["zinb-serve-atlas"]
    for name in NEW["train"] + ZINB + NEW["serve"]:
        assert by[name]["source"] == "device_trace"


def _brute(a, b, grid):
    def inside(x, ivs):
        return any(s <= x < e for s, e in ivs)
    return sum(1 for x in grid if inside(x, a) and not inside(x, b))


def _random_ivs(rng, n):
    out = []
    for _ in range(n):
        s = rng.randrange(0, 100)
        out.append((s, s + rng.randrange(1, 20)))
    return [tuple(iv) for iv in merge(out)]


@pytest.mark.parametrize("seed", range(5))
def test_subtract_against_a_grid(seed):
    rng = random.Random(seed)
    grid = range(0, 130)
    for _ in range(50):
        a, b = _random_ivs(rng, rng.randrange(0, 8)), _random_ivs(
            rng, rng.randrange(0, 8))
        got = spans.subtract(a, b)
        assert spans.total(got) == _brute(a, b, grid)
        assert all(e > s for s, e in got)
        assert got == sorted(got)
