"""The cell ``mse-train-aug`` at a tiny width on the CPU: a sound run and
its line, the timed path broken underneath judged not correct once for
each fault the augmenter can have, the plain augmenter's work by hand, and
the readers that attribute kernels to the program's ``dvae.step.augment``
spans on hand-made Chrome-trace events."""

import copy
import json
import time

import pytest
import torch

from portbench.core import compare, harness, roofline, spec
from portbench.core.harness import Readings
from portbench.core.trace import TraceSlice

CELL = "mse-train-aug"
NEW = ["augment_roofline.train.aug", "augment_share.train.aug",
       "train_mfu.aug", "launches_per_step.train.aug",
       "device_idle.train.aug", "encoder_roofline.train.aug",
       "recon_roofline.train.aug", "validate_share.train.aug",
       "idle_in_validate.train.aug", "step_host_ms.train.aug",
       "idle_in_step.train.aug"]


def tiny():
    """(cell, config) at widths a CPU test holds; the limits of the
    training numbers as ``conftest.tiny`` sets them (dead categories carry
    the coupling term at these widths), ``views`` the cell's own."""
    cell = copy.deepcopy(spec.workload(CELL))
    cfg = copy.deepcopy(spec.config(cell["config"]))
    cfg["model"].update(input_dim=64, fc_dim=16, n_categories=7, n_arm=3)
    cfg["model"]["augmenter"].update(input_dim=64, n_dim=20, noise_dim=6,
                                     latent_dim=4)
    cfg["train"].update(batch_size=32, epochs_per_jit=2, eval_every=2)
    cell["params"].update(n_train=128, n_val=40)
    cell["limits"].update(loss1=1e-3, grad=1e-2, grad_diff_median=1e-3,
                          change=0.05)
    return cell, cfg


def _run(trace=False):
    cell, cfg = tiny()
    res = harness.run_cell(cell, cfg, 2 ** 40 + 7, 0.5, trace,
                           torch.device("cpu"), time.perf_counter())
    line = harness.build_line(spec.benchmark(), CELL, cell, cfg, trace, res,
                              {"platform": "cpu", "kind": "cpu", "count": 1,
                               "memory_peak_bytes": 0})
    return line, res


def test_sound_run_and_its_line():
    line, res = _run()
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_cells_per_s", "setup_s"}
    assert set(line["checks"]) == set(spec.workload(CELL)["limits"])
    assert "views" in line["checks"]
    json.loads(json.dumps(line))


def test_traced_line():
    line, res = _run(trace=True)
    assert line["correct"] is True
    # the CPU has no device trace: only the host-clock metrics read
    assert set(line["metrics"]) == {"train_mfu.aug",
                                    "validate_share.train.aug"}
    assert res.calls["train"] and set(res.calls["train"]) == {32}


def _tf32_products(monkeypatch):
    import dvae_tpu_torch.augment.augmenter as am

    from portbench.reference.model import round_tf32

    def lin(p, x):
        y = round_tf32(x) @ round_tf32(p["w"])
        return y if p["b"] is None else y + p["b"]
    monkeypatch.setattr(am, "_lin", lin)


def _noise_scale(monkeypatch):
    import dvae_tpu_torch.augment.augmenter as am
    arms = am.augment_arms

    def doubled(params, bn, cfg, x, n_arm, scale=0.1, *a, **k):
        return arms(params, bn, cfg, x, n_arm, 2 * scale, *a, **k)
    monkeypatch.setattr(am, "augment_arms", doubled)


def _weights_perturbed(monkeypatch):
    import dvae_tpu_torch.augment.augmenter as am
    load = am.load_augmenter

    def perturbed(*a, **k):
        params, bn, cfg = load(*a, **k)
        params["fc6"]["w"].mul_(1.0 + 1e-3)
        return params, bn, cfg
    monkeypatch.setattr(am, "load_augmenter", perturbed)


def _trunk_batch_stats(monkeypatch):
    """The trunk run on every arm's copy of the batch with train-mode batch
    norms (each arm's batch statistics); the rest as the program has it."""
    import dvae_tpu_torch.augment.augmenter as am

    @torch.no_grad()
    def arms(params, bn, cfg, x, n_arm, scale=0.1, generator=None,
             draws=am.AugNoise()):
        def ev(name, h, act=torch.relu):
            eps, mom = am._BN_HYPERS.get(name, (am.BN_EPS, am.BN_MOMENTUM))
            y, _ = am._bn(h, bn[name], False, eps, mom)
            return act(y) if act else y
        h = x.expand(n_arm, *x.shape)
        for fc, norm in (("fc1", "bn1"), ("fc2", "bn2"), ("fc3", "bn3"),
                         ("fc4", "bn4")):
            y = torch.stack([am._bn(am._lin(params[fc], h[i]), bn[norm],
                                    True)[0] for i in range(n_arm)])
            h = torch.relu(y)
        h = am._noise_concat(params, ev, cfg, h, scale, generator, draws.z)
        return am._latent_decode(params, ev, h, generator, draws.e,
                                 zinb_head=False)[1]
    monkeypatch.setattr(am, "augment_arms", arms)


def _half_batch(monkeypatch):
    """Each step sees the first half of its batch alone: the augmenter
    makes views of those rows, the model trains on them."""
    import dvae_tpu_torch.train.step as step_mod
    make = step_mod.make_train_step

    def halved(*a, **k):
        fn = make(*a, **k)

        def step(state, x, prior, temp, generator=None, enc_seed=None,
                 noise=None, aug_draws=None):
            state, m, lab = fn(state, x[: x.shape[0] // 2], prior, temp,
                               generator, enc_seed, noise, aug_draws)
            return state, m, torch.cat([lab, lab], dim=1)
        return step
    monkeypatch.setattr(step_mod, "make_train_step", halved)


FAULTS = {"tf32_products": _tf32_products, "noise_scale": _noise_scale,
          "weights_1e-3": _weights_perturbed,
          "trunk_batch_stats": _trunk_batch_stats,
          "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_augmenter_faults_are_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line, _ = _run()
    assert line["correct"] is False, (fault, line["checks"])
    assert line["checks"]["views"]["value"] > line["checks"]["views"][
        "limit"], fault


def test_skipped_steps_are_not_correct(monkeypatch):
    import dvae_tpu_torch.train.step as step_mod
    monkeypatch.setattr(step_mod.Adam, "update",
                        lambda self, grads, state, params: state)
    line, _ = _run()
    assert line["correct"] is False


# ---------------------------------------------------------------------------
# The augmenter's work and the readers of its spans
# ---------------------------------------------------------------------------

MODEL = spec.config("mmidas-ss-a5-mse-aug")["model"]
AUG = spec.metric_reader("augment_roofline.train.aug")


def test_augmenter_flops_by_hand():
    # fc1–fc4 on B rows; the noise layer, fc5, fc_mu, fc_sigma, fc6–fc11
    # on A·B rows
    trunk = 5032 * 1006 + 1006 * 1006 + 1006 * 500 + 500 * 500
    arms = (50 * 50 + 550 * 100 + 2 * 100 * 10 + 10 * 100 + 100 * 500
            + 500 * 500 + 500 * 1006 + 1006 * 1006 + 1006 * 5032)
    want = 2 * 5000 * trunk + 2 * 5 * 5000 * arms
    assert AUG.forward_flops(MODEL, 5000) == pytest.approx(want, rel=1e-12)
    assert AUG.forward_flops(MODEL, 5000) == pytest.approx(415.2e9,
                                                           rel=1e-3)
    # operations bound the four wide layers; bytes the narrow per-arm ones
    # (fc5 reads and writes 65 MB for 2.75 GFLOP), 0.045 ms in all
    calls = dict(zip([n for n, *_ in AUG.layers(MODEL)],
                     AUG.work(MODEL, 5000, 4)))
    peak, bw = roofline.PEAK_FLOPS["float32"], roofline.HBM_BYTES_PER_S
    for name in ("fc1", "fc2", "fc10", "fc11"):
        assert calls[name][0] / peak > calls[name][1] / bw
    assert calls["fc5"][0] / peak < calls["fc5"][1] / bw
    bound = roofline.bound_s(calls.values(), "float32")
    assert 1e3 * bound == pytest.approx(0.8839, abs=1e-4)


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


# one step [0, 100]: augment [0, 30] launches kernels 1 and 2 (which run
# later, [40, 70]); the forward launches 3 ([70, 100]) and a copy; a
# launch outside every span (kernel 5)
STEP = [_span("portbench.slice", 0, 200), _span("dvae.step", 0, 100),
        _span("dvae.step.augment", 0, 30), _launch(5, 1), _launch(20, 2),
        _launch(50, 3), _launch(60, 4), _launch(150, 5),
        _kernel(40, 20, 1), _kernel(60, 10, 2), _kernel(70, 30, 3),
        _kernel(100, 5, 4, cat="gpu_memcpy"), _kernel(160, 10, 5)]


def _read(name, events, calls=None, host=None):
    r = Readings(MODEL, "float32", host or {}, TraceSlice(events),
                 {"train": calls} if calls else {})
    return spec.metric_reader(name).read(r)


def test_kernels_attributed_by_their_launch():
    sl = TraceSlice(STEP)
    assert AUG.device_s(sl, "step.augment") == pytest.approx(30e-6)
    assert AUG.device_s(sl, "step") == pytest.approx(60e-6)
    assert _read("augment_share.train.aug", STEP) == pytest.approx(50.0)


def test_roofline_over_the_augment_kernels():
    got = _read("augment_roofline.train.aug", STEP, calls=[5000])
    bound = roofline.bound_s(AUG.work(MODEL, 5000, 4), "float32")
    assert got == pytest.approx(100.0 * bound / 30e-6)


@pytest.mark.parametrize("name", ["augment_roofline.train.aug",
                                  "augment_share.train.aug"])
def test_without_the_augment_span_no_reading(name):
    """The parent of the change that added the span, and a CPU slice."""
    plain = [e for e in STEP if e.get("name") != "dvae.step.augment"]
    cpu = [e for e in STEP if e["cat"] == "user_annotation"]
    assert _read(name, plain, calls=[5000]) is None
    assert _read(name, cpu, calls=[5000]) is None


def test_mfu_counts_the_augmenter():
    host = {"train_steps": 10, "batch": 5000, "window_s": 1.0}
    got = _read("train_mfu.aug", STEP, host=host)
    plain = spec.metric_reader("train_mfu").read(
        Readings(MODEL, "float32", host, None, {}))
    extra = 100.0 * 10 * AUG.forward_flops(MODEL, 5000) / 495e12
    assert got == pytest.approx(plain + extra)


@pytest.mark.parametrize("name,base,fn", [
    ("encoder_roofline.train.aug", "encoder_roofline.train", "per_arm_x"),
    ("recon_roofline.train.aug", "recon_roofline.train", "per_arm_target")])
def test_per_arm_kernels_read_every_arms_view(name, base, fn):
    """The same operations as the shared-x work; (A − 1)·B·D more bytes
    read in every call; the same kernels."""
    got = getattr(spec.metric_reader(name), fn)(MODEL, 5000, 4)
    shared = spec.metric_reader(base).WORK(MODEL, 5000, 4)
    more = 4 * 4 * 5000 * 5032
    assert [f for f, _ in got] == [f for f, _ in shared]
    assert [b - more for _, b in got] == [b for _, b in shared]
    assert spec.metric_reader(name).KERNELS == spec.metric_reader(
        base).KERNELS


@pytest.mark.parametrize("name", ["validate_share.train.aug",
                                  "idle_in_validate.train.aug",
                                  "step_host_ms.train.aug",
                                  "idle_in_step.train.aug",
                                  "device_idle.train.aug",
                                  "launches_per_step.train.aug"])
def test_aliases_read_as_their_training_metric(name):
    host = {"validate_s": 0.25, "window_s": 1.0, "train_steps": 1}
    base = name[:-len(".aug")]
    assert _read(name, STEP, host=host) == _read(base, STEP, host=host)


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_listed_with_the_cell(name):
    bench = spec.benchmark()
    by = {m["name"]: m for m in bench["per_layer"]}
    assert by[name]["workloads"] == [CELL]
    assert by[name]["moves"] == "train_cells_per_s"


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card(card):
    """At the cell's own size: the program passes every limit, the
    augmenter's products in TF32 and each planted fault fail one."""
    cell = spec.workload(CELL)
    config = spec.config(cell["config"])
    mod = spec.traffic(cell["traffic_kind"])
    for seed in (101, 2 ** 31 + 5):
        ctx = harness.Context(cell, config, seed, 0.0, False, card,
                              time.perf_counter())
        got = mod.readings(ctx)
        for kind, numbers in got.items():
            ok, checks = compare.judge(numbers, cell["limits"])
            assert ok == (kind == "program"), (seed, kind, checks)
