"""A run of each cell at a tiny width on the CPU, past the harness's look
for a card: the result line's keys, a sound run judged correct, and the
timed path broken underneath judged not correct, once for each fault the
cell can have.  (One card holds every cell, so no cell exchanges data
between chips.)"""

import json
import time

import pytest
import torch

from portbench.core import harness, spec

CELLS = ["mse-train-20k", "zinb-train-20k", "mse-serve-atlas",
         "zinb-serve-atlas"]


def _run(tiny_cell, name, trace=False, seconds=0.5):
    cell, cfg = tiny_cell(name)
    res = harness.run_cell(cell, cfg, 2 ** 40 + 7, seconds, trace,
                           torch.device("cpu"), time.perf_counter())
    line = harness.build_line(spec.benchmark(), name, cell, cfg, trace, res,
                              {"platform": "cpu", "kind": "cpu", "count": 1,
                               "memory_peak_bytes": 0})
    return line, res


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_and_its_line(tiny_cell, name):
    line, res = _run(tiny_cell, name)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = spec.benchmark()
    want = {m["name"] for m in spec.end_to_end_for(bench, name)}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(spec.workload(name)["limits"])
    json.loads(json.dumps(line))


@pytest.mark.parametrize("name", ["mse-train-20k", "mse-serve-atlas"])
def test_traced_line(tiny_cell, name):
    line, _ = _run(tiny_cell, name, trace=True)
    assert line["correct"] is True
    assert list(line)[-1] == "checks" and "breakdown" in line
    # the CPU has no device trace: only the host-clock metrics read
    bench = spec.benchmark()
    host = {m["name"] for m in spec.per_layer_for(bench, name)
            if m["source"] == "host_clock"}
    assert set(line["metrics"]) == host


def _train_fault(monkeypatch, kind):
    import dvae_tpu_torch.train.step as step_mod
    if kind == "state_unchanged":
        monkeypatch.setattr(step_mod.Adam, "update",
                            lambda self, grads, state, params: state)
    elif kind == "half_batch":
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
    elif kind == "later_steps_skipped":
        # the steps the reference follows run; every second one after
        # them hands back the state it got, unchanged
        make = step_mod.make_train_step

        def skipping(*a, **k):
            fn, calls = make(*a, **k), {"n": 0, "last": None}

            def step(state, *args, **kwargs):
                calls["n"] += 1
                if calls["n"] > 4 and calls["n"] % 2:
                    return (state,) + calls["last"]
                out = fn(state, *args, **kwargs)
                calls["last"] = out[1:]
                return out
            return step
        monkeypatch.setattr(step_mod, "make_train_step", skipping)
    elif kind == "answer_altered":
        update = step_mod.Adam.update

        def doubled(self, grads, state, params):
            grads = {n: dict(layer) for n, layer in grads.items()}
            grads["fc5"]["w"] = 2 * grads["fc5"]["w"]
            return update(self, grads, state, params)
        monkeypatch.setattr(step_mod.Adam, "update", doubled)


@pytest.mark.parametrize("name", ["mse-train-20k", "zinb-train-20k"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "later_steps_skipped", "answer_altered"])
def test_training_faults_are_not_correct(tiny_cell, monkeypatch, name, fault):
    _train_fault(monkeypatch, fault)
    line, _ = _run(tiny_cell, name)
    assert line["correct"] is False, (fault, line["checks"])


def _serve_fault(monkeypatch, kind):
    import dvae_tpu_torch.train.cpl_mixvae as cm
    if kind == "half_batch":
        make = cm.make_eval_step

        def halved(*a, **k):
            fn = make(*a, **k)

            def step(state, x, prior, temp):
                h = max(x.shape[0] // 2, 1)
                return fn(state, torch.cat([x[:h], x[:h]])[: x.shape[0]],
                          prior, temp)
            return step
        monkeypatch.setattr(cm, "make_eval_step", halved)
        monkeypatch.setattr(cm, "make_eval_runner", _runner_of(halved))
    elif kind == "answer_altered":
        serve = cm.CplMixVAE.eval_model

        def altered(self, *a, **k):
            out = serve(self, *a, **k)
            lab = out["pred_label"].copy()
            lab[0, -1] = (lab[0, -1] + 1) % self.cfg.n_categories
            out["pred_label"] = lab
            return out
        monkeypatch.setattr(cm.CplMixVAE, "eval_model", altered)


def _runner_of(make_step):
    from dvae_tpu_torch.models.losses import LossOutputs
    from dvae_tpu_torch.train.step import EvalFields

    def make_runner(*a, **k):
        ev = make_step(*a, **k)

        def run(state, x_chunk, temp, prior_chunk=None):
            auxes, fields = [], []
            for i in range(x_chunk.shape[0]):
                aux, lab, o = ev(state, x_chunk[i], None, temp)
                auxes.append(aux)
                fields.append((o.c, o.s_mean, o.s_logvar, o.x_low, lab))
            return (LossOutputs(*(torch.stack(v) for v in zip(*auxes))),
                    EvalFields(*(torch.cat(v, dim=1) for v in zip(*fields))))
        return run
    return make_runner


@pytest.mark.parametrize("name", ["mse-serve-atlas", "zinb-serve-atlas"])
@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_serving_faults_are_not_correct(tiny_cell, monkeypatch, name, fault):
    _serve_fault(monkeypatch, fault)
    line, _ = _run(tiny_cell, name)
    assert line["correct"] is False, (fault, line["checks"])
