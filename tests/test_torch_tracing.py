"""The port's own spans (``utils/profiling.span``) on the CPU.

Without a profiler ``span`` is one shared null context and never builds a
``record_function``.  Under ``profile_run`` the written Chrome trace holds
the ``dvae.*`` span tree as ``user_annotation`` ranges: one ``dvae.runner``
a chunk, one ``dvae.step`` a step holding ``forward``, ``backward`` and
``update`` in that order, ``dvae.runner.epoch_end`` once an epoch (the
resident and the streaming runner); ``dvae.validate``, ``dvae.eval``,
``_predict_labels`` and ``dvae.checkpoint`` with their batches, drains and
finish; every ``Tensor.cpu`` of an eval surface inside a drain.  Losses,
parameters and every ``eval_model`` and ``validate`` field are bit for
bit the same with the profiler on and off.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.data.stream import make_streaming_runner
from dvae_tpu_torch.train import cpl_mixvae as cm
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.train.step import make_epoch_runner, tree_leaves
from dvae_tpu_torch.utils import profiling as tprof

A, B, D, F, L, C, S = 3, 16, 40, 16, 8, 6, 2
DIMS = dict(n_arm=A, input_dim=D, fc_dim=F, lowD_dim=L, n_categories=C,
            state_dim=S)
N_TRAIN = 3 * B          # 3 steps an epoch
EPOCHS = 2               # a chunk
N_EVAL = 3 * B + 5       # a chunk of 3 batches and a leftover of 5
EPS = 1e-3               # µs: the trace prints times to the nanosecond


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _data(n, seed=0):
    return synthetic_dataset(n, D, C, seed=seed).log1p.astype(np.float32)


def _model(folder="", seed=7):
    cpl = CplMixVAE(saving_folder=folder, device="cpu", seed=seed)
    cpl.init_model(**DIMS, batch_size=B, epochs_per_jit=EPOCHS,
                   eval_every=1, ckpt_every=1)
    return cpl


def _spans(trace_dir):
    """[(name without ``dvae.``, start µs, end µs)] of the one Chrome trace
    under ``trace_dir``, by start."""
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"][len(tprof.SPAN_PREFIX):], float(e["ts"]),
            float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith(tprof.SPAN_PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(a, b):
    return b[1] - EPS <= a[1] and a[2] <= b[2] + EPS


def _profiled(tmp, fn):
    with tprof.profile_run(str(tmp)):
        out = fn()
    return out, _spans(str(tmp))


def _run_chunk(cpl, x):
    runner = make_epoch_runner(cpl.cfg, cpl.tcfg, cpl.tx, N_TRAIN,
                               epochs_per_chunk=EPOCHS)
    cpl.state, ems = runner(cpl.state, x, None, cpl.temp)
    return ems


@pytest.fixture(scope="module")
def chunk(tmp_path_factory):
    """The spans of one profiled chunk of the resident runner."""
    cpl = _model()
    x = torch.from_numpy(_data(N_TRAIN))
    _, spans = _profiled(tmp_path_factory.mktemp("chunk"),
                         lambda: _run_chunk(cpl, x))
    return spans


# ---------------------------------------------------------------------------
# span itself
# ---------------------------------------------------------------------------

def test_span_without_a_profiler_is_one_null_object():
    assert not torch.autograd._profiler_enabled()
    first = tprof.span("runner")
    assert all(tprof.span(n) is first for n in
               ("step", "step.forward", "eval.drain", "anything"))
    with first as got:
        assert got is None


def test_span_without_a_profiler_builds_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tprof.span("step"):
        pass


def test_span_under_a_profiler_is_a_named_range(tmp_path):
    def body():
        s = tprof.span("unit")
        assert s is not tprof.span("unit")
        with s:
            torch.ones(4).sum()
        return s
    _, spans = _profiled(tmp_path, body)
    assert [s[0] for s in spans] == ["unit"]
    assert tprof.span("unit") is tprof.span("other")   # off again


def test_spanned_marks_every_call_and_keeps_the_function(tmp_path):
    @tprof.spanned("unit")
    def twice(v, *, by=2):
        """doc"""
        return torch.as_tensor(v) * by

    assert (twice.__name__, twice.__doc__) == ("twice", "doc")
    assert float(twice(3.0, by=4)) == 12.0                # no profiler
    out, spans = _profiled(tmp_path, lambda: [twice(1.0), twice(2.0)])
    assert [float(v) for v in out] == [2.0, 4.0]
    assert [s[0] for s in spans] == ["unit", "unit"]


# ---------------------------------------------------------------------------
# training: the runner and the step
# ---------------------------------------------------------------------------

def test_one_runner_span_a_chunk(chunk):
    runners = _named(chunk, "runner")
    assert len(runners) == 1
    assert all(_inside(s, runners[0]) for s in chunk)


def test_one_step_span_a_step(chunk):
    assert len(_named(chunk, "step")) == EPOCHS * N_TRAIN // B


@pytest.mark.parametrize("sub", ["step.forward", "step.backward",
                                 "step.update"])
def test_each_step_holds_its_sub_span_once(chunk, sub):
    steps, subs = _named(chunk, "step"), _named(chunk, sub)
    assert len(subs) == len(steps)
    for st in steps:
        assert sum(_inside(s, st) for s in subs) == 1


def test_sub_spans_run_forward_backward_update(chunk):
    for st in _named(chunk, "step"):
        order = [s[0] for s in chunk if s[0].startswith("step.")
                 and _inside(s, st)]
        assert order == ["step.forward", "step.backward", "step.update"]


def test_epoch_end_once_an_epoch_after_its_steps(chunk):
    ends, steps = _named(chunk, "runner.epoch_end"), _named(chunk, "step")
    assert len(ends) == EPOCHS
    per = N_TRAIN // B
    for e, end in enumerate(ends):
        assert steps[(e + 1) * per - 1][2] <= end[1] + EPS
        if e + 1 < EPOCHS:
            assert end[2] <= steps[(e + 1) * per][1] + EPS
        assert not any(_inside(end, st) for st in steps)


def test_streaming_runner_gives_the_same_tree(tmp_path):
    cpl = _model()
    runner = make_streaming_runner(cpl.cfg, cpl.tcfg, cpl.tx, N_TRAIN,
                                   device="cpu")
    x = _data(N_TRAIN)
    _, spans = _profiled(tmp_path, lambda: runner(EPOCHS)(
        cpl.state, x, None, cpl.temp))
    names = [s[0] for s in spans]
    steps = EPOCHS * N_TRAIN // B
    assert names.count("runner") == 1
    assert names.count("runner.epoch_end") == EPOCHS
    for sub in ("step", "step.forward", "step.backward", "step.update"):
        assert names.count(sub) == steps


def test_losses_and_parameters_bitwise_with_the_profiler_on(tmp_path):
    x = torch.from_numpy(_data(N_TRAIN, seed=3))
    off, on = _model(seed=11), _model(seed=11)
    ems_off = _run_chunk(off, x)
    ems_on, _ = _profiled(tmp_path, lambda: _run_chunk(on, x))
    for a, b in zip(ems_off, ems_on):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(off.state.params),
                    tree_leaves(on.state.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(off.state.opt_state.mu),
                    tree_leaves(on.state.opt_state.mu)):
        assert torch.equal(a, b)


def test_train_orchestrates_runner_validate_and_checkpoint(tmp_path):
    cpl = _model(folder=str(tmp_path / "run"))
    xt, xv = _data(N_TRAIN), _data(2 * B + 3, seed=1)
    _, spans = _profiled(tmp_path / "prof", lambda: cpl.train(
        xt, xv, n_epoch=2 * EPOCHS, save_plots=False))
    names = [s[0] for s in spans]
    assert names.count("runner") == 2
    assert names.count("step") == 2 * EPOCHS * N_TRAIN // B
    assert names.count("validate") == 2
    assert names.count("checkpoint") >= 3   # epoch_ and best_ and final
    for v in _named(spans, "validate"):
        assert not any(_inside(v, r) for r in _named(spans, "runner"))


# ---------------------------------------------------------------------------
# eval: validate, eval_model, _predict_labels; checkpoints
# ---------------------------------------------------------------------------

def _assert_eval_tree(spans, top, n_batches, n_drains):
    """One ``top`` span holding ``n_batches`` batches, then ``n_drains``
    drains (none inside a batch), then one finish after the last drain."""
    (call,) = _named(spans, top)
    batches = _named(spans, "eval.batch")
    drains = _named(spans, "eval.drain")
    (finish,) = _named(spans, "eval.finish")
    assert len(batches) == n_batches and len(drains) == n_drains
    assert all(_inside(s, call) for s in spans if s is not call)
    assert not any(_inside(d, b) for d in drains for b in batches)
    assert drains[-1][1] >= batches[-1][2] - EPS
    assert finish[1] >= drains[-1][2] - EPS


def test_validate_span_tree(tmp_path):
    cpl = _model()
    x = _data(N_EVAL)
    _, spans = _profiled(tmp_path, lambda: cpl.validate(x, batch_size=B))
    _assert_eval_tree(spans, "validate", n_batches=2, n_drains=1)


def test_eval_model_span_tree_with_a_leftover_batch(tmp_path):
    cpl = _model()
    x = _data(N_EVAL)
    _, spans = _profiled(tmp_path, lambda: cpl.eval_model(x, batch_size=B))
    _assert_eval_tree(spans, "eval", n_batches=2, n_drains=1)


def test_eval_model_span_tree_with_a_drain_mid_run(tmp_path, monkeypatch):
    monkeypatch.setattr(cm, "_EVAL_FLUSH_BYTES", 1)
    cpl = _model()
    x = _data(B + 5)     # two batches, each drained as it is done
    _, spans = _profiled(tmp_path, lambda: cpl.eval_model(x, batch_size=B))
    _assert_eval_tree(spans, "eval", n_batches=2, n_drains=3)
    batches, drains = _named(spans, "eval.batch"), _named(spans, "eval.drain")
    assert batches[0][2] <= drains[0][1] + EPS <= batches[1][1] + 2 * EPS


def test_predict_labels_span_tree(tmp_path):
    cpl = _model()
    x = _data(N_EVAL)
    labels, spans = _profiled(tmp_path, lambda: cpl._predict_labels(
        x, cpl.temp, batch_size=B))
    assert labels.shape == (A, N_EVAL)
    names = [s[0] for s in spans]
    assert names.count("eval.batch") == 2 and names.count("eval.drain") == 1
    assert set(names) == {"eval.batch", "eval.drain"}


def test_save_checkpoint_span(tmp_path):
    cpl = _model(folder=str(tmp_path / "run"))
    path, spans = _profiled(tmp_path / "prof",
                            lambda: cpl.save_checkpoint("traced"))
    assert os.path.exists(path)
    assert [s[0] for s in spans] == ["checkpoint"]


def test_eval_model_fields_bitwise_with_the_profiler_on(tmp_path,
                                                       monkeypatch):
    cpl = _model(seed=5)
    x = _data(N_EVAL, seed=2)
    off = cpl.eval_model(x, batch_size=B)
    on, _ = _profiled(tmp_path / "a", lambda: cpl.eval_model(
        x, batch_size=B))
    monkeypatch.setattr(cm, "_EVAL_FLUSH_BYTES", 1)
    mid, _ = _profiled(tmp_path / "b", lambda: cpl.eval_model(
        x, batch_size=B))
    assert list(on) == list(off) == list(mid) == [
        "c_prob", "state_mu", "state_logvar", "x_low", "pred_label",
        "total_loss", "total_loss_rec", "consensus", "mask"]
    for k in off:
        a, b, c = (np.asarray(r[k]) for r in (off, on, mid))
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes() == c.tobytes(), k


def test_validate_bitwise_with_the_profiler_on(tmp_path):
    cpl = _model(seed=5)
    x = _data(N_EVAL, seed=2)
    off = cpl.validate(x, batch_size=B)
    on, _ = _profiled(tmp_path, lambda: cpl.validate(x, batch_size=B))
    assert list(on) == list(off)
    for k in off:
        assert np.float64(on[k]).tobytes() == np.float64(off[k]).tobytes()


@pytest.mark.parametrize("surface", ["eval_model", "validate",
                                     "_predict_labels"])
def test_every_read_of_results_lies_in_a_drain(surface, monkeypatch):
    """Each ``Tensor.cpu`` of an eval surface is called inside
    ``dvae.eval.drain`` (a drain mid-run included), none in a batch or in
    the finish."""
    monkeypatch.setattr(cm, "_EVAL_FLUSH_BYTES", 1)
    stack, seen = [], []

    class Recorder:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            stack.append(self.name)

        def __exit__(self, *exc):
            stack.pop()

    cpu = torch.Tensor.cpu

    def watched(self, *a, **k):
        seen.append(tuple(stack))
        return cpu(self, *a, **k)

    monkeypatch.setattr(cm, "span", Recorder)
    monkeypatch.setattr(torch.Tensor, "cpu", watched)
    cpl = _model()
    x = _data(N_EVAL)
    if surface == "_predict_labels":
        cpl._predict_labels(x, cpl.temp, batch_size=B)
    else:
        getattr(cpl, surface)(x, batch_size=B)
    assert seen
    assert all(s and s[-1] == "eval.drain" for s in seen), seen
