"""MMIDAS trained with its frozen augmenter, as the benchmark's cell
``mse-train-aug`` runs it, at a small size on the CPU.

(a) ``augment/augmenter.augment_arms`` (its trunk run once and broadcast)
against the plain reference augmenter (``portbench/reference/augmenter``,
the trunk on every arm's copy) on the same z and e; (b) three steps of the
port's augmented runner, built through ``CplMixVAE(aug_file=…)`` with the
trainer's own closure, against the reference's steps on per-arm views:
losses, first gradient, the parameters' change and the first views; (c)
under the CPU profiler ``dvae.step.augment`` holds the augmenter's
fourteen products and nothing of the VAE, ``dvae.eval.augment`` the
validation's, and without an augmenter neither span is opened; (d) the
benchmark gives its eleven metrics to ``mse-train-aug`` and to no
other cell.
"""

import copy
import glob
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dvae_tpu_torch.augment.augmenter import (AugmenterConfig,  # noqa: E402
                                              AugNoise, augment_arms,
                                              save_augmenter)
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE  # noqa: E402
from dvae_tpu_torch.train.step import make_epoch_runner  # noqa: E402
from dvae_tpu_torch.utils import profiling as tprof  # noqa: E402
from portbench.core import data, harness, spec  # noqa: E402
from portbench.reference import augmenter as aug_ref  # noqa: E402

CELL = "mse-train-aug"
AUG = dict(input_dim=64, n_dim=20, noise_dim=6, latent_dim=4, p_drop=0.5,
           n_zim=1, variant="smartseq")
A, B = 3, 32
NEW = ["augment_roofline.train.aug", "augment_share.train.aug",
       "train_mfu.aug", "launches_per_step.train.aug",
       "device_idle.train.aug", "encoder_roofline.train.aug",
       "recon_roofline.train.aug", "validate_share.train.aug",
       "idle_in_validate.train.aug", "step_host_ms.train.aug",
       "idle_in_step.train.aug"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _augmenter(seed, n=96, scale=0.1):
    """(x, params, running statistics) of the small augmenter, seeded."""
    x = data.make(n, AUG["input_dim"], seed, "logcpm", "cpu")
    params = aug_ref.make_params(AUG, seed + 1, "cpu")
    return x, params, aug_ref.calibrate(params, x, AUG, scale, seed + 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_augment_arms_against_the_reference(seed, scale):
    x, params, bn = _augmenter(seed, scale=scale)
    xb = x[:B]
    g = torch.Generator().manual_seed(seed + 3)
    z = torch.randn((A, B, AUG["noise_dim"]), generator=g)
    e = torch.randn((A, B, AUG["latent_dim"]), generator=g)
    got = augment_arms(params, bn, AugmenterConfig(**AUG), xb, A, scale,
                       draws=AugNoise(z=z, e=e))
    want = aug_ref.views(params, bn, xb, A, z, e, scale)
    assert got.shape == want.shape == (A, B, AUG["input_dim"])
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5
    # the arms' views differ: each arm has its own noise
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_calibrated_batch_norms_normalise_their_inputs():
    x, params, bn = _augmenter(4, n=400)
    h = x
    for fc, norm in aug_ref.TRUNK:
        y = aug_ref.batch_norm(aug_ref.linear(params[fc], h), bn[norm])
        assert float(y.mean(0).abs().max()) < 1e-4
        assert float((y.var(0, unbiased=False) - 1).abs().max()) < 1e-3
        h = torch.relu(y)


def _tiny(seed):
    cell = copy.deepcopy(spec.workload(CELL))
    cfg = copy.deepcopy(spec.config(cell["config"]))
    cfg["model"].update(input_dim=AUG["input_dim"], fc_dim=16,
                        n_categories=7, n_arm=A)
    cfg["model"]["augmenter"].update(AUG)
    cfg["train"].update(batch_size=B, epochs_per_jit=2, eval_every=2)
    cell["params"].update(n_train=4 * B, n_val=40)
    return harness.Context(cell, cfg, seed, 0.0, False, torch.device("cpu"),
                           time.perf_counter())


@pytest.mark.parametrize("seed", [2 ** 40 + 7, 12345])
def test_three_augmented_steps_against_the_reference(seed):
    ctx = _tiny(seed)
    mod = spec.traffic("train_resident_aug")
    s = mod.setup(ctx)
    assert s["trainer"]._aug_loaded is not None   # through aug_file
    want = mod.follow(s, ctx.model, seed, B, 3, ctx.train["aug_noise"],
                      ctx.device)
    got = mod.numbers(s["prog"], want)
    # at these widths a few dead categories carry the coupling term, so the
    # loss and the gradients agree to ~1e-4 (portbench/tests/conftest.py)
    assert got["loss1"] <= 1e-3 and got["loss"] <= 1e-3
    assert got["grad"] <= 1e-2 and got["grad_diff_median"] <= 1e-3
    assert got["change"] <= 0.05
    assert got["views"] <= 1e-5
    assert s["prog"]["views"].shape == (A, B, AUG["input_dim"])


def _spans_and_ops(trace_dir):
    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"][len(tprof.SPAN_PREFIX):], float(e["ts"]),
              float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(tprof.SPAN_PREFIX)]
    ops = [(e["name"], float(e["ts"])) for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    return spans, ops


def _profiled_chunk(tmp_path, with_augmenter):
    x, params, bn = _augmenter(9, n=3 * B + 10)
    aug_file = None
    if with_augmenter:
        aug_file = save_augmenter(str(tmp_path / "aug.ckpt"), params, bn,
                                  AugmenterConfig(**AUG))
    cpl = CplMixVAE(device="cpu", seed=3, aug_file=aug_file)
    cpl.init_model(n_arm=A, input_dim=AUG["input_dim"], fc_dim=16,
                   lowD_dim=8, n_categories=6, state_dim=2, batch_size=B,
                   epochs_per_jit=1)
    run = make_epoch_runner(cpl.cfg, cpl.tcfg, cpl.tx, 3 * B,
                            epochs_per_chunk=1, augment=cpl._augment_fn())
    trace_dir = str(tmp_path / "trace")
    with tprof.profile_run(trace_dir):
        cpl.state, _ = run(cpl.state, x[:3 * B], None, cpl.temp)
        cpl.validate(x[3 * B:], cpl.temp)
    return _spans_and_ops(trace_dir)


def _inside(ts, span):
    return span[1] <= ts <= span[2]


def test_augment_spans_hold_the_augmenters_products(tmp_path):
    spans, ops = _profiled_chunk(tmp_path, True)
    steps = [s for s in spans if s[0] == "step"]
    augs = [s for s in spans if s[0] == "step.augment"]
    assert len(steps) == 3 and len(augs) == 3
    for st, au in zip(steps, augs):
        assert st[1] <= au[1] and au[2] <= st[2]
        fwd = [s for s in spans if s[0] == "step.forward" and st[1] <= s[1]
               and s[2] <= st[2]]
        assert len(fwd) == 1 and au[2] <= fwd[0][1]
        # fc1–fc4, the noise layer, fc5, fc_mu, fc_sigma, fc6–fc11
        inside = [n for n, ts in ops if _inside(ts, au)]
        assert inside.count("aten::matmul") == 14
    (val,) = [s for s in spans if s[0] == "validate"]
    evals = [s for s in spans if s[0] == "eval.augment"]
    assert len(evals) == 1 and val[1] <= evals[0][1] <= evals[0][2] <= val[2]
    assert sum(n == "aten::matmul" for n, ts in ops
               if _inside(ts, evals[0])) == 14


def test_no_augment_span_without_an_augmenter(tmp_path):
    spans, _ = _profiled_chunk(tmp_path, False)
    names = {s[0] for s in spans}
    assert "step" in names and "validate" in names
    assert not names & {"step.augment", "eval.augment"}


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_go_to_the_augmented_cell_alone(name):
    bench = spec.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    assert CELL in cells
    for cell in cells:
        got = {m["name"] for m in spec.per_layer_for(bench, cell)}
        assert (name in got) == (cell == CELL), cell
    assert CELL in next(m for m in bench["end_to_end"]
                        if m["name"] == "train_cells_per_s")["workloads"]
