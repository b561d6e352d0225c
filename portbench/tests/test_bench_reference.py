"""The plain reference at a tiny width: its gradients against autograd in
float64 and against finite differences, its Philox mask against the numpy
twin and the program's own, its draws against the program's runner."""

import copy

import numpy as np
import pytest
import torch

from portbench.core import data, spec
from portbench.core.weights import make_params
from portbench.reference import model as ref
from portbench.reference import philox
from portbench.reference.draws import RunnerDraws


def _tiny(mode):
    m = copy.deepcopy(spec.config(f"mmidas-ss-a5-{mode.lower()}")["model"])
    m.update(input_dim=12, fc_dim=6, n_categories=4, n_arm=3, lowD_dim=3)
    return m


def _inputs(m, dtype, B=9, seed=3):
    kind = "log1p" if m["mode"] == "ZINB" else "logcpm"
    x = data.make(B, m["input_dim"], seed, kind, "cpu").to(dtype)
    w = {n: {k: v.to(dtype) for k, v in layer.items()}
         for n, layer in make_params(m, seed + 1, "cpu").items()}
    g = torch.Generator().manual_seed(seed + 2)
    A, D, C, S = m["n_arm"], m["input_dim"], m["n_categories"], m["state_dim"]
    noise = {"x_keep": torch.rand((A, B, D), generator=g) < 0.5,
             "u": torch.rand((A, B, C), generator=g).to(dtype),
             "e": torch.randn((A, B, S), generator=g).to(dtype),
             "s_keep": torch.rand((A, B, S), generator=g) < 0.8}
    return x, w, noise


@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_f32_gradients_against_f64_autograd(mode):
    m = _tiny(mode)
    x32, w32, n32 = _inputs(m, torch.float32)
    x64, w64, n64 = _inputs(m, torch.float64)
    l32, g32 = ref.value_and_grads(w32, x32, m, n32)
    l64, g64 = ref.value_and_grads(w64, x64, m, n64)
    assert float(l32) == pytest.approx(float(l64), rel=1e-5)
    for k in g64:
        scale = max(float(g64[k].abs().max()), 1e-6)
        assert float((g32[k].double() - g64[k]).abs().max()) <= 1e-3 * scale, k


@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_gradients_against_finite_differences(mode):
    m = _tiny(mode)
    m["tau"] = 0.5    # a smooth posterior keeps central differences exact
    x, w, noise = _inputs(m, torch.float64)
    _, grads = ref.value_and_grads(w, x, m, noise)
    rng = np.random.default_rng(0)
    for (name, leaf) in [("fc1", "w"), ("fc5", "b"), ("fcc", "w"),
                         ("fc_mu", "w"), ("fc7", "w"), ("fc11", "w")]:
        t = w[name][leaf]
        for _ in range(3):
            idx = tuple(int(rng.integers(0, s)) for s in t.shape)
            h = 1e-6 * max(1.0, abs(float(t[idx])))
            t[idx] += h
            up = float(ref.loss(ref.forward(w, x, m, True, noise), x,
                                m)["total"])
            t[idx] -= 2 * h
            dn = float(ref.loss(ref.forward(w, x, m, True, noise), x,
                                m)["total"])
            t[idx] += h
            fd = (up - dn) / (2 * h)
            assert float(grads[(name, leaf)][idx]) == pytest.approx(
                fd, rel=1e-4, abs=1e-6), (name, leaf, idx)


def test_adam_matches_the_textbook_update():
    p = {"fc": {"w": torch.tensor([[1.0, -2.0]])}}
    st = ref.adam_init(p)
    g = {("fc", "w"): torch.tensor([[0.5, -0.25]])}
    ref.adam_step(p, g, st, lr=0.1)
    # first step: m̂ = g, v̂ = g², update lr·g/(|g| + eps)
    assert torch.allclose(p["fc"]["w"], torch.tensor([[0.9, -1.9]]),
                          atol=1e-6)


@pytest.mark.parametrize("seed", [0, 123456789, 2 ** 31 - 2, 3 ** 20])
def test_philox_mask_three_ways(seed):
    from dvae_tpu_torch.ops.encoder import philox_keep_mask
    shape = (3, 17, 37)
    a = philox.keep_mask(seed, shape, 0.5, "cpu").numpy()
    assert np.array_equal(a, philox.keep_mask_numpy(seed, shape, 0.5))
    assert np.array_equal(a, philox_keep_mask(seed, shape, 0.5))
    assert 0.4 < a.mean() < 0.6


def test_runner_draws_match_the_program_on_the_cpu():
    """The reference's plan and noise of one runner call are the ones the
    program's runner drew: one step of the program and of the reference
    from the same weights give the same loss and gradients."""
    from dvae_tpu_torch.train.step import make_epoch_runner

    from portbench.core import program
    from portbench.core.weights import load_into
    from portbench.tests.conftest import tiny
    _, cfg = tiny("mse-train-20k")
    m, B = cfg["model"], cfg["train"]["batch_size"]
    x = data.make(B, m["input_dim"], 5, "logcpm", "cpu")
    w = make_params(m, 6, "cpu")
    tr = program.build(cfg, "cpu", 77)
    load_into(tr.state.params, w)
    run = make_epoch_runner(tr.cfg, tr.tcfg, tr.tx, B, epochs_per_chunk=1)
    st, ems = run(tr.state, x, None, tr.temp)
    dr = RunnerDraws(77, 0, "cpu", B, B, m)
    xb = x.index_select(0, dr.epoch_plan()[0])
    total, grads = ref.value_and_grads(w, xb, m, dr.step_noise())
    assert float(ems.total[0]) == pytest.approx(float(total), rel=1e-5)
    mu = program.leaves(st.opt_state.mu)
    for k, g in grads.items():
        scale = max(float(g.abs().max()), 1e-12)
        assert float((mu[k] / 0.1 - g).abs().max()) <= 1e-3 * scale, k
