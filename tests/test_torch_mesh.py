"""Training and serving on a mesh of one process per device, on the CPU.

An 8-rank (2, 2, 2) gloo world (``tests/_torch_dist_worker.py``, one
spawn with its own time limit that kills its ranks on expiry) runs every
case below once; the test process holds its outputs to the JAX package
and to the port's one-process path.  Widths are those of
tests/test_sharding.py:21-23 (A=2 arms, one a rank of the arm axis, C=8,
D=64, F=16, L=8, S=2, tau=0.1, lam=1), B=32 (8 rows a rank).

* The mesh epoch against JAX's mesh epoch runner (``make_epoch_runner``
  on the 8-device mesh, ``full``), MSE and ZINB, fused and plain: the
  port's mesh steps run JAX's epoch (its permutation, rebuilt from the
  runner's key, and every draw of each step, rebuilt from the step's key,
  whole (A, B, ·) tensors that each rank slices); the epoch's loss at
  rtol 5e-4, JAX's own multi- versus single-device tolerance
  (tests/test_sharding.py:214).
* The same steps against the port's one-process steps on the same
  noise: losses rtol 1e-5, parameters atol 1e-6 after 2 steps; also under
  ``use_pallas`` (the Gumbel sample on the gathered posterior) and with 3
  arms, which the arm axis does not divide (every rank computes every
  arm).  ``local_bn_stats`` (``bn_groups`` = 4, one block a rank) against
  one device with ``bn_groups=4`` (tests/test_local_bn.py:66): losses
  rtol 1e-5 and the running statistics.
* The six strategies from one state on one noise: losses equal at rtol
  1e-5 (tests/test_sharding.py:59-77).
* ``align_state`` under ``full`` (the category axis of fcc is the fsdp-
  sharded one) equal to one device's, parameters and moments bit for bit.
* The eval step: a 39-row batch, which the batch axes cannot divide, is
  evaluated whole on every rank through the fused ops and equals the
  unfused one, as JAX's fallback does (tests/test_sharding.py:328-346);
  both equal one device.
* ``CplMixVAE`` on the mesh: a trained, checkpointed model loads on one
  device bit for bit and labels as the mesh did; its first epoch's loss
  is the one-process trainer's.
* Each rank's streamed batches are its rows of the one-process streamer's.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dvae_tpu.config as jcfg
from dvae_tpu.ops import encoder_pallas
from dvae_tpu.parallel.sharding import (make_mesh, replicated,
                                        strategy_shardings)
from dvae_tpu.train import step as jstep

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.data.anndata_io import synthetic_dataset
from dvae_tpu_torch.data.stream import BatchStreamer
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.train import alignment as talign
from dvae_tpu_torch.train import step as tstep
from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
from dvae_tpu_torch.utils import checkpoint as tckpt

import _torch_dist_worker as worker

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

DIMS = dict(n_categories=8, input_dim=64, fc_dim=16, lowD_dim=8,
            state_dim=2, n_arm=2, tau=0.1)
MESH = [2, 2, 2]
B, N, STEPS = 32, 64, 2
JAX_CASES = {
    "mse_plain": {},
    "mse_fused": dict(fused_recon=True, fused_encoder=True),
    "zinb_plain": dict(mode="ZINB"),
    "zinb_fused": dict(mode="ZINB", fused_recon=True, fused_encoder=True),
}
PORT_CASES = {
    "pallas": dict(fused_recon=True, fused_encoder=True, use_pallas=True),
    "bn4": dict(fused_recon=True, fused_encoder=True, bn_groups=4),
    "arm3": dict(fused_recon=True, fused_encoder=True, n_arm=3),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noise(key, cfg, n_rows):
    """The random numbers JAX's train-mode apply draws from ``key``
    (dvae_tpu/models/mixvae.py:336-423), whole (A, B, ·)."""
    A, D, C, S = cfg.n_arm, cfg.input_dim, cfg.n_categories, cfg.state_dim
    k_gumbel, k_rest = jax.random.split(key)
    arm_keys = jax.random.split(k_rest, (A, 3))
    if cfg.fused_encoder:
        seed = jax.random.bits(jax.random.fold_in(k_gumbel, 1),
                               dtype=jnp.uint32).astype(jnp.int32)
        x_mask = encoder_pallas.dropout_mask_host(seed, (A, n_rows, D),
                                                  cfg.x_drop)
    else:
        x_mask = jnp.stack([jax.random.bernoulli(
            arm_keys[a, 0], 1 - cfg.x_drop, (n_rows, D)) for a in range(A)])
    u = jax.random.uniform(k_gumbel, (A, n_rows, C))
    e = jnp.stack([jax.random.normal(arm_keys[a, 1], (n_rows, S))
                   for a in range(A)])
    s_mask = jnp.stack([jax.random.bernoulli(
        arm_keys[a, 2], 1 - cfg.s_drop, (n_rows, S)) for a in range(A)])
    return {k: np.array(v) for k, v in (("x_mask", x_mask), ("gumbel_u", u),
                                        ("reparam_e", e), ("s_mask", s_mask))}


def _data(n=N, seed=0):
    return synthetic_dataset(n_cells=n, n_genes=DIMS["input_dim"],
                             n_types=DIMS["n_categories"], seed=seed).log1p


def _tree_np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax_epoch(name, kw, x_all, inputs):
    """JAX's mesh epoch runner for one epoch (``full``), and its
    permutation and per-step draws rebuilt from its keys into
    ``inputs``; returns JAX's epoch loss."""
    jc = jcfg.VAEConfig(**{**DIMS, **kw})
    tx = jstep.make_optimizer(jc)
    state = jstep.init_train_state(jax.random.key(len(name)), jc, tx)
    worker.flat(f"{name}/params", _tree_np(state.params), inputs)
    worker.flat(f"{name}/bn", _tree_np(state.bn), inputs)
    key, k_perm = jax.random.split(state.key)
    plan = np.array(jax.random.permutation(k_perm, N)).reshape(STEPS, B)
    xs, noise = [], []
    for s in range(STEPS):
        key, _, k_fwd = jax.random.split(key, 3)
        xs.append(x_all[plan[s]])
        noise.append(_noise(k_fwd, jc, B))
    inputs[f"{name}/x"] = np.stack(xs)
    for k in noise[0]:
        inputs[f"{name}/noise/{k}"] = np.stack([n[k] for n in noise])
    mesh = make_mesh(jcfg.MeshConfig(*MESH))
    tc = jcfg.TrainConfig(batch_size=B, epochs_per_jit=1,
                          mesh=jcfg.MeshConfig(*MESH),
                          sharding=jcfg.ShardingStrategy.FULL_SHARD)
    shs = strategy_shardings(tc.sharding, mesh, state.params, state.bn,
                             state.opt_state)
    state = state._replace(params=jax.device_put(state.params, shs[0]),
                           bn=jax.device_put(state.bn, shs[1]),
                           opt_state=jax.device_put(state.opt_state, shs[2]))
    run = jax.jit(jstep.make_epoch_runner(jc, tc, tx, n_train=N, mesh=mesh))
    _, ems = run(state, jax.device_put(jnp.asarray(x_all), replicated(mesh)),
                 None, 1.0)
    return float(np.asarray(ems.total)[0])


def _port_inputs(name, kw, x_all, inputs):
    """Weights, batches and whole draws for a case the port alone runs."""
    jc = jcfg.VAEConfig(**{**DIMS, **kw})
    state = jstep.init_train_state(jax.random.key(len(name)), jc,
                                   jstep.make_optimizer(jc))
    worker.flat(f"{name}/params", _tree_np(state.params), inputs)
    worker.flat(f"{name}/bn", _tree_np(state.bn), inputs)
    r = np.random.default_rng(len(name))
    inputs[f"{name}/x"] = np.stack([x_all[r.permutation(N)[:B]]
                                    for _ in range(STEPS)])
    noise = [_noise(jax.random.key(100 + s), jc, B) for s in range(STEPS)]
    for k in noise[0]:
        inputs[f"{name}/noise/{k}"] = np.stack([n[k] for n in noise])


def _one_process(name, cfg_kw, inputs):
    """The port's one-process steps on a case's weights, batches and draws:
    (losses, whole parameters)."""
    cfg = tcfg_mod.VAEConfig(**{**DIMS, **cfg_kw})
    tc = tcfg_mod.TrainConfig(batch_size=B)
    opt = tstep.make_optimizer(cfg)
    params = tckpt.params_from_jax(worker.unflat(f"{name}/params", inputs))
    st = tstep.TrainState(
        params, tckpt.bn_from_jax(worker.unflat(f"{name}/bn", inputs)),
        torch.ones(cfg.n_categories), 0, 0, opt.init(params))
    step = tstep.make_train_step(cfg, tc, opt)
    totals = []
    for i in range(STEPS):
        noise = tmixvae.Noise(*(torch.from_numpy(
            inputs[f"{name}/noise/{k}"][i]) for k in (
                "x_mask", "gumbel_u", "reparam_e", "s_mask")))
        st, m, _ = step(st, torch.from_numpy(inputs[f"{name}/x"][i]), None,
                        1.0, noise=noise)
        totals.append(float(m.total))
    return np.array(totals), st


def _trainer_kw():
    return dict(**DIMS, batch_size=B, epochs_per_jit=1, fused=True,
                x_drop=0.0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_world")
    x_all = _data()
    inputs, want = {}, {}
    train = []
    for name, kw in JAX_CASES.items():
        want[name] = _jax_epoch(name, kw, x_all, inputs)
        train.append(dict(name=name, prefix=name, cfg={**DIMS, **kw},
                          tcfg=dict(batch_size=B, sharding="full"),
                          mesh=MESH, steps=STEPS))
    for name, kw in PORT_CASES.items():
        _port_inputs(name, kw, x_all, inputs)
        train.append(dict(name=name, prefix=name, cfg={**DIMS, **kw},
                          tcfg=dict(batch_size=B, sharding="full"),
                          mesh=MESH, steps=STEPS))
    # alignment: a state with moments, labels that move categories
    r = np.random.default_rng(7)
    jc = jcfg.VAEConfig(**DIMS)
    st = jstep.init_train_state(jax.random.key(9), jc,
                                jstep.make_optimizer(jc))
    p = _tree_np(st.params)
    worker.flat("align/params", p, inputs)
    worker.flat("align/bn", _tree_np(st.bn), inputs)
    for k in ("mu", "nu"):
        worker.flat(f"align/{k}", jax.tree_util.tree_map(
            lambda a: r.random(a.shape, dtype=np.float32), p), inputs)
    inputs["align/labels"] = r.integers(0, DIMS["n_categories"],
                                        (DIMS["n_arm"], 200))
    worker.flat("eval/params", p, inputs)
    worker.flat("eval/bn", _tree_np(st.bn), inputs)
    inputs["eval/odd"] = _data(39, seed=1)
    inputs["eval/even"] = _data(32, seed=2)
    inputs["trainer/x"] = x_all
    inputs["trainer/x_eval"] = _data(70, seed=3)
    inputs["stream/x"] = _data(N, seed=4)
    inputs["stream/prior"] = r.random((N, DIMS["n_categories"]),
                                      dtype=np.float32)
    cases = {
        "train": train,
        "strategies": dict(prefix="mse_fused",
                           cfg={**DIMS, **JAX_CASES["mse_fused"]},
                           tcfg=dict(batch_size=B), mesh=MESH, steps=STEPS),
        "align": dict(cfg=DIMS, tcfg=dict(batch_size=B, sharding="full"),
                      mesh=MESH),
        "eval": dict(cfg=DIMS, tcfg=dict(batch_size=B, sharding="full"),
                     mesh=MESH),
        "trainer": dict(folder=str(d / "trainer"),
                        init={**_trainer_kw(), "sharding": "full"},
                        mesh=MESH, n_epoch=2, eval_batch=B),
        "stream": dict(batch=B, seed=3),
    }
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(cases))
    outs = worker.spawn_world(
        str(d), 8, MESH, ["train", "strategies", "align", "eval", "trainer",
                          "stream"], timeout=300)
    return dict(inputs=inputs, want=want, outs=outs, dir=d)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_mesh_epoch_matches_jax_mesh_epoch(world, name):
    for o in world["outs"]:
        got = float(np.mean(o[f"train/{name}/total"]))
        np.testing.assert_allclose(got, world["want"][name], rtol=5e-4)


def _check_one_process(world, name, params: bool):
    kw = {**JAX_CASES, **PORT_CASES}[name]
    totals, st = _one_process(name, kw, world["inputs"])
    for o in world["outs"]:
        np.testing.assert_allclose(o[f"train/{name}/total"], totals,
                                   rtol=1e-5)
        bn = worker.unflat(f"train/{name}/bn", o)
        for layer in st.bn:
            for leaf, v in st.bn[layer].items():
                np.testing.assert_allclose(bn[layer][leaf], v.numpy(),
                                           rtol=1e-5, atol=1e-6)
        if not params:
            continue
        got = worker.unflat(f"train/{name}/params", o)
        for layer in st.params:
            for leaf, v in st.params[layer].items():
                np.testing.assert_allclose(got[layer][leaf], v.numpy(),
                                           rtol=0, atol=1e-6,
                                           err_msg=f"{layer}.{leaf}")


@pytest.mark.parametrize("name", list(JAX_CASES) + ["pallas"])
def test_mesh_steps_equal_the_one_process_steps(world, name):
    _check_one_process(world, name, params=True)


# Where a gradient entry lies within f32 rounding of zero (the sums over 8
# rows a rank, then over 4 ranks, against one sum over 32 rows), Adam's
# first update, about lr·sign(g), moves that weight differently in the two
# runs (tests/test_torch_train.py's TRAJ note): in these two cases 2 of
# 2048 fc1 weights moved 6.6e-5 apart (bn4) and 1 of 240 fc6 weights
# 1.03e-6 apart (arm3).  Their losses and running statistics are held.

def test_local_bn_stats_on_the_mesh_equal_one_device(world):
    """``bn_groups`` = 4 on the batch axes' 4 ranks: each rank normalises
    its 8 rows alone, as one device normalises each 8-row block; the
    losses and the running statistics (averaged over the batch group)
    equal one device's, as tests/test_local_bn.py:66-101 holds JAX's
    losses."""
    _check_one_process(world, "bn4", params=False)


def test_arms_the_arm_axis_does_not_divide_train_on_every_rank(world):
    """3 arms on an arm axis of 2: every rank computes every arm of its
    rows; the losses and running statistics equal one device's."""
    _check_one_process(world, "arm3", params=False)


def test_six_strategies_give_one_loss(world):
    outs = world["outs"]
    base = outs[0]["strategies/ddp/total"]
    for o in outs:
        for s in tcfg_mod.ShardingStrategy:
            np.testing.assert_allclose(o[f"strategies/{s.value}/total"],
                                       base, rtol=1e-5, err_msg=s.value)
    p0 = worker.unflat("strategies/ddp/params", outs[0])
    for s in tcfg_mod.ShardingStrategy:
        p = worker.unflat(f"strategies/{s.value}/params", outs[0])
        for layer in p0:
            for leaf in p0[layer]:
                np.testing.assert_allclose(p[layer][leaf], p0[layer][leaf],
                                           rtol=0, atol=1e-6)


def test_alignment_on_a_full_mesh_equals_one_device(world):
    inp = world["inputs"]
    cfg = tcfg_mod.VAEConfig(**DIMS)
    params = tckpt.params_from_jax(worker.unflat("align/params", inp))
    opt_state = tstep.AdamState(
        3, tckpt.params_from_jax(worker.unflat("align/mu", inp)),
        tckpt.params_from_jax(worker.unflat("align/nu", inp)))
    st = tstep.TrainState(params, None, torch.ones(8), 0, 0, opt_state)
    st, m, moved = talign.align_state(st, inp["align/labels"], cfg)
    assert moved > 0
    for o in world["outs"]:
        np.testing.assert_array_equal(o["align/m"], m)
        assert int(o["align/moved"][0]) == moved
        for key, tree in (("params", st.params), ("mu", st.opt_state.mu),
                          ("nu", st.opt_state.nu)):
            got = worker.unflat(f"align/{key}", o)
            for layer in tree:
                for leaf, v in tree[layer].items():
                    np.testing.assert_array_equal(got[layer][leaf],
                                                  v.numpy())


def test_eval_fallback_equals_unfused_and_one_device(world):
    inp = world["inputs"]
    cfg = tcfg_mod.VAEConfig(**DIMS)
    tc = tcfg_mod.TrainConfig(batch_size=B)
    params = tckpt.params_from_jax(worker.unflat("eval/params", inp))
    st = tstep.TrainState(params,
                          tckpt.bn_from_jax(worker.unflat("eval/bn", inp)),
                          torch.ones(8), 7, 0, None)
    for name in ("odd", "even"):
        aux, lab, outs = tstep.make_eval_step(cfg, tc)(
            st, torch.from_numpy(inp[f"eval/{name}"]), None, 1.0)
        for o in world["outs"]:
            for kind in ("fused", "plain"):
                key = f"eval/{name}/{kind}"
                np.testing.assert_allclose(o[key + "/total"][0],
                                           float(aux.total), rtol=1e-5)
                np.testing.assert_allclose(o[key + "/loss_rec"],
                                           aux.loss_rec.numpy(), rtol=1e-5)
                np.testing.assert_array_equal(o[key + "/labels"],
                                              lab.numpy())
                np.testing.assert_allclose(o[key + "/c"], outs.c.numpy(),
                                           rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(o[key + "/s_mean"],
                                           outs.s_mean.numpy(), rtol=1e-5,
                                           atol=1e-6)
            np.testing.assert_allclose(o[f"eval/{name}/fused/total"],
                                       o[f"eval/{name}/plain/total"],
                                       rtol=1e-5)


def test_mesh_checkpoint_loads_on_one_device(world):
    o0 = world["outs"][0]
    path = str(o0["trainer/path"][0])
    assert os.path.basename(path) == "cpl_mixVAE_model_epoch_2.ckpt"
    for o in world["outs"]:  # one file, written once, named on every rank
        assert str(o["trainer/path"][0]) == path
        np.testing.assert_array_equal(o["trainer/labels"],
                                      o0["trainer/labels"])
    cpl = CplMixVAE(device="cpu")
    assert cpl.load_model(path) == 2
    assert cpl.mesh is None and cpl.tcfg.mesh == tcfg_mod.MeshConfig()
    got = worker.unflat("trainer/params", o0)
    for layer, leaves in cpl.state.params.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(v.numpy(), got[layer][leaf])
    mu = worker.unflat("trainer/mu", o0)
    for layer, leaves in cpl.state.opt_state.mu.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(v.numpy(), mu[layer][leaf])
    res = cpl.eval_model(world["inputs"]["trainer/x_eval"], batch_size=B)
    agree = np.mean(res["pred_label"] == o0["trainer/labels"])
    assert agree >= 0.999
    np.testing.assert_allclose(res["c_prob"], o0["trainer/c_prob"],
                               rtol=1e-4, atol=1e-6)


def test_mesh_trainer_logs_the_one_process_losses(world, tmp_path):
    """The first epoch's loss equals the one-process trainer's (the same
    plan and noise chain from the same state); the second epoch runs on
    both, after Adam's sign noise (see above) has moved a few weights
    (measured 1.0e-3 apart in the second epoch's loss)."""
    one = CplMixVAE(saving_folder=str(tmp_path), device="cpu", seed=5)
    one.init_model(**_trainer_kw(), sharding="full")
    one.train(world["inputs"]["trainer/x"], n_epoch=2, save_plots=False,
              early_stop_consensus=0)

    def losses(folder):
        with open(os.path.join(folder, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        return [r["train/loss"] for r in rows if "train/loss" in r]
    mesh, single = losses(world["dir"] / "trainer"), losses(tmp_path)
    assert len(mesh) == len(single) == 2 and np.isfinite(mesh).all()
    np.testing.assert_allclose(mesh[0], single[0], rtol=1e-5)


def test_each_rank_streams_its_rows_of_the_one_process_batches(world):
    inp = world["inputs"]
    one = BatchStreamer(torch.from_numpy(inp["stream/x"]), B,
                        prior=inp["stream/prior"], seed=3, device="cpu")
    k = B // 4
    for r, o in enumerate(world["outs"]):
        assert int(o["stream/rows_local"][0]) == 1
        d, rest = divmod(r, 4)
        i = d * 2 + rest % 2   # batch-shard index d·fsdp + f
        for e in range(2):
            for s, b in enumerate(one.epoch(e)):
                np.testing.assert_array_equal(
                    o[f"stream/{e}/{s}/x"], b.x[i * k:(i + 1) * k].numpy())
                np.testing.assert_array_equal(
                    o[f"stream/{e}/{s}/prior"],
                    b.prior[i * k:(i + 1) * k].numpy())
