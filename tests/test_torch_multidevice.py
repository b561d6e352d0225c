"""The port's tools on several devices against the JAX package: the fit
``Trainer`` and the MNIST tutorial on a data-parallel group, the sweep,
the arm-parallelism study and sharded checkpoints.

In this process: ``mlp_shardings`` and the Trainer's
``_generic_shardings`` against JAX's ``PartitionSpec``s leaf for leaf;
``gen_configs``, ``load_results`` and ``summarize`` against JAX's; the arm
study's keys against JAX's and its loop against its stacked forward on
one set of draws (per-arm reconstruction and KL terms within 1e-5).

One 8-rank gloo world on the CPU (``tests/_torch_dist_worker.py``, mesh
(2, 2, 2)) runs the rest, against the JAX package on conftest's 8 virtual
devices, both from JAX's ``init_mlp`` weights carried across
(``tests/test_torch_fit.py``'s ``_both`` tolerances: losses rtol 1e-4,
parameters atol 1e-5):

* ``Trainer(devices=8)`` under full, ddp, grad-op and hybrid-zero2, with
  the unsharded sampler, and with a 5-row validation set (fewer rows than
  the span: evaluated whole on every rank);
* ``train_mnist_fsdp(n_devices=8)`` under full and ddp (test accuracies
  equal);
* ``run_sweep`` over full and ddp on the whole world and on its first 4
  ranks: one record a config, written by rank 0;
* the stacked forward on an ``arm=2`` mesh of the first two ranks equal
  to one process's within 1e-5;
* ``save_sharded`` of a trained ``full`` state on (2, 2, 2): restored to
  the same specs, the next chunk is bit for bit the original's and the
  metadata's epoch is kept (tests/_dcn_worker.py:95-120's check);
  restored onto ``no`` on (8, 1, 1), ``gather_state`` is bit for bit the
  saved state's; with ``offload_host`` moments the round trip is bit for
  bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.bench import sweep as jsweep
from dvae_tpu.config import ShardingStrategy as JStrategy, VAEConfig as JVAE
from dvae_tpu.examples import arm_parallelism as jarm
from dvae_tpu.examples import fsdp_tutorial as jt
from dvae_tpu.train import fit as jf

from dvae_tpu_torch.bench import sweep
from dvae_tpu_torch.config import ShardingStrategy, VAEConfig
from dvae_tpu_torch.examples import arm_parallelism as arm
from dvae_tpu_torch.examples import fsdp_tutorial as tt
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.parallel.runtime import Group
from dvae_tpu_torch.parallel.sharding import DPMesh
from dvae_tpu_torch.train import fit as tf

import _torch_dist_worker as worker
from test_torch_fit import (_CFG, _JCFG, ATOL_PARAM, KEYS, RTOL_LOSS,
                            _JaxCarried, _jax_weights)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

MESH = [2, 2, 2]
STRATEGIES = [s.value for s in ShardingStrategy]
ARM_CFG = dict(n_arm=2, input_dim=64, n_categories=8, fc_dim=16,
               lowD_dim=8, tau=0.1)     # tests/test_examples.py:56
ARM_BATCH = 64
TOL_ARM = 1e-5
FIT_RUNS = [dict(name=s, strategy=s, sampler=True, val="v", vbs=256)
            for s in ("full", "ddp", "grad-op", "hybrid-zero2")] + [
    dict(name="nosampler", strategy="full", sampler=False, val="v", vbs=256),
    dict(name="smallval", strategy="full", sampler=True, val="s", vbs=256)]
TUTORIAL = ["full", "ddp"]
CKPT = dict(cfg=dict(n_categories=8, input_dim=64, fc_dim=16, lowD_dim=8,
                     state_dim=2, n_arm=2, tau=0.1, fused_recon=True,
                     fused_encoder=True),
            tcfg=dict(batch_size=32, epochs_per_jit=1, sharding="full"),
            mesh=MESH)


def _dp8():
    return DPMesh(Group(tuple(range(8)), 0))


def _spec(named):
    return tuple(named.spec)


# ---------------------------------------------------------------------------
# Placement, the sweep's tables, the arm study: in this process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mlp_shardings_equal_jax(strategy):
    jmesh = jt.make_mesh_1d(8)
    for jc, pc in ((jt.MLPConfig.shallow(), tt.MLPConfig.shallow()),
                   (_JCFG, _CFG), (jt.MLPConfig(widths=(12, 7)),
                                   tt.MLPConfig(widths=(12, 7)))):
        w = _jax_weights(jc, 0)
        want = jax.tree_util.tree_map(_spec, jt.mlp_shardings(
            w, jmesh, JStrategy(strategy)))
        got = tt.mlp_shardings(w, _dp8(), ShardingStrategy(strategy))
        assert got == want


@pytest.mark.parametrize("shard", [True, False])
def test_generic_shardings_equal_jax(shard):
    w = _jax_weights(jt.MLPConfig.shallow(), 0)
    want = jax.tree_util.tree_map(_spec, jf._generic_shardings(
        w, jt.make_mesh_1d(8), shard))
    assert tf._generic_shardings(w, _dp8(), shard) == want


def test_mlp_shardings_outside_the_group_refused():
    with pytest.raises(ValueError, match="outside"):
        tt.mlp_shardings([], None, ShardingStrategy.FULL_SHARD)


GRIDS = [dict(), dict(models=("shallow", "deep"), precisions=("fp32", "bf16"),
                      device_counts=(None, 2, 4), n_epochs=3),
         dict(strategies=("ddp",), batch_size=64)]


@pytest.mark.parametrize("grid", range(len(GRIDS)))
def test_gen_configs_equal_jax(grid):
    from dataclasses import asdict
    got = [asdict(c) for c in sweep.gen_configs(**GRIDS[grid])]
    want = [asdict(c) for c in jsweep.gen_configs(**GRIDS[grid])]
    assert got == want
    assert (sweep.STRATEGIES, sweep.PRECISIONS, sweep.MODELS) == (
        jsweep.STRATEGIES, jsweep.PRECISIONS, jsweep.MODELS)


def test_load_results_and_summarize_equal_jax(tmp_path):
    path = tmp_path / "r.jsonl"
    recs = [dict(model="shallow", strategy=s, precision="fp32",
                 n_devices=n, n_epochs=1, batch_size=64, n_params=100,
                 epoch_times_s=[0.5, 0.25 * i], train_losses=[2.0, 1.0 / i],
                 test_accs=[0.1, 0.9], wall_s=1.0)
            for i, (s, n) in enumerate([("full", 8), ("ddp", 8),
                                        ("full", 4)], 1)]
    path.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    assert sweep.load_results(str(path)) == jsweep.load_results(str(path))
    assert sweep.load_results(str(tmp_path / "none")) == []
    loaded = sweep.load_results(str(path))
    assert sweep.summarize(loaded) == jsweep.summarize(loaded)
    assert len(sweep.summarize(loaded)) == 3


def test_arm_study_keys_equal_jax():
    got = arm.benchmark_arm_strategies(VAEConfig(**ARM_CFG),
                                       batch_size=ARM_BATCH, n_iters=2,
                                       device="cpu")
    want = jarm.benchmark_arm_strategies(JVAE(**ARM_CFG),
                                         batch_size=ARM_BATCH, n_iters=2)
    assert set(got) == set(want)
    assert all(v > 0 for v in got.values())
    want_sharded = jarm.benchmark_arm_strategies(
        JVAE(**ARM_CFG), batch_size=ARM_BATCH, n_iters=2, shard=True)
    assert set(want_sharded) - set(want) == {"sharded_ms"}


def _arm_inputs():
    cfg = VAEConfig(**ARM_CFG)
    params = mixvae.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    bn = mixvae.init_bn_state(cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((ARM_BATCH, cfg.input_dim), generator=g)
    return cfg, params, bn, x.expand(cfg.n_arm, *x.shape), \
        arm.arm_draws(cfg, ARM_BATCH, g)


@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
def test_arm_loop_equals_stacked(mode):
    cfg, params, bn, xs, noise = _arm_inputs()
    cfg = cfg.replace(mode=mode)
    if mode == "ZINB":
        params = mixvae.init_params(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
    _, rec_l, kl_l = arm.loop_forward(params, bn, cfg, xs, noise)
    _, rec_s, kl_s = arm.stacked_forward(params, bn, cfg, xs, noise)
    np.testing.assert_allclose(rec_l.numpy(), rec_s.numpy(), rtol=TOL_ARM)
    np.testing.assert_allclose(kl_l.numpy(), kl_s.numpy(), rtol=TOL_ARM,
                               atol=TOL_ARM)


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

def _jax_trainer(w, run, data):
    jtr = jf.Trainer(max_epochs=2, strategy=run["strategy"], devices=8,
                     use_distributed_sampler=run["sampler"])
    jtr.fit(_JaxCarried(w, cfg=_JCFG), data["train"],
            val_data=data[run["val"]], batch_size=128,
            val_batch_size=run["vbs"])
    return jtr


@pytest.fixture(scope="module")
def world(tmp_path_factory, monkeypatch_module):
    d = tmp_path_factory.mktemp("multidevice_world")
    inputs = {}
    data = {"train": jt.synthetic_mnist(1024, 0),
            "v": jt.synthetic_mnist(512, 1), "s": jt.synthetic_mnist(5, 2)}
    inputs["fit/x"], inputs["fit/y"] = data["train"]
    for k in ("v", "s"):
        inputs[f"fit/{k}x"], inputs[f"fit/{k}y"] = data[k]
    w = _jax_weights()
    for i, layer in enumerate(w):
        for k, v in layer.items():
            inputs[f"fit/w/{i}/{k}"] = v
    want = {run["name"]: _jax_trainer(w, run, data) for run in FIT_RUNS}
    # the tutorial from JAX's init_mlp(key(0)) draw, as test_torch_fit.py
    wt = _jax_weights(jt.MLPConfig.shallow(), 0)
    for i, layer in enumerate(wt):
        for k, v in layer.items():
            inputs[f"tut/w/{i}/{k}"] = v
    tdata, ttest = jt.synthetic_mnist(1024, 0), jt.synthetic_mnist(256, 1)
    inputs["tut/x"], inputs["tut/y"] = tdata
    inputs["tut/tx"], inputs["tut/ty"] = ttest
    monkeypatch_module.setattr(jt, "init_mlp", lambda key, cfg: jax.tree_util
                               .tree_map(jnp.asarray, wt))
    tut = {s: jt.train_mnist_fsdp(model="shallow", strategy=s, n_epochs=2,
                                  batch_size=256, lr=1e-2, verbose=False,
                                  n_devices=8, data=tdata, test_data=ttest)
           for s in TUTORIAL}
    inputs["ckpt/x"] = np.maximum(np.random.default_rng(3).normal(
        1.0, 1.0, (64, 64)), 0.0).astype(np.float32)
    cases = {"fit": dict(widths=list(_CFG.widths), runs=FIT_RUNS,
                         tutorial=TUTORIAL),
             "sweep": dict(out=str(d / "sweep.jsonl")),
             "arm": dict(cfg=ARM_CFG, batch=ARM_BATCH),
             "ckpt": dict(**CKPT, dir=str(d / "ckpt"))}
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(cases))
    outs = worker.spawn_world(str(d), 8, MESH,
                              ["fit", "sweep", "arm", "ckpt"], timeout=240)
    return dict(outs=outs, want=want, tut=tut, dir=d)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _load(o, key):
    return json.loads(str(o[key][0]))


@pytest.mark.parametrize("name", [r["name"] for r in FIT_RUNS])
def test_trainer_on_eight_ranks_matches_jax(world, name):
    jtr = world["want"][name]
    for o in world["outs"]:
        hist = _load(o, f"fit/{name}/history")
        assert len(hist) == len(jtr.history) == 2
        for rp, rj in zip(hist, jtr.history):
            for k in KEYS:
                np.testing.assert_allclose(rp[k], rj[k], rtol=RTOL_LOSS,
                                           err_msg=f"{name} {k}")
        for i, lj in enumerate(jtr.params):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    o[f"fit/{name}/params/{i}/{k}"], np.asarray(lj[k]),
                    rtol=0, atol=ATOL_PARAM, err_msg=f"{name} {i}.{k}")


@pytest.mark.parametrize("strategy", TUTORIAL)
def test_tutorial_on_eight_ranks_matches_jax(world, strategy):
    ref = world["tut"][strategy]
    for o in world["outs"]:
        got = _load(o, f"tut/{strategy}")
        assert got["n_devices"] == ref.n_devices == 8
        assert got["strategy"] == strategy and got["n_params"] == ref.n_params
        np.testing.assert_allclose(got["train_losses"], ref.train_losses,
                                   rtol=RTOL_LOSS)
        assert got["test_accs"] == ref.test_accs


def test_sweep_writes_one_record_a_config(world):
    recs = sweep.load_results(str(world["dir"] / "sweep.jsonl"))
    assert [(r["strategy"], r["n_devices"]) for r in recs] == [
        ("full", 8), ("full", 4), ("ddp", 8), ("ddp", 4)]
    keys = set(jsweep.SweepConfig.__dataclass_fields__) | set(
        jt.RunResult._fields) | {"wall_s"}
    assert all(set(r) == keys for r in recs)
    assert len(jsweep.summarize(recs)) == 4
    for r, o in enumerate(world["outs"]):
        res = _load(o, "sweep/results")
        assert len(res) == (4 if r < 4 else 2)
        assert [x["train_losses"] for x in res] == [
            x["train_losses"] for x in recs if x["n_devices"] == 8 or r < 4]


def test_arm_sharded_equals_stacked(world):
    cfg, params, bn, xs, noise = _arm_inputs()
    total, rec, kl = arm.stacked_forward(params, bn, cfg, xs, noise)
    for r, o in enumerate(world["outs"]):
        keys = set(_load(o, "arm/keys"))
        if r >= cfg.n_arm:
            assert "arm/total" not in o and "sharded_ms" not in keys
            continue
        assert "sharded_ms" in keys
        np.testing.assert_allclose(o["arm/total"][0], float(total),
                                   rtol=TOL_ARM)
        np.testing.assert_allclose(o["arm/loss_rec"], rec.numpy(),
                                   rtol=TOL_ARM)
        np.testing.assert_allclose(o["arm/kl"], kl.numpy(), rtol=TOL_ARM,
                                   atol=TOL_ARM)


def _same_tree(o, a, b):
    keys = [k for k in o if k.startswith(a + "/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(o[k], o[b + k[len(a):]], err_msg=k)


def test_sharded_checkpoint_resumes_bit_for_bit(world):
    for o in world["outs"]:
        meta_epoch, restored_epoch, epoch = (int(v) for v in
                                             o["ckpt/meta_epoch"])
        assert meta_epoch == restored_epoch == epoch == 1
        np.testing.assert_array_equal(o["ckpt/restored/total"],
                                      o["ckpt/orig/total"])
        _same_tree(o, "ckpt/orig/params", "ckpt/restored/params")
    files = os.listdir(world["dir"] / "ckpt")
    assert "dvae_meta.json" in files and ".metadata" in files


def test_sharded_checkpoint_restores_onto_another_mesh(world):
    for o in world["outs"]:
        _same_tree(o, "ckpt/saved", "ckpt/no")


def test_sharded_checkpoint_with_host_moments(world):
    for o in world["outs"]:
        _same_tree(o, "ckpt/off_saved", "ckpt/off_back")
        assert list(o["ckpt/off_back/ints"]) == [11, 0, 0]


def test_load_checkpoint_refuses_a_sharded_directory(world):
    from dvae_tpu_torch.utils.checkpoint import load_checkpoint
    with pytest.raises(ValueError, match="restore_sharded"):
        load_checkpoint(str(world["dir"] / "ckpt"))
