"""The PyTorch port's fit Trainer and MNIST tutorial against the JAX package:
``train/fit.py`` and ``examples/fsdp_tutorial.py``.

The eight tests of ``tests/test_fit.py`` and the tutorial cases of
``tests/test_examples.py`` run on the port (CPU, one device).  The parity
cases carry JAX's ``init_mlp`` weights into the port
(``utils.checkpoint.mlp_params_from_jax``) and run both Trainers on the
same numpy data: per-epoch ``train_loss``, ``val_loss``, ``val_acc`` within
rtol 1e-4 and the final parameters within atol 1e-5.  JAX's Trainer runs
on the suite's 8-device CPU mesh unless said otherwise; its validation
batch is then rounded down to a multiple of 8, so the sizes here are
multiples of 8 but in the case that shows the rounding is the only
difference.

One weight is ill-conditioned in the shuffled run at this size: w1[300,
45] moves by 4.9e-6 between JAX's own runs on one device and on eight (the
gradient's sum in another order, amplified by Adam's normalisation), and
the port lies 1.2e-5 from the 8-device run and 7.5e-6 from the 1-device
one there, every other weight within 5e-7.  The shuffled parameters are
therefore held against JAX's Trainer on one device (``devices=1``), the
summation layout of the port's, and the 8-device run's losses as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvae_tpu.examples import fsdp_tutorial as jt
from dvae_tpu.train import fit as jf

from dvae_tpu_torch.config import ShardingStrategy
from dvae_tpu_torch.examples import fsdp_tutorial as tt
from dvae_tpu_torch.train import fit as tf
from dvae_tpu_torch.utils.checkpoint import mlp_params_from_jax

RTOL_LOSS = 1e-4
ATOL_PARAM = 1e-5
TOL_APPLY = 1e-6
RTOL_BF16 = 1e-2
KEYS = ("train_loss", "val_loss", "val_acc")

_CFG = tt.MLPConfig(widths=(64,))     # test-sized PLNet analogue
_JCFG = jt.MLPConfig(widths=(64,))
STRATEGIES = [s.value for s in ShardingStrategy]


def _mod():
    return tf.MNISTFitModule(cfg=_CFG)


def _jax_weights(cfg=_JCFG, seed=1):
    """JAX's ``init_mlp`` draw (the Trainer's ``key(seed)``), as numpy."""
    return jax.tree_util.tree_map(np.asarray,
                                  jt.init_mlp(jax.random.key(seed), cfg))


class _JaxCarried(jf.MNISTFitModule):
    def __init__(self, weights, **kw):
        super().__init__(**kw)
        self.weights = weights

    def init_params(self, key):
        return jax.tree_util.tree_map(jnp.asarray, self.weights)


class _PortCarried(tf.MNISTFitModule):
    def __init__(self, weights, **kw):
        super().__init__(**kw)
        self.weights = weights

    def init_params(self, generator):
        return mlp_params_from_jax(self.weights)


def _both(train, val, vbs, shuffle=False, jax_devices=None, epochs=2,
          port_val=None):
    """(JAX Trainer, port Trainer) after the same fit from JAX's weights."""
    w = _jax_weights()
    jtr = jf.Trainer(max_epochs=epochs, shuffle=shuffle, devices=jax_devices)
    jtr.fit(_JaxCarried(w, cfg=_JCFG), train, val_data=val, batch_size=128,
            val_batch_size=vbs)
    ptr = tf.Trainer(max_epochs=epochs, shuffle=shuffle, device="cpu")
    ptr.fit(_PortCarried(w, cfg=_CFG), train,
            val_data=val if port_val is None else port_val, batch_size=128,
            val_batch_size=vbs)
    return jtr, ptr


def _assert_history(jtr, ptr, keys=KEYS):
    assert len(jtr.history) == len(ptr.history)
    for rj, rp in zip(jtr.history, ptr.history):
        for k in keys:
            np.testing.assert_allclose(rp[k], rj[k], rtol=RTOL_LOSS,
                                       err_msg=k)


def _assert_params(jtr, ptr):
    for lj, lp in zip(jtr.params, ptr.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(lp[k].numpy(), np.asarray(lj[k]),
                                       rtol=0, atol=ATOL_PARAM)


# ---------------------------------------------------------------------------
# tests/test_fit.py on the port
# ---------------------------------------------------------------------------

class TestTrainerFit:
    def test_fit_learns_and_logs(self):
        trainer = tf.Trainer(max_epochs=3, strategy="full", device="cpu")
        summary = trainer.fit(_mod(), tt.synthetic_mnist(1024, seed=0),
                              val_data=tt.synthetic_mnist(512, seed=1),
                              batch_size=128, val_batch_size=256)
        h = trainer.history
        assert len(h) == 3
        assert h[-1]["train_loss"] < h[0]["train_loss"]
        assert h[-1]["val_acc"] > 0.8
        for rec in h:
            assert {"train_loss", "val_loss", "val_acc", "epoch_time",
                    "device_memory_mb"} <= set(rec)
        assert summary["avg_epoch_time"] > 0
        assert set(summary) == {"avg_epoch_time", "avg_memory_usage"}
        assert trainer.params is not None

    @pytest.mark.parametrize("strategy", ["ddp", "grad-op", "hybrid-zero2"])
    def test_strategies_match_full_shard(self, strategy):
        """On one device a strategy is a placement only: the same loss
        bit for bit."""
        def run(s):
            t = tf.Trainer(max_epochs=2, strategy=s, device="cpu")
            t.fit(_mod(), tt.synthetic_mnist(512, seed=0), batch_size=128)
            return t.history[-1]["train_loss"]

        assert run(strategy) == run(ShardingStrategy.FULL_SHARD)

    def test_no_sampler_replicated_batch(self):
        t1 = tf.Trainer(max_epochs=1, strategy="no",
                        use_distributed_sampler=False, device="cpu")
        t1.fit(_mod(), tt.synthetic_mnist(512, seed=0), batch_size=128)
        t2 = tf.Trainer(max_epochs=1, strategy="no", device="cpu")
        t2.fit(_mod(), tt.synthetic_mnist(512, seed=0), batch_size=128)
        np.testing.assert_allclose(t1.history[0]["train_loss"],
                                   t2.history[0]["train_loss"], rtol=1e-5)

    def test_shuffle_epochs_differ(self):
        t = tf.Trainer(max_epochs=2, strategy="no", shuffle=True,
                       device="cpu")
        t.fit(_mod(), tt.synthetic_mnist(512, seed=0), batch_size=128)
        assert len(t.history) == 2

    def test_refit_resets_history(self):
        t = tf.Trainer(max_epochs=2, strategy="no", device="cpu")
        t.fit(_mod(), tt.synthetic_mnist(512, seed=0), batch_size=128)
        t.fit(_mod(), tt.synthetic_mnist(512, seed=0), batch_size=128)
        assert len(t.history) == 2

    def test_params_before_fit_raises(self):
        with pytest.raises(RuntimeError, match="no completed fit"):
            tf.Trainer(device="cpu").params


def test_small_validation_set_clamps_batch():
    trainer = tf.Trainer(max_epochs=1, strategy="no", device="cpu")
    trainer.fit(_mod(), tt.synthetic_mnist(256, seed=0),
                val_data=tt.synthetic_mnist(100, seed=1),
                batch_size=64, val_batch_size=1000)
    assert np.isfinite(trainer.history[-1]["val_loss"])


def test_val_set_smaller_than_dp_span_evaluates_replicated():
    """5 validation rows (JAX's case: fewer than its 8-device span) are one
    batch on one device."""
    trainer = tf.Trainer(max_epochs=1, strategy="no", device="cpu")
    trainer.fit(_mod(), tt.synthetic_mnist(256, seed=0),
                val_data=tt.synthetic_mnist(5, seed=1),
                batch_size=64, val_batch_size=256)
    assert np.isfinite(trainer.history[-1]["val_loss"])


# ---------------------------------------------------------------------------
# The Trainer against JAX's from the same weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [False, True])
def test_trainer_matches_jax_on_one_device(shuffle):
    jtr, ptr = _both(jt.synthetic_mnist(1024, 0), jt.synthetic_mnist(512, 1),
                     256, shuffle=shuffle, jax_devices=1)
    _assert_history(jtr, ptr)
    _assert_params(jtr, ptr)


def test_trainer_matches_jax_on_the_mesh():
    jtr, ptr = _both(jt.synthetic_mnist(1024, 0), jt.synthetic_mnist(512, 1),
                     256)
    _assert_history(jtr, ptr)
    _assert_params(jtr, ptr)


def test_shuffled_losses_match_jax_on_the_mesh():
    """The shuffled run sees JAX's permutations: its losses match the
    8-device run's (the parameters: see the module docstring)."""
    jtr, ptr = _both(jt.synthetic_mnist(1024, 0), jt.synthetic_mnist(512, 1),
                     256, shuffle=True)
    _assert_history(jtr, ptr)


def test_clamped_validation_batch_differs_only_by_the_rounding():
    """100 validation rows at val_batch_size 1000: JAX rounds the batch to
    96 rows (a multiple of its 8 devices), the port keeps 100.  The port on
    the first 96 rows gives JAX's numbers; on all 100 its val_loss differs."""
    val = jt.synthetic_mnist(100, 1)
    jtr, ptr = _both(jt.synthetic_mnist(512, 0), val, 1000,
                     port_val=tuple(a[:96] for a in val))
    _assert_history(jtr, ptr)
    _assert_params(jtr, ptr)
    full = tf.Trainer(max_epochs=2, device="cpu")
    full.fit(_PortCarried(_jax_weights(), cfg=_CFG), jt.synthetic_mnist(512, 0),
             val_data=val, batch_size=128, val_batch_size=1000)
    assert full.history[-1]["val_loss"] != ptr.history[-1]["val_loss"]
    assert [r["train_loss"] for r in full.history] == \
        [r["train_loss"] for r in ptr.history]


def test_one_validation_batch_matches_jax():
    """200 rows at val_batch_size 1000: one batch in both (200 is a
    multiple of 8)."""
    jtr, ptr = _both(jt.synthetic_mnist(512, 0), jt.synthetic_mnist(200, 1),
                     1000)
    _assert_history(jtr, ptr)
    _assert_params(jtr, ptr)


def test_module_train_loss_wins_and_val_prefix_kept():
    """``{"train_loss": loss, **metrics}``: a module's own train_loss wins;
    a validation key already starting with ``val_`` is not prefixed."""
    class Mod(tf.MNISTFitModule):
        def training_step(self, params, batch, generator):
            loss, _ = self._loss(params, batch)
            return loss, {"train_loss": loss * 0 + 7.0, "extra": loss * 2}

        def validation_step(self, params, batch):
            loss, acc = self._loss(params, batch)
            return {"val_custom": acc, "loss": loss}

    t = tf.Trainer(max_epochs=1, device="cpu")
    t.fit(Mod(cfg=_CFG), tt.synthetic_mnist(256, 0),
          val_data=tt.synthetic_mnist(64, 1), batch_size=64)
    rec = t.history[0]
    assert rec["train_loss"] == 7.0
    assert {"extra", "val_custom", "val_loss"} <= set(rec)
    assert "val_val_custom" not in rec


def test_every_strategy_equal_on_one_device():
    hist = {}
    for s in STRATEGIES:
        t = tf.Trainer(max_epochs=2, strategy=s, device="cpu")
        t.fit(_mod(), tt.synthetic_mnist(256, 0),
              val_data=tt.synthetic_mnist(64, 1), batch_size=64)
        hist[s] = ([{k: r[k] for k in KEYS} for r in t.history],
                   [p.clone() for layer in t.params for p in layer.values()])
    ref_h, ref_p = hist["full"]
    for s, (h, p) in hist.items():
        assert h == ref_h, s
        assert all(torch.equal(a, b) for a, b in zip(p, ref_p)), s


def test_tree_helpers_follow_jax_and_release_their_leaves():
    """``tree_leaves`` of the MLP's list of dicts is JAX's leaf order, and
    ``tree_like`` keeps no reference to the leaves it was given (a
    reference cycle would hold a step's gradients until the garbage
    collector runs)."""
    import gc
    import weakref

    from dvae_tpu_torch.train.step import tree_leaves, tree_like
    w = _jax_weights()
    port = mlp_params_from_jax(w)
    for a, b in zip(tree_leaves(port), jax.tree_util.tree_leaves(w)):
        assert np.array_equal(a.numpy(), b)
    leaf = torch.ones(8)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        out = tree_like({"a": [{"w": 0, "b": None}]}, [leaf])
        assert out["a"][0]["w"] is leaf and out["a"][0]["b"] is None
        del out, leaf
        assert ref() is None
    finally:
        gc.enable()


def test_more_devices_than_the_world_are_refused():
    """Outside a torch.distributed world the world has one process: two
    devices are a ValueError naming that size, and a rank without a mesh
    has no shardings."""
    with pytest.raises(ValueError, match="world of 1"):
        tf.Trainer(devices=2, device="cpu").fit(
            _mod(), tt.synthetic_mnist(128, 0), batch_size=64)
    with pytest.raises(ValueError, match="world of 1"):
        tt.train_mnist_fsdp(n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="world of 1"):
        tt.make_mesh_1d(2)
    with pytest.raises(ValueError, match="world of 1"):
        tt.mlp_shardings([], None, ShardingStrategy.FULL_SHARD)
    t = tf.Trainer(devices=1, max_epochs=1, device="cpu")
    t.fit(_mod(), tt.synthetic_mnist(128, 0), batch_size=64)
    assert len(t.history) == 1


def test_fit_mnist_demo_records_jax_keys():
    summary = tf.fit_mnist_demo("net", max_epochs=1, n_train=256,
                                verbose=False, device="cpu")
    ref = jf.fit_mnist_demo("net", max_epochs=1, n_train=256, verbose=False)
    assert set(summary) == set(ref)
    assert all(np.isfinite(v) for v in summary.values())


# ---------------------------------------------------------------------------
# The tutorial: tests/test_examples.py's cases on the port, and parity
# ---------------------------------------------------------------------------

def test_model_scales_match_reference():
    g = torch.Generator().manual_seed(0)
    p_shallow = tt.init_mlp(g, tt.MLPConfig.shallow(), device="cpu")
    n_shallow = sum(p.numel() for layer in p_shallow for p in layer.values())
    assert 0.8e6 < n_shallow < 1.5e6
    dims = (784,) + tt.MLPConfig.deep().widths + (10,)
    n_deep = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    assert 70e6 < n_deep < 110e6
    assert tt.MLPConfig.shallow() == tt.MLPConfig(widths=(1024, 128))
    assert tt.MLPConfig.deep().widths == jt.MLPConfig.deep().widths


def test_init_mlp_shapes_and_bounds_are_jaxs():
    port = tt.init_mlp(torch.Generator().manual_seed(0), tt.MLPConfig.shallow(),
                       device="cpu")
    ref = _jax_weights(jt.MLPConfig.shallow(), 0)
    for lp, lj in zip(port, ref):
        bound = 1.0 / np.sqrt(lj["w"].shape[0])
        for k in ("w", "b"):
            assert tuple(lp[k].shape) == lj[k].shape
            assert lp[k].dtype == torch.float32
            assert float(lp[k].abs().max()) <= bound


@pytest.mark.parametrize("n,seed", [(1000, 0), (257, 3), (1, 9)])
def test_synthetic_mnist_bit_for_bit(n, seed):
    xj, yj = jt.synthetic_mnist(n, seed)
    xp, yp = tt.synthetic_mnist(n, seed)
    assert xp.dtype == xj.dtype and yp.dtype == yj.dtype
    assert np.array_equal(xp, xj) and np.array_equal(yp, yj)
    assert xp.shape == (n, 784) and set(np.unique(yp)) <= set(range(10))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_apply_mlp_from_carried_weights(dtype):
    w = _jax_weights(jt.MLPConfig.shallow(), 4)
    x, _ = jt.synthetic_mnist(64, 2)
    jd = {"fp32": None, "bf16": jnp.bfloat16}[dtype]
    td = {"fp32": None, "bf16": torch.bfloat16}[dtype]
    ref = np.asarray(jt.apply_mlp(jax.tree_util.tree_map(jnp.asarray, w),
                                  jnp.asarray(x), jd))
    got = tt.apply_mlp(mlp_params_from_jax(w), torch.from_numpy(x), td)
    assert got.dtype == torch.float32
    if dtype == "fp32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=TOL_APPLY * np.abs(ref).max())
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL_BF16,
                                   atol=RTOL_BF16 * np.abs(ref).max())


@pytest.mark.parametrize("strategy", ["full", "ddp"])
def test_tutorial_trains_and_shards(strategy):
    res = tt.train_mnist_fsdp(model="shallow", strategy=strategy, n_epochs=4,
                              batch_size=256, lr=1e-2, verbose=False,
                              data=tt.synthetic_mnist(2048, 0),
                              test_data=tt.synthetic_mnist(512, 1),
                              device="cpu")
    assert res.n_devices == 1
    assert res.train_losses[-1] < res.train_losses[0]
    assert res.test_accs[-1] > 0.5
    assert res.strategy == strategy
    assert len(res.epoch_times_s) == 4


@pytest.mark.parametrize("precision", ["bf16", "fp16"])
def test_reduced_precision_runs(precision):
    res = tt.train_mnist_fsdp(model="shallow", strategy="full", n_epochs=1,
                              batch_size=256, precision=precision,
                              verbose=False, data=tt.synthetic_mnist(1024, 0),
                              test_data=tt.synthetic_mnist(256, 1),
                              device="cpu")
    assert np.isfinite(res.train_losses).all()
    assert res.precision == precision


def test_tutorial_strategies_equal_on_one_device():
    runs = {s: tt.train_mnist_fsdp(strategy=s, n_epochs=2, batch_size=256,
                                   verbose=False,
                                   data=tt.synthetic_mnist(1024, 0),
                                   test_data=tt.synthetic_mnist(256, 1),
                                   device="cpu")
            for s in STRATEGIES}
    ref = runs["full"]
    for s, r in runs.items():
        assert r.train_losses == ref.train_losses, s
        assert r.test_accs == ref.test_accs, s
        assert r.strategy == s


@pytest.mark.parametrize("epochs", [1, 3])
def test_train_mnist_fsdp_matches_jax(monkeypatch, epochs):
    """The tutorial from JAX's ``init_mlp(key(seed))`` weights, JAX on its
    8-device mesh: the epoch losses within rtol 1e-4 and the test
    accuracies equal (each epoch draws JAX's permutation)."""
    w = _jax_weights(jt.MLPConfig.shallow(), 0)
    monkeypatch.setattr(tt, "init_mlp",
                        lambda g, cfg, device="cuda": mlp_params_from_jax(
                            w, device))
    kw = dict(model="shallow", n_epochs=epochs, batch_size=256, lr=1e-2,
              verbose=False, data=jt.synthetic_mnist(1024, 0),
              test_data=jt.synthetic_mnist(256, 1))
    ref = jt.train_mnist_fsdp(**kw)
    got = tt.train_mnist_fsdp(**kw, device="cpu")
    np.testing.assert_allclose(got.train_losses, ref.train_losses,
                               rtol=RTOL_LOSS)
    assert got.test_accs == ref.test_accs
    assert got.n_params == ref.n_params
