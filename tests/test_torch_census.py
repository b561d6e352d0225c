"""The collective census of the PyTorch port against the JAX package:
``parallel/collective_cost.py`` and ``parallel/census.py``.

The JAX census parses the collectives out of XLA's optimised HLO; the
port records them as ``parallel/runtime.py`` issues them
(``record_collectives``).  Held exactly against the JAX package, in this
process:

* the ring model: ``stats_from_records`` on records equal to the HLO lines
  of tests/test_collective_cost.py gives ``hlo_collective_stats``'s
  ``wire_bytes`` and ``bytes_by_kind`` (a reduce-scatter is recorded with
  its whole input, the payload of the async form JAX counts);
* ``grad_traffic_lower_bound`` at ``production_cfg``'s shapes on five
  meshes, ``analytic_check`` on tests/test_census.py's five cases,
  ``census_cells`` with and without a ledger, and ``run_census`` with no
  budget.

One 8-rank gloo world on the CPU (``tests/_torch_dist_worker.py``) runs
the rest: the assertions of JAX's test_ddp_allreduces_gradients,
test_full_shard_moves_params and test_no_shard_still_averages_gradients
at their CFG/TCFG on (2, 1, 4); the census rows of the six strategies ×
MSE, ZINB and aug on (2, 2, 2) at test width with B=512 and D=256, so
that one (A_l, B_l, D) tensor outweighs the gradients' flat all-reduce
and the posteriors gathered for the coupling terms, as at the production
shape (D=5032 against C=92), each ring-consistent without an activation-sized
collective and with one list of collectives a step; ``small_equality``
on the port's draws (the six strategies within rtol 2e-4) and on JAX's
``key(7)`` weights and per-step draws carried across (MSE and ZINB),
held to JAX's ``small_equality`` at rtol 5e-4 (the mesh epoch's
tolerance).
"""

import json

import jax
import numpy as np
import pytest
import torch

import dvae_tpu.config as jcfg
from dvae_tpu.parallel import census as jcensus
from dvae_tpu.parallel import collective_cost as jcc
from dvae_tpu.parallel.sharding import make_mesh as jmake_mesh
from dvae_tpu.train import step as jstep

from dvae_tpu_torch.config import MeshConfig, ShardingStrategy, VAEConfig
from dvae_tpu_torch.parallel import census, collective_cost as cc
from dvae_tpu_torch.parallel.runtime import CollectiveRecord
from dvae_tpu_torch.parallel.sharding import make_mesh, mesh_layout

import _torch_dist_worker as worker
from test_torch_mesh import _noise, _tree_np

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

MESH = [2, 2, 2]
CFG = dict(n_categories=8, input_dim=64, fc_dim=16, lowD_dim=8, state_dim=2,
           n_arm=2, tau=0.1)                 # tests/test_collective_cost.py
ROW_BATCH = 512
ROW_GENES = 256
RTOL_STRATEGY = 2e-4                         # census.small_equality
RTOL_JAX = 5e-4                              # tests/test_torch_mesh.py


# ---------------------------------------------------------------------------
# The ring model against the HLO parse
# ---------------------------------------------------------------------------

_AR = ("%all-reduce.1 = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p), "
       "replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add")
_AG = ("%all-gather.2 = bf16[4,32]{1,0} all-gather(bf16[4,8]{1,0} %q), "
       "replica_groups=[2,4]<=[8], dimensions={1}")
_RS = ("%rs = f32[2,8]{1,0} reduce-scatter(f32[8,8]{1,0} %r), "
       "replica_groups={{0,1,2,3}}, to_apply=%add")
_RS_ASYNC = ("%rs = (f32[8,8]{1,0}, f32[2,8]{1,0}) reduce-scatter-start("
             "f32[8,8]{1,0} %r), replica_groups={{0,1,2,3}}")
_AR_ASYNC = ("%ars = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-reduce-start("
             "f32[4,4]{1,0} %x), replica_groups={{0,1}}")
_AG_ASYNC = ("%ags = (f32[2,4]{1,0}, f32[4,4]{1,0}) all-gather-start("
             "f32[2,4]{1,0} %x), replica_groups={{0,1}}")

RING_CASES = {
    "all-reduce": ([_AR], [CollectiveRecord("all-reduce", "float32", 512, 4)]),
    "all-gather": ([_AG], [CollectiveRecord("all-gather", "bfloat16", 256,
                                            4)]),
    "reduce-scatter": ([_RS_ASYNC], [CollectiveRecord("reduce-scatter",
                                                      "float32", 256, 4)]),
    "async-all-reduce": ([_AR_ASYNC], [CollectiveRecord("all-reduce",
                                                        "float32", 64, 2)]),
    "async-all-gather": ([_AG_ASYNC], [CollectiveRecord("all-gather",
                                                        "float32", 64, 2)]),
    "module": ([_AR, _AG, _RS_ASYNC], [
        CollectiveRecord("all-reduce", "float32", 512, 4),
        CollectiveRecord("step", "", 0, 0),
        CollectiveRecord("all-gather", "bfloat16", 256, 4),
        CollectiveRecord("reduce-scatter", "float32", 256, 4)]),
}


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_model_equals_the_hlo_parse(name):
    lines, records = RING_CASES[name]
    want = jcc.hlo_collective_stats("\n".join(lines) + "\n", 8)
    got = cc.stats_from_records(records, 8)
    assert got.wire_bytes == want.wire_bytes
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.counts == want.counts


def test_reduce_scatter_input_costs_the_sync_line():
    """The recorded whole input costs on the wire what JAX's sync line (the
    scattered output, times g − 1) does."""
    sync = jcc.hlo_collective_stats(_RS + "\n", 8)
    got = cc.stats_from_records(RING_CASES["reduce-scatter"][1], 8)
    assert got.wire_bytes == sync.wire_bytes


def test_predict_and_the_nvlink_default():
    s = cc.CollectiveStats({"all-reduce": 1}, {"all-reduce": 1000},
                           wire_bytes=450e6)
    js = jcc.CollectiveStats({"all-reduce": 1}, {"all-reduce": 1000},
                             wire_bytes=450e6)
    assert cc.predict(s, 1e-3, gbps=90.0) == jcc.predict(js, 1e-3, gbps=90.0)
    assert s.ici_seconds() == pytest.approx(1e-3)
    out = cc.predict(s, step_seconds=1e-3)
    assert out["wire_seconds_per_step"] == pytest.approx(1e-3)
    assert out["efficiency_no_overlap"] == pytest.approx(0.5)


def test_steps_that_differ_raise():
    r = CollectiveRecord("all-reduce", "float32", 64, 2)
    mark = CollectiveRecord("step", "", 0, 0)
    assert cc.per_step_records([r, mark, r, mark, r]) == [r, r]
    with pytest.raises(AssertionError, match="step 1"):
        cc.per_step_records([r, mark, r, r, mark])
    with pytest.raises(ValueError, match="no step mark"):
        cc.per_step_records([r])


# ---------------------------------------------------------------------------
# The analytic side against the JAX census
# ---------------------------------------------------------------------------

MESHES = [(2, 2, 2), (2, 1, 4), (8, 1, 1), (1, 2, 1), (1, 1, 1)]


def _jmesh(shape):
    n = int(np.prod(shape))
    return jmake_mesh(jcfg.MeshConfig(*shape), devices=jax.devices()[:n])


@pytest.mark.parametrize("mode", ["MSE", "ZINB"])
@pytest.mark.parametrize("shape", MESHES)
def test_grad_traffic_lower_bound_equals_jax(shape, mode):
    jc = jcensus.production_cfg(mode)
    tx = jstep.make_optimizer(jc)
    shapes = jax.eval_shape(
        lambda: jstep.init_train_state(jax.random.key(0), jc, tx))
    want = jcensus.grad_traffic_lower_bound(shapes.params, _jmesh(shape))
    got = census.grad_traffic_lower_bound(
        census.param_shapes(census.production_cfg(mode)),
        mesh_layout(MeshConfig(*shape)))
    assert got == want


ANALYTIC = [
    ("full", {"all-gather": 4, "all-reduce": 2}, 1e9, 1e8, (2, 2, 2)),
    ("full", {"all-reduce": 2}, 1e9, 1e8, (2, 2, 2)),
    ("ddp", {"all-gather": 1}, 1e9, 1e8, (2, 2, 2)),
    ("ddp", {"all-reduce": 2}, 1e6, 1e8, (2, 2, 2)),
    ("full", {}, 0.0, 0.0, (1, 1, 1)),
]


@pytest.mark.parametrize("case", range(len(ANALYTIC)))
def test_analytic_check_equals_jax(case):
    strat, counts, wire, bound, shape = ANALYTIC[case]
    want = jcensus.analytic_check(
        jcfg.ShardingStrategy(strat),
        jcc.CollectiveStats(dict(counts), {}, wire), bound, _jmesh(shape))
    got = census.analytic_check(
        ShardingStrategy(strat), cc.CollectiveStats(dict(counts), {}, wire),
        bound, mesh_layout(MeshConfig(*shape)))
    assert got == want


def _names(cells):
    return [(k, None if s is None else s.value, m) for k, s, m in cells]


LEDGERS = {
    "none": None,
    "rotated": {"grad-op/MSE": 4, "no/MSE": 4, "hybrid/MSE": 4,
                "hybrid-zero2/MSE": 3, "ddp/MSE": 3, "grad-op/ZINB": 3,
                "no/ZINB": 3, "hybrid/ZINB": 3, "hybrid-zero2/ZINB": 3},
    "one": {"ddp/MSE": 1},
    "small": {"small/ZINB": 2, "no/aug": 1},
}


@pytest.mark.parametrize("ledger", list(LEDGERS))
@pytest.mark.parametrize("small", [True, False])
def test_census_cells_equal_jax(ledger, small):
    got = census.census_cells(small=small, ledger=LEDGERS[ledger])
    want = jcensus.census_cells(small=small, ledger=LEDGERS[ledger])
    assert _names(got) == _names(want)


def test_census_cells_of_a_subset_equal_jax():
    got = census.census_cells(["ddp", "full"], modes=("MSE", "aug"))
    want = jcensus.census_cells(
        [jcfg.ShardingStrategy.DDP, jcfg.ShardingStrategy.FULL_SHARD],
        modes=("MSE", "aug"))
    assert _names(got) == _names(want)


def test_run_census_budget_zero_skips_everything():
    logs = []
    summary = census.run_census(make_mesh(MeshConfig()), budget_s=0.0,
                                log=logs.append, device="cpu")
    assert summary["rows"] == [] and summary["equality"] == {}
    assert summary["clean"] is False
    want = jcensus.run_census(_jmesh((2, 2, 2)), budget_s=0.0,
                              log=lambda *_: None)
    assert summary["skipped"] == want["skipped"]
    assert len(summary["skipped"]) == 21 and logs


def test_frozen_random_augmenter_takes_the_steps_none_draws():
    """The train step calls an ``AugmentFn`` with ``draws=None`` (fault
    C16: ``frozen_random_augment_fn`` took only an ``AugNoise``); None
    draws from the generator, as an empty ``AugNoise`` does."""
    from dvae_tpu_torch.augment.augmenter import (AugNoise,
                                                  frozen_random_augment_fn)
    fn = frozen_random_augment_fn(16, n_dim=8, device="cpu")
    x = torch.rand((4, 16), generator=torch.Generator().manual_seed(0))
    a = fn(x, 2, torch.Generator().manual_seed(1), None)
    b = fn(x, 2, torch.Generator().manual_seed(1), AugNoise())
    assert a.shape == (2, 4, 16) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------

def _jax_small_equality_draws(mode, inputs):
    """JAX's small_equality (dvae_tpu/parallel/census.py:217-270) on the
    (2, 2, 2) mesh, and its key(7) weights and per-step draws carried into
    ``inputs``: the permutation from the runner's key, each step's noise
    from the step's key."""
    jmesh = _jmesh(tuple(MESH))
    want = jcensus.small_equality(mode, jmesh, [
        jcfg.ShardingStrategy.FULL_SHARD, jcfg.ShardingStrategy.DDP])
    jc = jcensus.small_cfg(mode, n_arm=2)
    B = 16 * MESH[0] * MESH[2]
    n = 2 * B
    x = np.maximum(np.random.default_rng(0).normal(
        1.0, 1.0, (n, jc.input_dim)), 0.0).astype(np.float32)
    st = jstep.init_train_state(jax.random.key(7), jc,
                                jstep.make_optimizer(jc))
    pre = f"census/jax/{mode}"
    worker.flat(f"{pre}/params", _tree_np(st.params), inputs)
    worker.flat(f"{pre}/bn", _tree_np(st.bn), inputs)
    key, k_perm = jax.random.split(st.key)
    plan = np.array(jax.random.permutation(k_perm, n)).reshape(2, B)
    xs, noise = [], []
    for s in range(2):
        key, _, k_fwd = jax.random.split(key, 3)
        xs.append(x[plan[s]])
        noise.append(_noise(k_fwd, jc, B))
    inputs[f"{pre}/x"] = np.stack(xs)
    for k in noise[0]:
        inputs[f"{pre}/noise/{k}"] = np.stack([d[k] for d in noise])
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("census_world")
    inputs, want = {}, {}
    for mode in ("MSE", "ZINB"):
        want[mode] = _jax_small_equality_draws(mode, inputs)
    cases = {"census": dict(cfg=CFG, batch=32, n_train=128,
                            row_batch=ROW_BATCH, row_genes=ROW_GENES, jax_modes=list(want))}
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(cases))
    outs = worker.spawn_world(str(d), 8, MESH, ["census"], timeout=240)
    return dict(outs=outs, want=want)


def _load(o, key):
    return json.loads(str(o[key][0]))


def _param_bytes():
    from dvae_tpu_torch.train.step import init_train_state, make_optimizer
    cfg = VAEConfig(**CFG)
    st = init_train_state(0, cfg, make_optimizer(cfg))
    return sum(p.numel() * p.element_size()
               for layer in st.params.values() for p in layer.values())


def test_ddp_allreduces_gradients(world):
    for o in world["outs"]:
        s = _load(o, "census/stats/ddp")
        assert s["bytes_by_kind"].get("all-gather", 0) < _param_bytes()
        assert s["bytes_by_kind"].get("all-reduce", 0) >= _param_bytes()


def test_full_shard_moves_params(world):
    for o in world["outs"]:
        s = _load(o, "census/stats/full")
        assert s["counts"].get("all-gather", 0) > 0
        assert s["wire_bytes"] > 0


def test_no_shard_still_averages_gradients(world):
    for o in world["outs"]:
        assert _load(o, "census/stats/no")["bytes_by_kind"].get(
            "all-reduce", 0) > 0


ROWS = [(m, s.value) for m in census.MODES for s in ShardingStrategy]


@pytest.mark.parametrize("mode,strategy", ROWS)
def test_census_row_is_clean(world, mode, strategy):
    """Ring-consistent, no activation-sized collective, one list of
    collectives a step (``per_step_records`` raised otherwise), the same
    on every rank."""
    rows = [{(r["mode"], r["strategy"]): r for r in _load(o, "census/rows")}
            for o in world["outs"]]
    row = rows[0][(mode, strategy)]
    assert row["analytic_ok"], row["analytic_why"]
    assert row["warnings"] == []
    assert row["wire_bytes"] > 0 and row["compile_s"] > 0
    for r in rows[1:]:
        assert r[(mode, strategy)]["counts"] == row["counts"]
        assert r[(mode, strategy)]["wire_bytes"] == row["wire_bytes"]


@pytest.mark.parametrize("mode", census.MODES)
def test_small_equality_six_strategies_agree(world, mode):
    for o in world["outs"]:
        losses = _load(o, f"census/equality/{mode}")
        assert set(losses) == {s.value for s in ShardingStrategy}
        base = np.asarray(losses["full"])
        assert np.isfinite(base).all()
        for s, v in losses.items():
            np.testing.assert_allclose(v, base, rtol=RTOL_STRATEGY,
                                       err_msg=s)


def test_small_equality_on_jax_draws_equals_jax(world):
    for mode, want in world["want"].items():
        for o in world["outs"]:
            got = _load(o, f"census/carried/{mode}")
            assert len(got) == 6
            for s, v in got.items():
                for ref in want.values():
                    np.testing.assert_allclose(v, ref, rtol=RTOL_JAX,
                                               err_msg=f"{mode}/{s}")
