"""The port's mesh layer (``dvae_tpu_torch.parallel``, ``ops/partitioned``)
against the JAX package's on the CPU.

* Placement: every spec of ``param_shardings``, ``opt_state_shardings``
  (with ``offload_host``), ``bn_shardings`` and ``batch_sharding`` equals
  the JAX function's, leaf for leaf, for the six strategies on the (2, 2, 2)
  mesh and on meshes where an axis divides nothing or only some leaves.
* The runtime: ``local_slice`` and ``shard_for_process`` equal JAX's for
  one to four processes, their ``ValueError``s included; the partitioned
  encoder's seed of every shard equals JAX's ``_local_seed``; the
  refusals of a world that does not match its mesh.
* The partitioned ops in an 8-rank (2, 2, 2) gloo world (``tests/
  _torch_dist_worker.py``) against ``dvae_tpu.ops.partitioned`` on the
  8-device JAX mesh, each rank's blocks at the tolerances of
  tests/test_sharding.py:108-280 (values rtol 2e-4; gradients rtol 2e-4,
  atol 1e-5 for the MSE and encoder ops, rtol 5e-3, atol 3e-3 for ZINB,
  where JAX holds its own partitioned op to its oracle so), and the
  groups' rank lists.  The world has its own time limit and kills its
  ranks on expiry.
* ``cli train`` in two processes (``--mesh_data 2 --num_processes 2``,
  gloo on the CPU) logs the losses of one process: the first epoch's at
  rtol 1e-5, the second's at 5e-4.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import dvae_tpu.config as jcfg
from dvae_tpu.data import pipeline as jpipe
from dvae_tpu.ops import partitioned as jpart
from dvae_tpu.parallel import runtime as jrt
from dvae_tpu.parallel import sharding as jsh
from dvae_tpu.train import step as jstep

import dvae_tpu_torch.config as tcfg_mod
from dvae_tpu_torch.data import pipeline as tpipe
from dvae_tpu_torch.models import mixvae as tmixvae
from dvae_tpu_torch.ops import partitioned as tpart
from dvae_tpu_torch.parallel import runtime as trt
from dvae_tpu_torch.parallel import sharding as tsh
from dvae_tpu_torch.train import step as tstep

import _torch_dist_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

MESHES = [(2, 2, 2), (1, 4, 2), (2, 1, 4), (1, 1, 8), (8, 1, 1)]
DIMS = [dict(n_categories=8, input_dim=64, fc_dim=16, lowD_dim=8,
             state_dim=2, n_arm=2),
        dict(n_categories=5, input_dim=40, fc_dim=12, lowD_dim=6,
             state_dim=3, n_arm=3, mode="ZINB")]


def _spec_leaves(tree):
    """The leaves of a port spec tree (a spec tuple is a leaf), in JAX's
    order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _spec_leaves(tree[k])]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields") and (
            not tree or not isinstance(tree[0], (dict, tuple))
            or isinstance(tree, tsh.HostSpec)):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [v for sub in tree for v in _spec_leaves(sub)]
    return [tree]


def _jax_specs(tree):
    return [s for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (JAX's P() pads with None)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("dims", range(len(DIMS)))
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: "x".join(map(str, m)))
def test_placement_specs_match_jax_leaf_for_leaf(mesh_shape, dims):
    jc = jcfg.VAEConfig(**DIMS[dims])
    tc = tcfg_mod.VAEConfig(**DIMS[dims])
    jmesh = jsh.make_mesh(jcfg.MeshConfig(*mesh_shape))
    tmesh = tsh.mesh_layout(tcfg_mod.MeshConfig(*mesh_shape))
    tx = jstep.make_optimizer(jc)
    jstate = jax.eval_shape(lambda: jstep.init_train_state(
        jax.random.key(0), jc, tx))
    opt = tstep.make_optimizer(tc)
    params = tmixvae.init_params(torch.Generator().manual_seed(0), tc)
    bn = tmixvae.init_bn_state(tc)
    opt_state = opt.init(params)
    shapes = [p.shape for p in jax.tree_util.tree_leaves(jstate.params)]
    assert shapes == [tuple(p.shape) for p in tstep.tree_leaves(params)]
    for strat in jcfg.ShardingStrategy:
        tstrat = tcfg_mod.ShardingStrategy(strat.value)
        pairs = [
            (jsh.param_shardings(jstate.params, jmesh, strat),
             tsh.param_shardings(params, tmesh, tstrat),
             [p.shape for p in jax.tree_util.tree_leaves(jstate.params)]),
            (jsh.bn_shardings(jstate.bn, jmesh),
             tsh.bn_shardings(bn, tmesh),
             [p.shape for p in jax.tree_util.tree_leaves(jstate.bn)]),
        ]
        for off in (False, True):
            j = jsh.opt_state_shardings(jstate.opt_state, jmesh, strat,
                                        offload_host=off)
            t = tsh.opt_state_shardings(opt_state, tmesh, tstrat,
                                        offload_host=off)
            jl, tl = _jax_specs(j), _spec_leaves(t)
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                assert tuple(a.spec) == tuple(b), strat
                assert (a.memory_kind == "pinned_host") == \
                    isinstance(b, tsh.HostSpec), strat
        for j, t, shp in pairs:
            jl, tl = _jax_specs(j), _spec_leaves(t)
            assert len(jl) == len(tl) == len(shp)
            for a, b, s in zip(jl, tl, shp):
                assert _norm(a.spec, len(s)) == _norm(b, len(s)), (strat, s)
    for kw in ({}, {"batch_axis": 0, "ndim": 2, "arm_axis": None}):
        assert tuple(jsh.batch_sharding(jmesh, **kw).spec) == \
            tsh.batch_sharding(tmesh, **kw)
    assert tuple(jsh.replicated(jmesh).spec) == tsh.replicated(tmesh)


def test_full_and_hybrid_place_alike_and_blocks_tile_the_leaf():
    """``full`` and ``hybrid`` give one spec tree; every rank's block of a
    leaf is where its coordinates say, and the blocks tile it."""
    tc = tcfg_mod.VAEConfig(**DIMS[0])
    params = tmixvae.init_params(torch.Generator().manual_seed(1), tc)
    cfg = tcfg_mod.MeshConfig(2, 2, 2)
    S = tcfg_mod.ShardingStrategy
    specs = tsh.param_shardings(params, tsh.mesh_layout(cfg), S.FULL_SHARD)
    assert specs == tsh.param_shardings(params, tsh.mesh_layout(cfg),
                                        S.HYBRID_SHARD)
    w = params["fc1"]["w"]
    assert specs["fc1"]["w"] == ("arm", "fsdp", None)
    seen = torch.zeros_like(w)
    for r in range(8):
        m = tsh.mesh_layout(cfg, r)
        c = m.coords
        assert r == (c["data"] * 2 + c["arm"]) * 2 + c["fsdp"]
        blk = tsh.local_block(w, specs["fc1"]["w"], m)
        a, f = c["arm"], c["fsdp"]
        assert torch.equal(blk, w[a:a + 1, f * 32:(f + 1) * 32])
        seen[a:a + 1, f * 32:(f + 1) * 32] += 1
    assert bool((seen == 2).all())  # each block on the two data ranks


@pytest.mark.parametrize("procs", [1, 2, 3, 4])
def test_local_slice_and_shard_for_process_match_jax(procs, monkeypatch):
    for rank in range(procs):
        monkeypatch.setattr(jax, "process_count", lambda: procs)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(trt, "process_info", lambda: (rank, procs))
        for n, axis in ((24, 4), (25, 1), (36, 3), (30, 8), (12, 0)):
            try:
                want = jrt.local_slice(n, axis)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    trt.local_slice(n, axis)
                assert str(got.value) == str(e)
                continue
            assert trt.local_slice(n, axis) == want
        for n in (0, 1, 7, 10, 13):
            idx = np.arange(100, 100 + n)
            for even in (True, False):
                np.testing.assert_array_equal(
                    tpipe.shard_for_process(idx, rank, procs, even=even),
                    jpipe.shard_for_process(idx, rank, procs, even=even))


def test_distributed_loaders_match_jax():
    data = np.random.default_rng(0).random((53, 6), dtype=np.float32)
    labels = np.random.default_rng(1).integers(0, 3, 53)
    for rank in range(3):
        got = tpipe.get_loaders(data, labels, seed=2, batch_size=4,
                                use_dist_sampler=True, world_size=3,
                                rank=rank)
        want = jpipe.get_loaders(data, labels, seed=2, batch_size=4,
                                 use_dist_sampler=True, world_size=3,
                                 rank=rank)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for (gx, gi), (wx, wi) in zip(g, w):
                np.testing.assert_array_equal(gx, wx)
                np.testing.assert_array_equal(gi, wi)


AXIS_SETS = [(("arm",), ("data", "fsdp")), ((), ("data", "fsdp")),
             (("arm",), ()), ((), ("fsdp",)), ((), ("data",))]


@pytest.mark.parametrize("axes", AXIS_SETS,
                         ids=lambda a: "+".join(a[0] + a[1]) or "none")
def test_encoder_seed_of_every_shard_matches_jax(axes):
    """``local_seed(seed, off)`` with ``off`` over (arm, data, fsdp) is the
    integer JAX's partitioned encoder keys its shard's mask with
    (dvae_tpu/ops/partitioned.py:215-217), int32 wrap-around included."""
    shard_map = jax.shard_map
    arm_axes, batch_axes = axes
    jmesh = jsh.make_mesh(jcfg.MeshConfig(2, 2, 2))
    for seed in (0, 3, 2 ** 31 - 1, 1234567):
        def local(dummy):
            off = jpart._shard_offset(arm_axes + batch_axes)
            s = jnp.int32(seed) + off * jnp.int32(jpart._SEED_STRIDE)
            return jnp.broadcast_to(s, dummy.shape)
        fn = shard_map(local, mesh=jmesh, in_specs=P("data", "arm", "fsdp"),
                       out_specs=P("data", "arm", "fsdp"), check_vma=False)
        want = np.asarray(fn(jnp.zeros((2, 2, 2), jnp.int32)))
        for r in range(8):
            m = tsh.mesh_layout(tcfg_mod.MeshConfig(2, 2, 2), r)
            c = m.coords
            op = tpart.make_partitioned_dropout_fc1(arm_axes, batch_axes, m,
                                                    0.5)
            assert op.offset == m.axis_index(arm_axes + batch_axes)
            assert tpart.local_seed(seed, op.offset) == \
                int(want[c["data"], c["arm"], c["fsdp"]])


def test_a_world_that_does_not_match_its_mesh_is_refused(monkeypatch):
    with pytest.raises(ValueError, match="--num_processes 2"):
        tsh.make_mesh(tcfg_mod.MeshConfig(data=2))
    assert tsh.make_mesh(tcfg_mod.MeshConfig()).groups == {}
    trt.initialize_distributed(None, None, None)   # one process: no-op
    trt.initialize_distributed(None, 1, 0)
    assert trt.process_info() == (0, 1)
    with pytest.raises(ValueError, match="--coordinator"):
        trt.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="outside"):
        trt.initialize_distributed("127.0.0.1:1", 2, 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="two ranks on one device"):
        trt.initialize_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    with pytest.raises(RuntimeError, match="without a world"):
        tsh.Mesh(tcfg_mod.MeshConfig(data=2)).batch_group


# ---------------------------------------------------------------------------
# The partitioned ops in an 8-rank world
# ---------------------------------------------------------------------------

A, B, F, D = 4, 64, 16, 40


def _ops_inputs():
    r = np.random.default_rng(0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    inp = {
        "ops/h": f32(r.normal(size=(A, B, F))),
        "ops/w": f32(0.1 * r.normal(size=(A, F, D))),
        "ops/b": f32(0.1 * r.normal(size=(A, D))),
        "ops/x": f32(np.maximum(r.normal(0.5, 1, (B, D)), 0)),
        "ops/enc_x": f32(np.maximum(r.normal(0.5, 1, (B, D)), 0)),
        "ops/enc_w": f32(0.1 * r.normal(size=(A, D, F))),
        "ops/enc_b": f32(0.1 * r.normal(size=(A, F))),
        "ops/zh": f32(r.normal(size=(A, B, F))),
        "ops/zx": f32(np.maximum(r.normal(0.8, 1, (B, D)), 0)
                      * (r.random((B, D)) > 0.5)),
    }
    from dvae_tpu.ops.encoder_pallas import dropout_mask_host
    inp["ops/enc_mask"] = np.asarray(dropout_mask_host(3, (A, B, D), 0.5))
    for k in ("wr", "wp", "wz"):
        inp[f"ops/z{k}"] = f32(0.1 * r.normal(size=(A, F, D)))
    for k in ("br", "bp", "bz"):
        inp[f"ops/z{k}"] = f32(0.1 * r.normal(size=(A, D)))
    return inp


def _jax_ops(inp):
    """JAX's partitioned ops on the 8-device mesh: values and gradients."""
    mesh = jsh.make_mesh(jcfg.MeshConfig(2, 2, 2))
    put = lambda t, s: jax.device_put(jnp.asarray(t), NamedSharding(mesh, s))  # noqa: E731,E501
    arm_b = P("arm", ("data", "fsdp"), None)
    out = {}
    wgt = jnp.arange(1, A + 1, dtype=jnp.float32)
    op = jpart.make_partitioned_recon(("arm",), ("data", "fsdp"))
    hs, ws, bs = (put(inp["ops/h"], arm_b), put(inp["ops/w"], P("arm")),
                  put(inp["ops/b"], P("arm")))
    x = inp["ops/x"]
    for name, xt, spec in (("shared", x, P(("data", "fsdp"), None)),
                           ("per_arm", np.broadcast_to(x, (A, B, D)), arm_b)):
        xts = put(xt, spec)
        s, m = jax.jit(op)(hs, ws, bs, xts)
        g = jax.jit(jax.grad(
            lambda h, w, b: jnp.sum(op(h, w, b, xts)[0] * wgt),
            (0, 1, 2)))(hs, ws, bs)
        out[name] = dict(sumsq=s, mism=m, dh=g[0], dw=g[1], db=g[2])
    enc = jpart.make_partitioned_dropout_fc1(("arm",), ("data", "fsdp"), 0.5)
    xts = put(inp["ops/enc_x"], P(("data", "fsdp"), None))
    ms = put(inp["ops/enc_mask"], arm_b)
    ew, eb = put(inp["ops/enc_w"], P("arm")), put(inp["ops/enc_b"], P("arm"))
    y = jax.jit(lambda w, b: enc(jnp.int32(3), xts, w, b, ms))(ew, eb)
    g = jax.jit(jax.grad(
        lambda w, b: jnp.sum(jnp.sin(enc(jnp.int32(3), xts, w, b, ms))),
        (0, 1)))(ew, eb)
    out["enc"] = dict(y=y, dw=g[0], db=g[1])
    zop = jpart.make_partitioned_zinb(("arm",), ("data", "fsdp"))
    args = [put(inp["ops/zh"], arm_b)] + [
        put(inp[f"ops/z{k}"], P("arm"))
        for k in ("wr", "br", "wp", "bp", "wz", "bz")]
    zx = put(inp["ops/zx"], P(("data", "fsdp"), None))
    loss = jax.jit(lambda *a: zop(*a, zx))(*args)
    g = jax.jit(jax.grad(lambda *a: jnp.sum(zop(*a, zx) * wgt),
                         tuple(range(7))))(*args)
    out["zinb"] = dict(loss=loss, **dict(zip(
        ("dh", "dwr", "dbr", "dwp", "dbp", "dwz", "dbz"), g)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def ops_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("ops_world")
    inp = _ops_inputs()
    np.savez(d / "inputs.npz", **inp)
    (d / "cases.json").write_text("{}")
    outs = worker.spawn_world(str(d), 8, (2, 2, 2), ["ops"], timeout=240)
    return inp, _jax_ops(inp), outs


VAL = dict(rtol=2e-4)
GRAD = dict(rtol=2e-4, atol=1e-5)
ZGRAD = dict(rtol=5e-3, atol=3e-3)


def _blocks(outs, key):
    """(arm slice, row slice, array) of every rank."""
    for o in outs:
        a0, a1 = o["ops/arms"]
        r0, r1 = o["ops/rows"]
        yield slice(a0, a1), slice(r0, r1), o[key]


@pytest.mark.parametrize("x_kind", ["shared", "per_arm"])
def test_partitioned_recon_matches_jax_on_every_rank(ops_world, x_kind):
    _, want, outs = ops_world
    w = want[x_kind]
    for arms, rows, v in _blocks(outs, f"ops/recon/{x_kind}/sumsq"):
        np.testing.assert_allclose(v, w["sumsq"][arms], **VAL)
    for suffix in ("", "_value"):
        for arms, rows, v in _blocks(outs, f"ops/recon/{x_kind}/sumsq"
                                           f"{suffix}"):
            np.testing.assert_allclose(v, w["sumsq"][arms], **VAL)
        for arms, rows, v in _blocks(outs, f"ops/recon/{x_kind}/mism"
                                           f"{suffix}"):
            np.testing.assert_array_equal(v, w["mism"][arms])
    for arms, rows, v in _blocks(outs, f"ops/recon/{x_kind}/dh"):
        np.testing.assert_allclose(v, w["dh"][arms, rows], **GRAD)
    for k in ("dw", "db"):
        for arms, rows, v in _blocks(outs, f"ops/recon/{x_kind}/{k}"):
            np.testing.assert_allclose(v, w[k][arms], **GRAD)


def test_partitioned_encoder_matches_jax_on_every_rank(ops_world):
    _, want, outs = ops_world
    w = want["enc"]
    for arms, rows, v in _blocks(outs, "ops/enc/y"):
        np.testing.assert_allclose(v, w["y"][arms, rows], rtol=1e-5,
                                   atol=1e-5)
    for k in ("dw", "db"):
        for arms, rows, v in _blocks(outs, f"ops/enc/{k}"):
            np.testing.assert_allclose(v, w[k][arms], **GRAD)
    cfg = tcfg_mod.MeshConfig(2, 2, 2)
    for r, o in enumerate(outs):
        m = tsh.mesh_layout(cfg, r)
        assert int(o["ops/enc/offset"][0]) == m.axis_index(
            ("arm", "data", "fsdp"))


def test_partitioned_zinb_matches_jax_on_every_rank(ops_world):
    _, want, outs = ops_world
    w = want["zinb"]
    for arms, rows, v in _blocks(outs, "ops/zinb/loss"):
        np.testing.assert_allclose(v, w["loss"][arms], **VAL)
    for arms, rows, v in _blocks(outs, "ops/zinb/dh"):
        np.testing.assert_allclose(v, w["dh"][arms, rows], **ZGRAD)
    for k in ("dwr", "dbr", "dwp", "dbp", "dwz", "dbz"):
        for arms, rows, v in _blocks(outs, f"ops/zinb/{k}"):
            np.testing.assert_allclose(v, w[k][arms], **ZGRAD)


def test_partitioned_ops_equal_the_whole_batch_op(ops_world):
    """The blocks of the 8 ranks against the port's own op on the whole
    batch in one process."""
    from dvae_tpu_torch.ops.recon import fused_recon_mse
    inp, _, outs = ops_world
    t = {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}
    h = t["ops/h"].clone().requires_grad_()
    w = t["ops/w"].clone().requires_grad_()
    b = t["ops/b"].clone().requires_grad_()
    s, _ = fused_recon_mse(h, w, b, t["ops/x"])
    (s * torch.arange(1, A + 1)).sum().backward()
    for arms, rows, v in _blocks(outs, "ops/recon/shared/sumsq"):
        np.testing.assert_allclose(v, s.detach().numpy()[arms], rtol=1e-5)
    for arms, rows, v in _blocks(outs, "ops/recon/shared/dh"):
        np.testing.assert_allclose(v, h.grad.numpy()[arms, rows], rtol=1e-5,
                                   atol=1e-6)
    for arms, rows, v in _blocks(outs, "ops/recon/shared/dw"):
        np.testing.assert_allclose(v, w.grad.numpy()[arms], rtol=1e-5,
                                   atol=1e-5)


def test_runtime_collectives_on_every_rank(ops_world):
    """all_reduce, all_gather, flat_reduce_scatter (two tensors, cut
    along dims 0 and 1), broadcast and broadcast_string over each rank's
    batch group (4 ranks: the ranks that share its arm), and
    global_batch's shape check, on every rank."""
    _, _, outs = ops_world
    base = np.arange(12.0).reshape(4, 3)
    for r, o in enumerate(outs):
        group = list(o["groups/batch"])
        i = group.index(r)
        total = sum(base + q for q in group)
        np.testing.assert_array_equal(o["coll/all_reduce"], total)
        np.testing.assert_array_equal(o["coll/all_gather"],
                                      np.tile(np.array(group, float), (4, 1)))
        np.testing.assert_array_equal(o["coll/reduce_scatter"],
                                      total[i:i + 1])
        np.testing.assert_array_equal(o["coll/reduce_scatter_dim1"],
                                      total.T[:, i:i + 1] * 10)
        np.testing.assert_array_equal(o["coll/broadcast"], base + group[1])
        assert str(o["coll/string"][0]) == f"rank {group[2]}"
        assert o["coll/global_batch"].tolist() == [4, 3]
        assert int(o["coll/shape_refused"][0]) == 1


def test_process_groups_have_the_documented_ranks(ops_world):
    """Every rank's four groups, from r = (d·arm + a)·fsdp + f."""
    _, _, outs = ops_world
    for r, o in enumerate(outs):
        d, rest = divmod(r, 4)
        a, f = divmod(rest, 2)
        want = {
            "arm": [(d * 2 + aa) * 2 + f for aa in range(2)],
            "batch": [(dd * 2 + a) * 2 + ff for dd in range(2)
                      for ff in range(2)],
            "fsdp": [(d * 2 + a) * 2 + ff for ff in range(2)],
            "data": [(dd * 2 + a) * 2 + f for dd in range(2)],
        }
        for k, v in want.items():
            assert o[f"groups/{k}"].tolist() == v, (r, k)


# ---------------------------------------------------------------------------
# cli train in two processes
# ---------------------------------------------------------------------------

def _cli_args(folder, *extra):
    return [sys.executable, "-m", "dvae_tpu_torch.cli", "train", "--device",
            "cpu", "--synthetic", "--syn_cells", "90", "--syn_genes", "24",
            "--syn_types", "4", "--n_categories", "4", "--n_arm", "2",
            "--fc_dim", "8", "--latent_dim", "4", "--batch_size", "16",
            "--n_epoch", "2", "--epochs_per_jit", "1", "--saving_folder",
            str(folder) + "/", *extra]


def _run_losses(folder):
    (run,) = [p for p in folder.iterdir() if p.is_dir()]
    with open(run / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return [r["train/loss"] for r in rows if "train/loss" in r]


def test_cli_train_in_two_processes_logs_one_process_losses(tmp_path):
    """Rank 0's log holds the first epoch's loss of one process (rtol
    1e-5) and the second's within JAX's multi- versus single-device
    tolerance (5e-4, tests/test_sharding.py:214): the default tau = 0.005
    sharpens the rounding of the first epoch's sums into it."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    one = subprocess.run(_cli_args(tmp_path / "one"), env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=240)
    assert one.returncode == 0, one.stderr[-3000:]
    port = worker.free_port()
    procs = [subprocess.Popen(
        _cli_args(tmp_path / "two", "--mesh_data", "2", "--num_processes",
                  "2", "--process_id", str(r), "--coordinator",
                  f"127.0.0.1:{port}", "--dist_backend", "gloo"),
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    # one run folder for the world, rank 0's
    assert len([p for p in (tmp_path / "two").iterdir() if p.is_dir()]) == 1
    two, one = _run_losses(tmp_path / "two"), _run_losses(tmp_path / "one")
    assert len(two) == len(one) == 2
    np.testing.assert_allclose(two[0], one[0], rtol=1e-5)
    np.testing.assert_allclose(two[1], one[1], rtol=5e-4)
