"""One rank of the port's multi-process tests, and the launcher of a world.

``spawn_world`` starts ``world`` copies of this file as the ranks of a
``torch.distributed`` gloo world on the CPU (modelled on tests/_dcn_worker
.py), waits for them under one time limit and kills every rank on expiry
or on the first failure.  Each rank joins the world, builds the mesh, runs
the named cases in order (every rank runs every case: their collectives
are matched) and writes ``out_{rank}.npz``.  The inputs come from the
test process as ``inputs.npz`` (flat keys, ``/`` between the levels of a
tree) and ``cases.json``.

The worker imports neither JAX nor the JAX package: the tests hold its
outputs to the JAX package's in their own process.  It runs with one
thread (``torch.set_num_threads(1)``): a world is many processes on few
cores.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# ---------------------------------------------------------------------------
# The launcher (test process side; stdlib only)
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(out_dir: str, world: int, mesh, cases, timeout: float = 300):
    """Run ``cases`` on ``world`` ranks over ``mesh`` (data, arm, fsdp);
    returns the list of each rank's outputs (dicts of numpy arrays).
    Raises with the ranks' stderr if any rank fails or the world outlives
    ``timeout`` seconds (every rank is killed first)."""
    import numpy as np
    port = free_port()
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dir", out_dir,
             "--rank", str(r), "--world", str(world), "--port", str(port),
             "--mesh", ",".join(map(str, mesh)), "--cases", ",".join(cases)],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                failed = f"the world outlived its {timeout} s limit"
                break
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed:
        text = []
        for r, log in enumerate(logs):
            log.seek(0)
            text.append(f"--- rank {r}\n" + log.read()[-3000:])
        raise RuntimeError(failed + "\n" + "\n".join(text))
    for log in logs:
        log.close()
    outs = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"out_{r}.npz")) as f:
            outs.append({k: f[k] for k in f.files})
    return outs


# ---------------------------------------------------------------------------
# Trees in flat npz keys
# ---------------------------------------------------------------------------

def flat(prefix: str, tree, out: dict) -> dict:
    """Write a nested dict of arrays under ``prefix/...`` keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = tree
    return out


def unflat(prefix: str, arrays: dict) -> dict:
    tree: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


# ---------------------------------------------------------------------------
# The cases (rank side)
# ---------------------------------------------------------------------------

def _tensors(tree):
    import numpy as np
    import torch
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def case_ops(ctx):
    """The three partitioned ops on this rank's blocks: values and the
    gradients of the weighted sums the JAX tests take."""
    import torch
    from dvae_tpu_torch.ops import partitioned as P
    from dvae_tpu_torch.parallel.sharding import Spmd
    arr, mesh, out = ctx["inputs"], ctx["mesh"], ctx["out"]
    A, B = arr["ops/h"].shape[:2]
    sp = Spmd(mesh, ("arm",), ("data", "fsdp"), A, B)
    arms, rows = sp.arms, sp.rows
    from dvae_tpu_torch.parallel import runtime as R
    for name in ("arm", "batch", "fsdp", "data"):
        out[f"groups/{name}"] = list(getattr(mesh, f"{name}_group").ranks)
    # the collectives of the runtime on this rank's group of the batch
    g, r = mesh.batch_group, ctx["rank"]
    t = torch.arange(12.0).reshape(4, 3) + r
    out["coll/all_reduce"] = R.all_reduce(t, g).numpy()
    out["coll/all_gather"] = R.all_gather(t[:, :1] * 0 + r, g, 1).numpy()
    rs = R.flat_reduce_scatter([t, t.T * 10], [0, 1], g)
    out["coll/reduce_scatter"] = rs[0].numpy()
    out["coll/reduce_scatter_dim1"] = rs[1].numpy()
    out["coll/broadcast"] = R.broadcast(t.clone(), 1, g).numpy()
    out["coll/string"] = [R.broadcast_string(f"rank {r}", g, "cpu", 2)]
    out["coll/global_batch"] = list(R.global_batch(t, g).shape)
    try:
        R.global_batch(t[: 1 + r % 2], g)
        out["coll/shape_refused"] = [0]
    except ValueError:
        out["coll/shape_refused"] = [1]
    R.barrier(mesh.world, "cpu")
    out["ops/arms"] = [arms.start, arms.stop]
    out["ops/rows"] = [rows.start, rows.stop]
    wgt = torch.arange(1, A + 1, dtype=torch.float32)[arms]
    t = lambda k: torch.from_numpy(arr[k])  # noqa: E731

    recon = P.make_partitioned_recon(("arm",), ("data", "fsdp"), mesh)
    for name, x in (("shared", t("ops/x")[rows]),
                    ("per_arm", t("ops/x").expand(A, -1, -1)[arms, rows])):
        h = t("ops/h")[arms, rows].requires_grad_()
        w = t("ops/w")[arms].requires_grad_()
        b = t("ops/b")[arms].requires_grad_()
        s, m = recon(h, w, b, x)
        (s * wgt).sum().backward()
        with torch.no_grad():
            s0, m0 = recon(h, w, b, x)
        for k, v in (("sumsq", s), ("mism", m), ("dh", h.grad),
                     ("dw", w.grad), ("db", b.grad), ("sumsq_value", s0),
                     ("mism_value", m0)):
            out[f"ops/recon/{name}/{k}"] = v.detach().numpy()

    enc = P.make_partitioned_dropout_fc1(("arm",), ("data", "fsdp"), mesh,
                                         0.5)
    w = t("ops/enc_w")[arms].requires_grad_()
    b = t("ops/enc_b")[arms].requires_grad_()
    y = enc(3, t("ops/enc_x")[rows], w, b,
            t("ops/enc_mask")[arms, rows])
    torch.sin(y).sum().backward()
    out["ops/enc/y"] = y.detach().numpy()
    out["ops/enc/dw"] = w.grad.numpy()
    out["ops/enc/db"] = b.grad.numpy()
    out["ops/enc/offset"] = [enc.offset]

    zinb = P.make_partitioned_zinb(("arm",), ("data", "fsdp"), mesh)
    h = t("ops/zh")[arms, rows].requires_grad_()
    heads = [t(f"ops/z{k}")[arms].requires_grad_()
             for k in ("wr", "br", "wp", "bp", "wz", "bz")]
    loss = zinb(h, *heads, t("ops/zx")[rows])
    (loss * wgt).sum().backward()
    out["ops/zinb/loss"] = loss.detach().numpy()
    for k, v in zip(("dh", "dwr", "dbr", "dwp", "dbp", "dwz", "dbz"),
                    (h, *heads)):
        out[f"ops/zinb/{k}"] = v.grad.numpy()


def _configs(spec):
    from dvae_tpu_torch.config import (MeshConfig, ShardingStrategy,
                                       TrainConfig, VAEConfig)
    cfg = VAEConfig(**spec["cfg"])
    tc = dict(spec.get("tcfg", {}))
    tc["sharding"] = ShardingStrategy(tc.get("sharding", "full"))
    tc["mesh"] = MeshConfig(*spec["mesh"])
    return cfg, TrainConfig(**tc)


def _steps(ctx, prefix, cfg, tcfg, mesh, n_steps):
    """``n_steps`` mesh train steps from the weights under ``prefix`` on
    its batches and noise; the metrics and the whole state after them."""
    import numpy as np
    import torch
    from dvae_tpu_torch.models.mixvae import Noise
    from dvae_tpu_torch.parallel.sharding import (gather_state, place_state,
                                                  state_specs)
    from dvae_tpu_torch.train import step as ts
    arr = ctx["inputs"]
    opt = ts.make_optimizer(cfg)
    params = _tensors(unflat(f"{prefix}/params", arr))
    st = ts.TrainState(params, _tensors(unflat(f"{prefix}/bn", arr)),
                       torch.ones(cfg.n_categories), 0, 0, opt.init(params))
    specs = state_specs(cfg, tcfg.sharding, mesh)
    st = place_state(st, specs, mesh)
    step = ts.make_train_step(cfg, tcfg, opt, mesh=mesh)
    update, updates = opt.update, []
    opt.update = lambda *a: updates.append(1) or update(*a)
    totals, recs, labels = [], [], []
    for i in range(n_steps):
        noise = Noise(*(torch.from_numpy(arr[f"{prefix}/noise/{k}"][i])
                        if f"{prefix}/noise/{k}" in arr else None
                        for k in ("x_mask", "gumbel_u", "reparam_e",
                                  "s_mask")))
        st, m, lab = step(st, torch.from_numpy(arr[f"{prefix}/x"][i]), None,
                          1.0, noise=noise)
        totals.append(float(m.total))
        recs.append(m.loss_rec.numpy())
        labels.append(lab.numpy())
    # the mesh step's update is ``Adam.update`` on the moments' blocks,
    # once a step
    assert len(updates) == n_steps == st.opt_state.count, updates
    whole = gather_state(st, specs, mesh)
    return (np.array(totals), np.array(recs), labels, whole)


def case_train(ctx):
    """Each train case of cases.json: the steps on this mesh."""
    out, mesh = ctx["out"], ctx["mesh"]
    for spec in ctx["cases"]["train"]:
        cfg, tcfg = _configs(spec)
        totals, recs, _, whole = _steps(ctx, spec["prefix"], cfg, tcfg, mesh,
                                        spec["steps"])
        p = spec["name"]
        out[f"train/{p}/total"] = totals
        out[f"train/{p}/loss_rec"] = recs
        flat(f"train/{p}/params", _numpy(whole.params), out)
        flat(f"train/{p}/bn", _numpy(whole.bn), out)


def case_strategies(ctx):
    """The six strategies from one state on one noise."""
    from dvae_tpu_torch.config import ShardingStrategy
    out, mesh = ctx["out"], ctx["mesh"]
    spec = ctx["cases"]["strategies"]
    for s in ShardingStrategy:
        cfg, tcfg = _configs({**spec, "tcfg": {**spec.get("tcfg", {}),
                                               "sharding": s.value}})
        totals, _, _, whole = _steps(ctx, spec["prefix"], cfg, tcfg, mesh,
                                     spec["steps"])
        out[f"strategies/{s.value}/total"] = totals
        flat(f"strategies/{s.value}/params", _numpy(whole.params), out)


def case_align(ctx):
    """``align_state`` on this rank's blocks under ``full``: the whole
    state after it."""
    import torch
    from dvae_tpu_torch.parallel.sharding import (gather_state, place_state,
                                                  state_specs)
    from dvae_tpu_torch.train import alignment, step as ts
    out, mesh, arr = ctx["out"], ctx["mesh"], ctx["inputs"]
    spec = ctx["cases"]["align"]
    cfg, tcfg = _configs(spec)
    params = _tensors(unflat("align/params", arr))
    opt_state = ts.AdamState(3, _tensors(unflat("align/mu", arr)),
                             _tensors(unflat("align/nu", arr)))
    st = ts.TrainState(params, _tensors(unflat("align/bn", arr)),
                       torch.ones(cfg.n_categories), 0, 0, opt_state)
    specs = state_specs(cfg, tcfg.sharding, mesh)
    st = place_state(st, specs, mesh)
    st, m, moved = alignment.align_state(st, arr["align/labels"], cfg,
                                         shards=(specs, mesh))
    whole = gather_state(st, specs, mesh)
    out["align/m"] = m
    out["align/moved"] = [moved]
    flat("align/params", _numpy(whole.params), out)
    flat("align/mu", _numpy(whole.opt_state.mu), out)
    flat("align/nu", _numpy(whole.opt_state.nu), out)


def case_eval(ctx):
    """The mesh eval step on a batch the batch axes cannot divide, fused
    and unfused, and on one they divide."""
    import torch
    from dvae_tpu_torch.parallel.sharding import place_state, state_specs
    from dvae_tpu_torch.train import step as ts
    out, mesh, arr = ctx["out"], ctx["mesh"], ctx["inputs"]
    spec = ctx["cases"]["eval"]
    cfg, tcfg = _configs(spec)
    opt = ts.make_optimizer(cfg)
    params = _tensors(unflat("eval/params", arr))
    st = ts.TrainState(params, _tensors(unflat("eval/bn", arr)),
                       torch.ones(cfg.n_categories), 7, 0, opt.init(params))
    st = place_state(st, state_specs(cfg, tcfg.sharding, mesh), mesh)
    for fused in (True, False):
        c = cfg.replace(fused_recon=fused)
        ev = ts.make_eval_step(c, tcfg, mesh=mesh)
        for name in ("odd", "even"):
            aux, lab, outs = ev(st, torch.from_numpy(arr[f"eval/{name}"]),
                                None, 1.0)
            key = f"eval/{name}/{'fused' if fused else 'plain'}"
            out[key + "/total"] = [float(aux.total)]
            out[key + "/loss_rec"] = aux.loss_rec.numpy()
            out[key + "/labels"] = lab.numpy()
            out[key + "/c"] = outs.c.numpy()
            out[key + "/s_mean"] = outs.s_mean.numpy()


def case_trainer(ctx):
    """``CplMixVAE`` on the mesh: init → train → save → eval_model."""
    from dvae_tpu_torch.config import MeshConfig
    from dvae_tpu_torch.parallel.sharding import gather_state
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    out, arr = ctx["out"], ctx["inputs"]
    spec = ctx["cases"]["trainer"]
    cpl = CplMixVAE(saving_folder=spec["folder"], device="cpu", seed=5)
    cpl.init_model(**spec["init"], mesh=MeshConfig(*spec["mesh"]))
    path = cpl.train(arr["trainer/x"], n_epoch=spec["n_epoch"],
                     save_plots=False, early_stop_consensus=0)
    res = cpl.eval_model(arr["trainer/x_eval"], batch_size=spec["eval_batch"])
    whole = gather_state(cpl.state, cpl.specs, cpl.mesh)
    out["trainer/path"] = [path]
    out["trainer/labels"] = res["pred_label"]
    out["trainer/c_prob"] = res["c_prob"]
    out["trainer/total_loss"] = [res["total_loss"]]
    out["trainer/epoch"] = [cpl.state.epoch]
    flat("trainer/params", _numpy(whole.params), out)
    flat("trainer/mu", _numpy(whole.opt_state.mu), out)
    out["trainer/device"] = [str(cpl.device)]


def case_stream(ctx):
    """This rank's streamed batches of two epochs."""
    import torch
    from dvae_tpu_torch.data.stream import BatchStreamer
    out, mesh, arr = ctx["out"], ctx["mesh"], ctx["inputs"]
    spec = ctx["cases"]["stream"]
    s = BatchStreamer(torch.from_numpy(arr["stream/x"]), spec["batch"],
                      prior=arr["stream/prior"], seed=spec["seed"],
                      device="cpu", mesh=mesh)
    out["stream/rows_local"] = [int(s.rows_local)]
    for e in range(2):
        for i, b in enumerate(s.epoch(e)):
            out[f"stream/{e}/{i}/x"] = b.x.numpy()
            out[f"stream/{e}/{i}/prior"] = b.prior.numpy()


def _json(out, key, obj):
    out[key] = [json.dumps(obj)]


def case_census(ctx):
    """The collective census: the runner's collectives at test_collective_
    cost.py's CFG/TCFG on (2, 1, 4), the census rows of the six strategies
    × three modes on the world's (2, 2, 2) mesh, and ``small_equality`` on
    the port's own draws and on JAX's (weights and noise carried)."""
    import torch
    from dvae_tpu_torch.config import (MeshConfig, ShardingStrategy,
                                       TrainConfig, VAEConfig)
    from dvae_tpu_torch.models.mixvae import Noise
    from dvae_tpu_torch.parallel import census
    from dvae_tpu_torch.parallel.collective_cost import (
        epoch_runner_collective_stats)
    from dvae_tpu_torch.parallel.sharding import make_mesh
    from dvae_tpu_torch.train import step as ts
    from dvae_tpu_torch.utils.checkpoint import bn_from_jax, params_from_jax
    out, mesh, arr = ctx["out"], ctx["mesh"], ctx["inputs"]
    spec = ctx["cases"]["census"]
    m214 = make_mesh(MeshConfig(2, 1, 4))
    cfg = VAEConfig(**spec["cfg"])
    tcfg = TrainConfig(batch_size=spec["batch"], epochs_per_jit=1)
    for s in ("ddp", "full", "no"):
        st = epoch_runner_collective_stats(cfg, tcfg, ShardingStrategy(s),
                                           m214, n_train=spec["n_train"],
                                           device="cpu")
        _json(out, f"census/stats/{s}", dict(
            counts=st.counts, bytes_by_kind=st.bytes_by_kind,
            wire_bytes=st.wire_bytes))
    rows = []
    for mode in census.MODES:
        for s in ShardingStrategy:
            row = census.production_row(
                s, mode, mesh, n_train=2 * spec["row_batch"],
                batch=spec["row_batch"], cfg=census.small_cfg(mode).replace(
                    input_dim=spec["row_genes"]), bf16=False, device="cpu")
            rows.append(row.to_json())
    _json(out, "census/rows", rows)
    for mode in census.MODES:
        losses = census.small_equality(mode, mesh, device="cpu")
        _json(out, f"census/equality/{mode}",
              {k: v.tolist() for k, v in losses.items()})
    for mode in spec["jax_modes"]:
        pre = f"census/jax/{mode}"
        state = ts.TrainState(
            params_from_jax(unflat(f"{pre}/params", arr)),
            bn_from_jax(unflat(f"{pre}/bn", arr)),
            torch.ones(8), 0, 0)
        draws = [(torch.from_numpy(arr[f"{pre}/x"][i]), Noise(*(
            torch.from_numpy(arr[f"{pre}/noise/{k}"][i])
            for k in ("x_mask", "gumbel_u", "reparam_e", "s_mask"))))
            for i in range(arr[f"{pre}/x"].shape[0])]
        losses = census.small_equality(mode, mesh, device="cpu", state=state,
                                       draws=draws)
        _json(out, f"census/carried/{mode}",
              {k: v.tolist() for k, v in losses.items()})


def _carried(weights, cfg):
    """An MNIST FitModule whose weights are JAX's ``init_mlp`` draw."""
    from dvae_tpu_torch.train.fit import MNISTFitModule
    from dvae_tpu_torch.utils.checkpoint import mlp_params_from_jax

    class Carried(MNISTFitModule):
        def init_params(self, generator):
            return mlp_params_from_jax(weights)
    return Carried(cfg=cfg)


def _mlp_weights(arr, prefix):
    n = len({k.split("/")[2] for k in arr if k.startswith(prefix + "/")})
    return [{k: arr[f"{prefix}/{i}/{k}"] for k in ("w", "b")}
            for i in range(n)]


def case_fit(ctx):
    """``Trainer(devices=8)`` from JAX's weights for each run of
    cases.json, and ``train_mnist_fsdp(n_devices=8)``."""
    from dvae_tpu_torch.examples import fsdp_tutorial as tt
    from dvae_tpu_torch.train.fit import Trainer
    from dvae_tpu_torch.utils.checkpoint import mlp_params_from_jax
    out, arr = ctx["out"], ctx["inputs"]
    spec = ctx["cases"]["fit"]
    cfg = tt.MLPConfig(widths=tuple(spec["widths"]))
    w = _mlp_weights(arr, "fit/w")
    for run in spec["runs"]:
        t = Trainer(max_epochs=2, strategy=run["strategy"], devices=8,
                    use_distributed_sampler=run["sampler"], device="cpu")
        t.fit(_carried(w, cfg), (arr["fit/x"], arr["fit/y"]),
              val_data=(arr[f"fit/{run['val']}x"], arr[f"fit/{run['val']}y"]),
              batch_size=128, val_batch_size=run["vbs"])
        _json(out, f"fit/{run['name']}/history", t.history)
        for i, layer in enumerate(t.params):
            for k, v in layer.items():
                out[f"fit/{run['name']}/params/{i}/{k}"] = v.numpy()
    wt = _mlp_weights(arr, "tut/w")
    tt.init_mlp = lambda g, c, device="cuda": mlp_params_from_jax(wt, device)
    for s in spec["tutorial"]:
        res = tt.train_mnist_fsdp(
            model="shallow", strategy=s, n_epochs=2, batch_size=256,
            lr=1e-2, verbose=False, n_devices=8,
            data=(arr["tut/x"], arr["tut/y"]),
            test_data=(arr["tut/tx"], arr["tut/ty"]), device="cpu")
        _json(out, f"tut/{s}", res._asdict())


def case_sweep(ctx):
    """``run_sweep`` over full and ddp on the whole world and on its first
    4 ranks."""
    from dvae_tpu_torch.bench import sweep
    out, arr = ctx["out"], ctx["inputs"]
    spec = ctx["cases"]["sweep"]
    cfgs = sweep.gen_configs(strategies=("full", "ddp"),
                             device_counts=(None, 4), n_epochs=1,
                             batch_size=256)
    res = sweep.run_sweep(cfgs, out_path=spec["out"], verbose=False,
                          device="cpu", data=(arr["tut/x"], arr["tut/y"]),
                          test_data=(arr["tut/tx"], arr["tut/ty"]))
    _json(out, "sweep/results", res)


def case_arm(ctx):
    """The stacked forward on an ``arm=2`` mesh of the world's first two
    ranks, and the benchmark with ``shard``."""
    import torch
    from dvae_tpu_torch.config import VAEConfig
    from dvae_tpu_torch.examples import arm_parallelism as ap
    from dvae_tpu_torch.models import mixvae
    out = ctx["out"]
    spec = ctx["cases"]["arm"]
    cfg = VAEConfig(**spec["cfg"])
    params = mixvae.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    bn = mixvae.init_bn_state(cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.rand((spec["batch"], cfg.input_dim), generator=g)
    xs = x.expand(cfg.n_arm, *x.shape)
    noise = ap.arm_draws(cfg, spec["batch"], g)
    mesh = ap.arm_mesh(cfg.n_arm)
    if mesh is not None:
        p_l, bn_l, xs_l, noise_l, spmd = ap.sharded_inputs(
            mesh, params, bn, cfg, xs, noise)
        total, rec, kl = ap.stacked_forward(p_l, bn_l, cfg, xs_l, noise_l,
                                            spmd)
        out["arm/total"] = [float(total)]
        out["arm/loss_rec"] = rec.numpy()
        out["arm/kl"] = kl.numpy()
    res = ap.benchmark_arm_strategies(cfg, batch_size=spec["batch"],
                                      n_iters=2, shard=True, device="cpu")
    _json(out, "arm/keys", sorted(res))


def case_ckpt(ctx):
    """``save_sharded`` of a trained ``full`` state on (2, 2, 2); restored
    to the same specs (the next chunk of both), onto ``no`` on (8, 1, 1)
    and, with ``offload_host`` moments, to the same specs."""
    import torch
    from dvae_tpu_torch.config import MeshConfig
    from dvae_tpu_torch.parallel.sharding import (gather_state, make_mesh,
                                                  place_state, state_specs)
    from dvae_tpu_torch.train import step as ts
    from dvae_tpu_torch.utils.checkpoint import restore_sharded, save_sharded
    out, mesh, arr = ctx["out"], ctx["mesh"], ctx["inputs"]
    spec = ctx["cases"]["ckpt"]
    cfg, tcfg = _configs(spec)
    opt = ts.make_optimizer(cfg)
    x = torch.from_numpy(arr["ckpt/x"])
    run = ts.make_epoch_runner(cfg, tcfg, opt, x.shape[0], mesh=mesh)

    def fresh(specs, m, seed):
        return place_state(ts.init_train_state(seed, cfg, opt), specs, m)

    specs = state_specs(cfg, "full", mesh)
    st, _ = run(fresh(specs, mesh, 5), x, None, 1.0)
    save_sharded(spec["dir"], st, {"epoch": st.epoch}, specs=specs, mesh=mesh)
    saved = gather_state(st, specs, mesh)
    back, meta = restore_sharded(spec["dir"], fresh(specs, mesh, 9),
                                 specs=specs, mesh=mesh)
    out["ckpt/meta_epoch"] = [meta["epoch"], back.epoch, st.epoch]
    for name, state in (("orig", st), ("restored", back)):
        state, ems = run(state, x, None, 1.0)
        out[f"ckpt/{name}/total"] = ems.total.numpy()
        flat(f"ckpt/{name}/params", _numpy(
            gather_state(state, specs, mesh).params), out)
    m811 = make_mesh(MeshConfig(8, 1, 1))
    s_no = state_specs(cfg, "no", m811)
    other, _ = restore_sharded(spec["dir"], fresh(s_no, m811, 9),
                               specs=s_no, mesh=m811)
    _state_out(out, "ckpt/saved", saved)
    _state_out(out, "ckpt/no", gather_state(other, s_no, m811))
    s_off = state_specs(cfg, "full", mesh, offload_host=True)
    st_off = fresh(s_off, mesh, 11)
    save_sharded(spec["dir"] + "_off", st_off, specs=s_off, mesh=mesh)
    back_off, _ = restore_sharded(spec["dir"] + "_off", fresh(s_off, mesh, 12),
                                  specs=s_off, mesh=mesh)
    _state_out(out, "ckpt/off_saved", gather_state(st_off, s_off, mesh))
    _state_out(out, "ckpt/off_back", gather_state(back_off, s_off, mesh))


def _state_out(out, pre, st):
    for k in ("params", "bn"):
        flat(f"{pre}/{k}", _numpy(getattr(st, k)), out)
    flat(f"{pre}/mu", _numpy(st.opt_state.mu), out)
    flat(f"{pre}/nu", _numpy(st.opt_state.nu), out)
    out[f"{pre}/ints"] = [st.seed, st.epoch, st.opt_state.count]


CASES = {"ops": case_ops, "train": case_train,
         "strategies": case_strategies, "align": case_align,
         "eval": case_eval, "trainer": case_trainer, "stream": case_stream,
         "census": case_census, "fit": case_fit, "sweep": case_sweep,
         "arm": case_arm, "ckpt": case_ckpt}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch
    torch.set_num_threads(1)
    from dvae_tpu_torch.config import MeshConfig
    from dvae_tpu_torch.parallel.runtime import (initialize_distributed,
                                                 shutdown)
    from dvae_tpu_torch.parallel.sharding import make_mesh

    initialize_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                           backend="gloo", device="cpu", timeout_s=240)
    mesh = make_mesh(MeshConfig(*map(int, args.mesh.split(","))))
    with np.load(os.path.join(args.dir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    with open(os.path.join(args.dir, "cases.json")) as f:
        cases = json.load(f)
    ctx = {"inputs": inputs, "cases": cases, "mesh": mesh, "out": {},
           "rank": args.rank}
    for name in args.cases.split(","):
        CASES[name](ctx)
    np.savez(os.path.join(args.dir, f"out_{args.rank}.npz"),
             **{k: np.asarray(v) for k, v in ctx["out"].items()})
    shutdown()


if __name__ == "__main__":
    sys.exit(main())
