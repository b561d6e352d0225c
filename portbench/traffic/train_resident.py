"""Traffic kind ``train_resident``: training on a dataset that lives on the
card, through the program's own chunked epoch runner.

Parameters (``params`` of the cell's file): ``n_train`` and ``n_val``
cells, ``data`` (``"logcpm"`` or ``"log1p"``, see ``core/data.py``),
``probe_steps`` (the steps the reference follows).  The batch, the epochs
a chunk and the validation cadence are the configuration's ``train``
group.

Set-up builds one trainer, ``CplMixVAE`` through ``init_model``, puts the
benchmark's weights into it, and builds the window's runner
(``train/step.make_epoch_runner`` over the whole training set, a chunk of
``epochs_per_jit`` epochs).  The runner's first chunk runs in set-up: its
first ``probe_steps`` steps, on rows that all differ, are read from inside
the runner (``program.StepWatch``) for the reference to follow; one
validation follows.  The window then runs the same runner's chunks on the
same state, each read back to the host once, and ``CplMixVAE.validate``
every ``eval_every`` epochs, until ``--seconds`` have passed.  No
checkpoint is written.  With ``--trace 1`` one more chunk and its
validation run profiled.  At the end Adam's step count is held to the
steps the benchmark counted.
"""

from __future__ import annotations

import time

import torch

from portbench.core import data, program, trace
from portbench.core.compare import train_numbers
from portbench.core.harness import Result
from portbench.core.weights import load_into, make_params
from portbench.reference import model as ref
from portbench.reference.draws import RunnerDraws


def _chunk(model, runner, x_train, temp, counts):
    with trace.span("train"):
        model.state, ems = runner(model.state, x_train, None, temp)
    with trace.span("read"):
        host = {k: v.cpu().numpy() for k, v in ems._asdict().items()}
    counts["epochs"] += host["total"].shape[0]
    return host


def setup(ctx) -> dict:
    """Data and weights from the seed; the trainer built through
    ``init_model`` with the benchmark's weights; the window's runner, and
    its first chunk run with its first ``probe_steps`` steps watched:
    their losses, the first gradient and the parameters' change."""
    m, t, p = ctx.model, ctx.train, ctx.params
    dev = ctx.device
    n_train = p["n_train"]
    x = data.make(n_train + p["n_val"], m["input_dim"],
                  ctx.seed_for("data"), p["data"], dev)
    weights = make_params(m, ctx.seed_for("weights"), dev)
    trainer = program.build(ctx.config, dev, ctx.seed)
    load_into(trainer.state.params, weights)
    watch = program.StepWatch(p["probe_steps"], ref.ADAM["b1"])
    runner = watch.runner(trainer.cfg, trainer.tcfg, trainer.tx, n_train,
                          epochs_per_chunk=t["epochs_per_jit"])
    x_train = x[:n_train]
    counts = {"epochs": 0}
    _chunk(trainer, runner, x_train, trainer.temp, counts)
    prog = {"losses": watch.losses, "grad": watch.grad,
            "change": {nk: v - weights[nk[0]][nk[1]].cpu()
                       for nk, v in watch.params.items()}}
    return {"x_train": x_train, "x_val": x[n_train:], "weights": weights,
            "trainer": trainer, "runner": runner, "prog": prog,
            "epochs": counts["epochs"]}


def run(ctx) -> Result:
    m, t, p = ctx.model, ctx.train, ctx.params
    dev, B = ctx.device, t["batch_size"]
    every = t["eval_every"]
    n_train = p["n_train"]
    steps_per_epoch = n_train // B
    res = Result()
    s = setup(ctx)
    trainer, runner = s["trainer"], s["runner"]
    x_train, x_val = s["x_train"], s["x_val"]
    temp = trainer.temp
    trainer.validate(x_val, temp)   # warm-up of the window's validation
    res.e2e["setup_s"] = time.perf_counter() - ctx.t_start
    epochs = s["epochs"]

    # the measured window
    counts = {"epochs": 0}
    val_s, bad = 0.0, 0
    t0 = time.perf_counter()
    while True:
        before = counts["epochs"]
        host = _chunk(trainer, runner, x_train, temp, counts)
        bad += int((~torch.isfinite(torch.as_tensor(host["total"]))).sum())
        if counts["epochs"] // every > before // every:
            tv = time.perf_counter()
            with trace.span("validate"):
                trainer.validate(x_val, temp)
            val_s += time.perf_counter() - tv
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    wall = time.perf_counter() - t0
    steps = counts["epochs"] * steps_per_epoch
    epochs += counts["epochs"]
    res.e2e["train_cells_per_s"] = steps * B / wall
    res.attempted, res.failed = steps, bad * steps_per_epoch
    res.host.update({"window_s": wall, "train_steps": steps, "batch": B,
                     "validate_s": val_s})

    if ctx.trace:
        counts = {"epochs": 0}
        with trace.profiled() as prof:
            _chunk(trainer, runner, x_train, temp, counts)
            with trace.span("validate"):
                trainer.validate(x_val, temp)
        res.slice = prof.slice
        n = counts["epochs"] * steps_per_epoch
        epochs += counts["epochs"]
        res.host["slice_train_steps"] = n
        res.calls["train"] = [B] * n

    if dev.type == "cuda":
        res.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    adam_steps = int(trainer.state.opt_state.count)
    del trainer, runner, s["trainer"], s["runner"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    res.numbers = train_numbers(s["prog"], follow(
        s["weights"], x_train, m, ctx.seed, B, p["probe_steps"], m["lr"],
        dev))
    res.numbers["steps_unapplied"] = abs(epochs * steps_per_epoch
                                         - adam_steps)
    return res


def follow(weights: dict, x_train, m: dict, seed: int, B: int, n: int,
           lr: float, device, mode: str = "highest", rows: int = None) -> dict:
    """The reference's ``n`` steps from ``weights``: step k sees the rows
    and the noise that step k of the runner's first chunk over all of
    ``x_train`` draws (one permutation of the rows an epoch, so the first
    epoch's steps see rows that all differ).  Returns the steps' losses,
    the first gradient and the parameters' change.  ``mode`` is the products' precision; ``rows``
    < B keeps only the first ``rows`` of every batch (a fault that the
    check must catch)."""
    params = ref.clone_params(weights)
    adam = ref.adam_init(params)
    out = {"losses": []}
    dr = RunnerDraws(seed, 0, device, x_train.shape[0], B, m)
    plan = dr.epoch_plan()
    if n > plan.shape[0]:
        raise ValueError(f"{n} steps to follow, {plan.shape[0]} in an epoch")
    with ref.precision(mode):
        for k in range(n):
            xb = x_train.index_select(0, plan[k])
            noise = dr.step_noise()
            if rows is not None:
                xb = xb[:rows]
                noise = {key: v[:, :rows] for key, v in noise.items()}
            total, grads = ref.value_and_grads(params, xb, m, noise)
            out["losses"].append(float(total))
            if k == 0:
                out["grad"] = {nk: g.cpu() for nk, g in grads.items()}
            ref.adam_step(params, grads, adam, lr)
            del grads
    out["change"] = {(nn, kk): (params[nn][kk] - weights[nn][kk]).cpu()
                     for nn, kk in ref.leaf_names(params)}
    return out
