"""Traffic kind ``train_resident_aug``: ``train_resident`` with the frozen
augmenter on every step, as MMIDAS's own training script runs it: each
arm trains on its own augmented view of the batch.

Parameters (``params`` of the cell's file) as ``train_resident``'s:
``n_train`` and ``n_val`` cells, ``data``, ``probe_steps``.  The
configuration's ``model.augmenter`` group sizes the augmenter and
``train.aug_noise`` is its noise scale.

Set-up makes the data and the VAE's weights from the seed as
``train_resident`` does; the augmenter's weights come from the seed too
and each of its batch norms' running statistics from its input over the
training cells (``reference/augmenter.py``).  They are written to a
checkpoint in a temporary directory in the program's own format
(``augment/augmenter.save_augmenter``), and the trainer is built as a
user builds it: ``CplMixVAE(device, seed, aug_file=<checkpoint>)``,
``init_model`` with the configuration's keys, the noise scale on its
``TrainConfig``.  The window's runner is ``make_epoch_runner`` with
``augment=`` the trainer's own closure (``CplMixVAE._augment_fn``), as
``CplMixVAE.train`` passes it, seen through a pass-through wrapper that
keeps a host copy of the first step's views.  The runner's first chunk
runs in set-up with its first ``probe_steps`` steps watched
(``program.StepWatch``), then one validation, whose views the trainer's
eval step makes with its host-drawn noise.  The window and the traced
slice are ``train_resident``'s.

Compared with the plain reference, run in float64, on the same rows and
draws (``reference/draws_aug.AugRunnerDraws``): ``train_resident``'s numbers,
and ``views``, the first step's (A, B, D) views as max |Δ| / max |ref|.
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from portbench.core import data, program, spec, trace
from portbench.core.compare import train_numbers
from portbench.core.harness import Result
from portbench.core.weights import load_into, make_params
from portbench.reference import augmenter as aug_ref
from portbench.reference import model as ref
from portbench.reference.draws_aug import AugRunnerDraws

BASE = spec.traffic("train_resident")   # its chunk: one call, one read


class FirstViews:
    """The trainer's augment closure, passed through; the first call's
    views are kept on the host."""

    def __init__(self, fn):
        self.fn, self.views = fn, None

    def __call__(self, x, n_arm, generator=None, draws=None):
        out = self.fn(x, n_arm, generator, draws)
        if self.views is None:
            self.views = out.detach().cpu()
        return out


def build(config: dict, device, seed: int, aug_file: str):
    """``CplMixVAE(aug_file=…)`` configured through ``init_model``, the
    augmenter's noise scale on its ``TrainConfig``."""
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    trainer = CplMixVAE(device=device, seed=int(seed), aug_file=aug_file)
    trainer.init_model(**program.init_kwargs(config))
    trainer.tcfg = trainer.tcfg.replace(
        aug_noise=float(config["train"]["aug_noise"]))
    return trainer


def augmenter_state(ctx, x_train) -> tuple:
    """(params, running statistics) of the augmenter, from the seed and
    the training cells."""
    a = ctx.model["augmenter"]
    params = aug_ref.make_params(a, ctx.seed_for("augmenter"), ctx.device)
    bn = aug_ref.calibrate(params, x_train, a, ctx.train["aug_noise"],
                           ctx.seed_for("augmenter_stats"))
    return params, bn


def setup(ctx) -> dict:
    """Data, the VAE's weights and the augmenter from the seed; the trainer
    built through ``CplMixVAE(aug_file=…)`` and ``init_model``; the
    window's runner with the trainer's augment closure, and its first chunk
    run with its first ``probe_steps`` steps and first views watched."""
    from dvae_tpu_torch.augment.augmenter import (AugmenterConfig,
                                                  save_augmenter)
    m, t, p = ctx.model, ctx.train, ctx.params
    dev = ctx.device
    n_train = p["n_train"]
    x = data.make(n_train + p["n_val"], m["input_dim"],
                  ctx.seed_for("data"), p["data"], dev)
    x_train = x[:n_train]
    weights = make_params(m, ctx.seed_for("weights"), dev)
    aug = augmenter_state(ctx, x_train)
    with tempfile.TemporaryDirectory() as folder:
        path = save_augmenter(os.path.join(folder, "augmenter.ckpt"), *aug,
                              AugmenterConfig(**m["augmenter"]))
        trainer = build(ctx.config, dev, ctx.seed, path)
    load_into(trainer.state.params, weights)
    first = FirstViews(trainer._augment_fn())
    watch = program.StepWatch(p["probe_steps"], ref.ADAM["b1"])
    runner = watch.runner(trainer.cfg, trainer.tcfg, trainer.tx, n_train,
                          epochs_per_chunk=t["epochs_per_jit"],
                          augment=first)
    counts = {"epochs": 0}
    BASE._chunk(trainer, runner, x_train, trainer.temp, counts)
    prog = {"losses": watch.losses, "grad": watch.grad,
            "change": {nk: v - weights[nk[0]][nk[1]].cpu()
                       for nk, v in watch.params.items()},
            "views": first.views}
    return {"x_train": x_train, "x_val": x[n_train:], "weights": weights,
            "aug": aug, "trainer": trainer, "runner": runner, "prog": prog,
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
        host = BASE._chunk(trainer, runner, x_train, temp, counts)
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
            BASE._chunk(trainer, runner, x_train, temp, counts)
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

    want = follow(s, m, ctx.seed, B, p["probe_steps"], t["aug_noise"], dev)
    res.numbers = numbers(s["prog"], want)
    res.numbers["steps_unapplied"] = abs(epochs * steps_per_epoch
                                         - adam_steps)
    return res


def view_gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """max |prog − want| / max |want| (infinite for another shape or a
    value that is not finite)."""
    if prog is None or prog.shape != want.shape:
        return float("inf")
    gap = float((prog.double() - want.double()).abs().max())
    scale = float(want.abs().max())
    return gap / scale if scale > 0 else gap


def numbers(prog: dict, want: dict) -> dict:
    """``train_resident``'s compared numbers and ``views``."""
    out = train_numbers(prog, want)
    out["views"] = view_gap(prog["views"], want["views"])
    return out


def cast(tree, dtype):
    """A copy of a nest of dicts and tuples with its floating tensors in
    ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(cast(v, dtype) for v in tree)
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def follow(s: dict, m: dict, seed: int, B: int, n: int, scale: float,
           device, mode: str = "highest", aug_mode: str = "highest",
           aug=None, running: bool = True, rows: int = None,
           dtype=torch.float64) -> dict:
    """The reference's ``n`` steps from set-up's weights: step k sees the
    rows, the augmenter's z and e and the model's noise that step k of the
    runner's first chunk over all of ``s["x_train"]`` draws, its views made
    by the plain augmenter from ``aug`` (set-up's by default) at noise
    ``scale``.  Returns the steps' losses, the first gradient, the
    parameters' change and the first step's views.  ``mode`` and
    ``aug_mode`` are the products' precision in the VAE and in the
    augmenter; ``running`` False normalises the augmenter's trunk with
    batch statistics and ``rows`` < B keeps only the first ``rows`` of
    every batch and of its draws (faults the check must catch).

    ``dtype`` is the reference's: float64, so that its own rounding does
    not count against the program.  The first gradient of a bias in front
    of a batch norm is a sum that nearly cancels, and on some seeds an f32
    reference alone misses it by several times what the program does.
    The f32 weights, rows and draws convert exactly.  The control runs in
    float32."""
    weights, x_train = cast(s["weights"], dtype), s["x_train"]
    aug_params, aug_bn = cast(aug or s["aug"], dtype)
    params = ref.clone_params(weights)
    adam = ref.adam_init(params)
    out = {"losses": []}
    dr = AugRunnerDraws(seed, 0, device, x_train.shape[0], B, m)
    plan = dr.epoch_plan()
    if n > plan.shape[0]:
        raise ValueError(f"{n} steps to follow, {plan.shape[0]} in an epoch")
    for k in range(n):
        xb = x_train.index_select(0, plan[k]).to(dtype)
        noise = cast(dr.step_noise(), dtype)
        if rows is not None:
            xb = xb[:rows]
            noise = {key: v[:, :rows] for key, v in noise.items()}
        v = aug_ref.views(aug_params, aug_bn, xb, m["n_arm"], noise["aug_z"],
                          noise["aug_e"], scale, aug_mode, running)
        if k == 0:
            out["views"] = v.cpu()
        with ref.precision(mode):
            total, grads = aug_ref.value_and_grads(params, v, m, noise)
        out["losses"].append(float(total))
        if k == 0:
            out["grad"] = {nk: g.cpu() for nk, g in grads.items()}
        ref.adam_step(params, grads, adam, m["lr"])
        del grads, v
    out["change"] = {(nn, kk): (params[nn][kk] - weights[nn][kk]).cpu()
                     for nn, kk in ref.leaf_names(params)}
    return out


def readings(ctx) -> dict:
    """The numbers the limits are set from, on one seed: the program's
    (the lower reading) and, against the same float64 reference, the
    control (the f32 reference with the augmenter's products in TF32; also
    every product in TF32) and the planted faults (the upper readings): a
    noise scale of twice the configuration's, one layer's weights (fc6)
    scaled by 1 + 1e-3, the trunk normalised with batch statistics, a
    batch of which half is left out (its views then differ in shape:
    ``views`` reads infinite)."""
    m, t, p, dev = ctx.model, ctx.train, ctx.params, ctx.device
    B, n, scale = t["batch_size"], p["probe_steps"], t["aug_noise"]
    s = setup(ctx)
    unapplied = abs(s["epochs"] * (p["n_train"] // B)
                    - int(s["trainer"].state.opt_state.count))
    del s["trainer"], s["runner"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    want = follow(s, m, ctx.seed, B, n, scale, dev)
    perturbed = {k: dict(v) for k, v in s["aug"][0].items()}
    perturbed["fc6"]["w"] = perturbed["fc6"]["w"] * (1.0 + 1e-3)
    runs = {
        "control_tf32_augmenter": follow(s, m, ctx.seed, B, n, scale, dev,
                                         aug_mode="tf32",
                                         dtype=torch.float32),
        "control_tf32": follow(s, m, ctx.seed, B, n, scale, dev,
                               mode="tf32", aug_mode="tf32",
                               dtype=torch.float32),
        "fault_noise_scale": follow(s, m, ctx.seed, B, n, 2 * scale, dev),
        "fault_weights_1e-3": follow(s, m, ctx.seed, B, n, scale, dev,
                                     aug=(perturbed, s["aug"][1])),
        "fault_trunk_batch_stats": follow(s, m, ctx.seed, B, n, scale, dev,
                                          running=False),
        "fault_half_batch": follow(s, m, ctx.seed, B, n, scale, dev,
                                   rows=B // 2),
    }
    out = {"program": {**numbers(s["prog"], want),
                       "steps_unapplied": unapplied}}
    for name, got in runs.items():
        out[name] = {**numbers(got, want), "steps_unapplied": 0}
    return out
