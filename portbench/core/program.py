"""The benchmark's one door into the program under test,
``dvae_tpu_torch``: building the trainer from a configuration file,
loading the benchmark's weights into it, reading its state, and watching
the first steps of its epoch runner.  Nothing of the JAX package is
imported."""

from __future__ import annotations

import contextlib

MODEL_KEYS = ("n_arm", "n_categories", "state_dim", "input_dim", "fc_dim",
              "lowD_dim", "x_drop", "s_drop", "lr", "lam", "lam_pc", "temp",
              "tau", "beta", "hard", "variational", "mode")
TRAIN_KEYS = ("batch_size", "epochs_per_jit", "eval_every", "optimizer",
              "bf16")


def init_kwargs(config: dict) -> dict:
    """``CplMixVAE.init_model`` keywords of a configuration file."""
    m, t = config["model"], config.get("train", {})
    kw = {k: m[k] for k in MODEL_KEYS if k in m}
    kw.update({k: t[k] for k in TRAIN_KEYS if k in t})
    return kw


def build(config: dict, device, seed: int):
    """A ``CplMixVAE`` on ``device`` configured through ``init_model``."""
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    model = CplMixVAE(device=device, seed=int(seed))
    model.init_model(**init_kwargs(config))
    return model


def leaves(tree: dict) -> dict:
    """{(layer, leaf): tensor} of a two-level tree of tensors."""
    return {(n, k): tree[n][k] for n in sorted(tree) for k in sorted(tree[n])}


class StepWatch:
    """Reads the first ``n`` steps of an epoch runner from inside it.

    ``runner(...)`` builds the program's own runner
    (``train/step.make_epoch_runner``) around the program's own step,
    wrapped so that its first ``n`` calls record what the reference is
    compared with: each step's loss, the first gradient as Adam got it
    (its first moment after one step, divided by 1 − b1), and the
    parameters after step ``n``, before step ``n + 1`` updates them in
    place.  Later calls pass straight through: the runner, its chunks, its
    draws and its steps are the ones the window times."""

    def __init__(self, n: int, b1: float):
        self.n, self.b1, self.k = int(n), float(b1), 0
        self.losses, self.grad, self.params = [], None, None

    def _wrap(self, step_fn):
        def step(state, *args, **kwargs):
            out = step_fn(state, *args, **kwargs)
            if self.k < self.n:
                self._record(out[0], out[1])
            return out
        return step

    def _record(self, state, metrics) -> None:
        import torch
        self.k += 1
        self.losses.append(float(metrics.total))
        if self.k == 1:
            self.grad = {nk: (v / (1.0 - self.b1)).cpu()
                         for nk, v in leaves(state.opt_state.mu).items()}
        if self.k == self.n:
            with torch.no_grad():
                self.params = {nk: v.detach().cpu().clone()
                               for nk, v in leaves(state.params).items()}

    def runner(self, *args, **kwargs):
        """``make_epoch_runner(*args, **kwargs)`` whose step is watched."""
        import dvae_tpu_torch.train.step as step_mod
        make = step_mod.make_train_step

        def watched(*a, **k):
            return self._wrap(make(*a, **k))
        with _swapped(step_mod, "make_train_step", watched):
            return step_mod.make_epoch_runner(*args, **kwargs)


@contextlib.contextmanager
def _swapped(mod, name: str, value):
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)
