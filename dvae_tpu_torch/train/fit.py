"""Declarative high-level trainer of the PyTorch port — the Lightning-style
``Trainer``, on one card or on a data-parallel group of several.

Counterpart of dvae_tpu/train/fit.py (the reference's PyTorch-Lightning
take on the MNIST benchmark, ``dist/pl.py``: ``LightningModule`` subclasses
:26-140, ``L.Trainer(...).fit`` :181-188, per-epoch ``epoch_time`` /
memory / loss logging :53-75, the post-run averages :191-207):

  * A ``FitModule`` is a bundle of pure functions over a parameter tree
    (nested dicts and lists of tensors, the JAX trees' keys) that the
    Trainer owns; ``training_step`` is differentiated by autograd and the
    update is the port's optax-semantics ``Adam``.
  * ``strategy`` keeps the ``ShardingStrategy`` matrix over a 1-D ``dp``
    group of ``devices`` ranks (None: the whole ``torch.distributed``
    world, one device outside one; one process per device, a rank outside
    the group takes no part): each leaf of two or more dimensions shards
    its largest dimension the group divides (``_generic_shardings``), the
    parameters under FULL_SHARD/HYBRID, the Adam moments under the four
    ZeRO strategies.  On one device a strategy is a placement only.
  * ``use_distributed_sampler`` keeps its reference meaning: True splits
    each batch over the group and averages the gradients; False gives
    every rank the whole batch (duplicated work, nothing summed).  A
    validation set smaller than the group's span is evaluated whole on
    every rank.
  * The batches are staged on the device once as ``(steps, B, ...)``; the
    epoch loops over them in Python with every metric left on the device,
    and reads them back once when the epoch ends (JAX runs the epoch as one
    ``lax.scan``).  ``train_loss`` is the mean of the step losses and each
    validation metric the mean of the per-batch means, as in JAX.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dvae_tpu_torch.config import ShardingStrategy
from dvae_tpu_torch.parallel.runtime import flat_all_reduce, rank_device
from dvae_tpu_torch.parallel.sharding import (DPMesh, gather_tree,
                                              make_dp_mesh, place, tree_map)
from dvae_tpu_torch.train.step import (Adam, sharded_optimizer_step,
                                       tree_leaves, tree_like)
from dvae_tpu_torch.utils.device import resolve_device
from dvae_tpu_torch.utils.host_ops import to_device
from dvae_tpu_torch.utils.logging import MetricLogger, avg, device_memory_mb


class FitModule:
    """Subclass API (the reference's ``L.LightningModule`` role).

    Required:
      * ``init_params(generator) -> params`` tree of tensors, drawn from
        ``generator`` (the Trainer moves it to its device);
      * ``training_step(params, batch, generator) -> (loss, metrics dict)``
        — differentiable in ``params``; ``batch`` is a tuple of tensors and
        ``generator`` a ``torch.Generator`` on the Trainer's device;
      * ``configure_optimizer()`` -> an optimizer with the port's ``Adam``
        interface: ``init(params)`` and ``update(grads, state, params)``,
        which changes ``params`` in place and returns the new state.

    Optional:
      * ``validation_step(params, batch) -> metrics dict`` (scalars).
    """

    def init_params(self, generator: torch.Generator):
        raise NotImplementedError

    def training_step(self, params, batch, generator: torch.Generator):
        raise NotImplementedError

    def configure_optimizer(self):
        raise NotImplementedError

    validation_step: Any = None


def _generic_shardings(tree, mesh: DPMesh, shard: bool, axis: str = "dp"):
    """Shard each leaf's largest mesh-divisible dim (2-D+ leaves only);
    replicate the rest (dvae_tpu/train/fit.py:76-93), as spec tuples."""
    n = mesh.size

    def rule(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not (shard and len(shape) >= 2):
            return ()
        cands = [(shape[i], i) for i in range(len(shape))
                 if shape[i] % n == 0]
        if not cands:
            return ()
        _, i = max(cands)
        spec = [None] * len(shape)
        spec[i] = axis
        return tuple(spec)

    return tree_map(rule, tree)


def _step_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one step's generator, from (seed, epoch, step)."""
    return int(np.random.SeedSequence([seed, epoch, step]).generate_state(
        1, np.uint64)[0] >> 1)


@dataclass
class Trainer:
    """``L.Trainer`` equivalent (reference dist/pl.py:181-187): ``device``
    ("cuda" unless "cpu" is asked for; each rank's own card on a group).
    ``devices``: the world's first ranks it trains on (None: the whole
    world; more than the world's ranks is a ``ValueError``)."""

    max_epochs: int = 10
    strategy: ShardingStrategy | str = ShardingStrategy.FULL_SHARD
    devices: Optional[int] = None          # None = the whole world
    use_distributed_sampler: bool = True
    shuffle: bool = False                  # reference loaders use shuffle=False
    seed: int = 1                          # reference default (dist/pl.py:215)
    logger: Optional[MetricLogger] = None
    history: list = field(default_factory=list)   # reset by each fit()
    _fitted: Any = None
    device: Any = "cuda"

    def fit(self, module: FitModule, train_data, val_data=None,
            batch_size: int = 64, val_batch_size: int = 1000,
            verbose: bool = False) -> dict:
        """Run the fit loop; returns the post-run summary dict.

        ``train_data``/``val_data`` are tuples of equal-length arrays
        (e.g. ``(x, y)``) — the loader analogue.  Remainder rows beyond a
        whole number of batches are dropped (reference ``drop_last=True``,
        dist/pl.py:166).  Each step's generator is seeded from (seed,
        epoch, step); a module that draws gets other numbers than under
        JAX, whose keys fold the epoch into ``seed`` and split it by step.
        """
        self.history = []
        strategy = ShardingStrategy(self.strategy)
        dev = resolve_device(self.device)
        mesh = make_dp_mesh(self.devices)
        if mesh is None:
            return None   # this rank is outside the group
        if mesh.size > 1:
            dev = rank_device(dev)
        logger = self.logger or MetricLogger()
        shard_params = strategy in (ShardingStrategy.FULL_SHARD,
                                    ShardingStrategy.HYBRID_SHARD)
        shard_opt = strategy in (
            ShardingStrategy.FULL_SHARD, ShardingStrategy.HYBRID_SHARD,
            ShardingStrategy.SHARD_GRAD_OP,
            ShardingStrategy.HYBRID_SHARD_ZERO2)

        params = module.init_params(torch.Generator().manual_seed(self.seed))
        params = tree_like(params, [to_device(p, dev)
                                    for p in tree_leaves(params)])
        tx = module.configure_optimizer()
        opt_state = tx.init(params)
        p_sh = _generic_shardings(params, mesh, shard_params)
        o_sh = _generic_shardings(params, mesh, shard_opt)
        params = place(params, p_sh, mesh)
        opt_state = opt_state._replace(mu=place(opt_state.mu, o_sh, mesh),
                                       nu=place(opt_state.nu, o_sh, mesh))
        dp = mesh.size if self.use_distributed_sampler else 1
        group = mesh.group("dp") if dp > 1 else None

        def rows(bs):
            """This rank's rows of a ``bs``-row batch."""
            k = bs // dp
            i = mesh.dp.index if dp > 1 else 0
            return slice(i * k, i * k + k)

        def stage(data, bs):
            """(steps, B, ...) device tensors, remainder dropped."""
            n = data[0].shape[0]
            steps = n // bs
            if steps == 0:
                raise ValueError(f"batch_size {bs} > dataset size {n}")
            return steps, tuple(
                to_device(np.asarray(a[: steps * bs]), dev).reshape(
                    (steps, bs) + tuple(a.shape[1:])) for a in data)

        if batch_size % dp:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"the sampler's {dp} devices")
        n_steps, tbatches = stage(train_data, batch_size)
        mine = rows(batch_size)
        vbatches, vgroup = None, None
        if val_data is not None and module.validation_step is not None:
            # clamp: a validation set smaller than val_batch_size evaluates
            # as one batch; the batch must stay divisible by the sampler's
            # span, and fewer rows than the span evaluate whole on every
            # rank (dvae_tpu/train/fit.py:159-174)
            n_val = val_data[0].shape[0]
            vbs = min(val_batch_size, n_val)
            vbs = max(dp, vbs - vbs % dp)
            if vbs > n_val:
                n_vsteps, vbatches = stage(val_data, n_val)
            else:
                n_vsteps, vbatches = stage(val_data, vbs)
                vbatches = tuple(a[:, rows(vbs)] for a in vbatches)
                vgroup = group

        gen = torch.Generator(device=dev)

        def grad_step(opt_state, batch):
            opt_state, loss, metrics = sharded_optimizer_step(
                lambda p: module.training_step(p, batch, gen), params, tx,
                opt_state, p_sh, o_sh, mesh, group)
            # a module-provided 'train_loss' metric wins over the raw loss
            return opt_state, {"train_loss": loss,
                               **{k: torch.as_tensor(v).detach()
                                  for k, v in metrics.items()}}

        def means(records):
            return {k: torch.stack([r[k].float() for r in records]).mean()
                    for k in records[0]}

        perm_rng = np.random.default_rng(self.seed)
        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            eb = tbatches
            if self.shuffle:
                order = to_device(perm_rng.permutation(n_steps * batch_size),
                                  dev)
                eb = tuple(a.reshape((-1,) + a.shape[2:])[order].reshape(
                    a.shape) for a in tbatches)
            steps = []
            for s in range(n_steps):
                gen.manual_seed(_step_seed(self.seed, epoch, s))
                opt_state, ms = grad_step(opt_state,
                                          tuple(a[s, mine] for a in eb))
                steps.append(ms)
            ms = means(steps)
            if vbatches is not None:
                with torch.no_grad():
                    whole = gather_tree(params, p_sh, mesh)
                    vms = means([module.validation_step(
                        whole, tuple(a[b] for a in vbatches))
                        for b in range(n_vsteps)])
                    del whole
                    if vgroup is not None:   # the mean of the ranks' means
                        keys = list(vms)
                        summed = flat_all_reduce(
                            [vms[k].reshape(1) for k in keys], vgroup)
                        vms = {k: v[0] / vgroup.size
                               for k, v in zip(keys, summed)}
                ms.update({k if k.startswith("val_") else f"val_{k}": v
                           for k, v in vms.items()})
            # the epoch's one host read
            values = torch.stack(list(ms.values())).cpu().tolist()
            rec = dict(zip(ms, values))
            rec["epoch_time"] = time.perf_counter() - t0
            rec["device_memory_mb"] = (device_memory_mb(dev)
                                       if dev.type == "cuda" else 0.0)
            self.history.append(rec)
            logger.log(rec, step=epoch)
            if verbose:
                print(f"epoch {epoch}: " + " ".join(
                    f"{k}={v:.4g}" for k, v in rec.items()))

        # post-run summary (reference dist/pl.py:191-207 mines these back
        # out of the wandb API; our history is local)
        summary = {
            "avg_epoch_time": avg(r["epoch_time"] for r in self.history[1:]
                                  or self.history),
            "avg_memory_usage": avg(r["device_memory_mb"]
                                    for r in self.history),
        }
        logger.log(summary)
        self._fitted = (gather_tree(params, p_sh, mesh), opt_state)
        return summary

    @property
    def params(self):
        """Trained parameters from the last ``fit`` call, whole on every
        rank of the group."""
        if self._fitted is None:
            raise RuntimeError("Trainer.params: no completed fit() yet")
        return self._fitted[0]


# ---------------------------------------------------------------------------
# The reference's PLNet / PLDeepNet analogues (dist/pl.py:26-140), built on
# the tutorial MLPs so the Lightning path benches the same model scales.
# ---------------------------------------------------------------------------

class MNISTFitModule(FitModule):
    """``PLNet`` (≈1M params) / ``PLDeepNet`` (≈87M) as a FitModule.

    ``model``: "net" | "deep" (reference ``make_model``, dist/pl.py:141-148),
    or pass an explicit ``MLPConfig`` for test-sized nets.  It draws
    nothing in its steps, so its runs follow JAX's from the same weights.
    """

    def __init__(self, model: str = "net", cfg=None, lr: float = 1e-3):
        from dvae_tpu_torch.examples.fsdp_tutorial import MLPConfig
        if cfg is None:
            cfg = (MLPConfig.shallow() if model == "net"
                   else MLPConfig.deep())
        self.cfg, self.lr = cfg, lr

    def init_params(self, generator):
        from dvae_tpu_torch.examples.fsdp_tutorial import init_mlp
        return init_mlp(generator, self.cfg, device=generator.device)

    def _loss(self, params, batch):
        from dvae_tpu_torch.examples.fsdp_tutorial import apply_mlp
        x, y = batch
        logits = apply_mlp(params, x)
        loss = F.cross_entropy(logits, y.long())
        acc = (logits.argmax(-1) == y).float().mean()
        return loss, acc

    def training_step(self, params, batch, generator):
        loss, _ = self._loss(params, batch)
        return loss, {}

    def validation_step(self, params, batch):
        loss, acc = self._loss(params, batch)
        return {"loss": loss, "acc": acc}

    def configure_optimizer(self):
        return Adam(self.lr)


def fit_mnist_demo(model: str = "net", max_epochs: int = 3,
                   strategy: str = "full", batch_size: int = 64,
                   n_train: int = 8192, verbose: bool = True,
                   device="cuda") -> dict:
    """The ``pl_main`` walkthrough (dist/pl.py:150-207) end to end on
    synthetic MNIST; returns the post-run summary."""
    from dvae_tpu_torch.examples.fsdp_tutorial import synthetic_mnist
    trainer = Trainer(max_epochs=max_epochs, strategy=strategy,
                      device=device)
    summary = trainer.fit(
        MNISTFitModule(model), synthetic_mnist(n_train, seed=0),
        val_data=synthetic_mnist(2048, seed=1), batch_size=batch_size,
        verbose=verbose)
    if verbose:
        print(f"Average epoch time: {summary['avg_epoch_time']:.3f}s")
        print(f"Average memory usage: {summary['avg_memory_usage']:.1f}MB")
    return summary
