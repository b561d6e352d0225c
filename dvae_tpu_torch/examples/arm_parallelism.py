"""Arm-parallelism study: Python loop vs stacked arms vs arm-sharded.

Counterpart of dvae_tpu/examples/arm_parallelism.py (the reference's
``dist/vmapping.py`` and ``dist/conv.ipynb``): how much does fusing the A
structurally identical arms into one batched computation buy?

  1. ``loop``:    a Python loop over per-arm parameter slices, each through
                  ``mixvae.apply`` and ``mixvae_loss`` with ``n_arm=1``
                  (what the reference's forward does every batch,
                  nn_model.py:329);
  2. ``vmap``:    one forward over the stacked parameters (the port's
                  model, whose arms are a leading tensor axis);
  3. ``sharded``: the stacked forward with the arms over an ``arm=A`` mesh
                  of the world's first A ranks (one process per device,
                  ``torch.distributed``), when the world has that many.

Every form runs the train-mode forward and loss on one set of draws made
whole (A, B, ·), so the per-arm reconstruction and KL terms agree between
them (the loop has no coupling terms: each of its arms is a model of
one).  Times are CUDA events on the card, the host clock on the CPU.

Run ``python -m dvae_tpu_torch.examples.arm_parallelism`` to print the
table (``--device cpu`` without a card).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from dvae_tpu_torch.config import MeshConfig, VAEConfig
from dvae_tpu_torch.models import mixvae
from dvae_tpu_torch.models.losses import mixvae_loss


def arm_draws(cfg: VAEConfig, batch_size: int, generator) -> mixvae.Noise:
    """The train-mode forward's random numbers, whole (A, B, ·)."""
    A, B = cfg.n_arm, batch_size
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)
    return mixvae.Noise(
        x_mask=(u(A, B, cfg.input_dim) >= cfg.x_drop).float(),
        gumbel_u=u(A, B, cfg.n_categories),
        reparam_e=torch.randn((A, B, cfg.state_dim), generator=generator,
                              device=dev),
        s_mask=(u(A, B, cfg.state_dim) >= cfg.s_drop).float())


def _arm(tree, a: int):
    return {n: {k: v[a:a + 1] for k, v in layer.items()}
            for n, layer in tree.items()}


def loop_forward(params, bn, cfg: VAEConfig, xs, noise) -> tuple:
    """(Σ of the per-arm totals, loss_rec (A,), kl (A,)): one model of one
    arm at a time."""
    cfg1 = cfg.replace(n_arm=1)
    total, rec, kl = 0.0, [], []
    for a in range(cfg.n_arm):
        n1 = mixvae.Noise(*(None if t is None else t[a:a + 1]
                            for t in noise[:4]))
        outs, _ = mixvae.apply(_arm(params, a), _arm(bn, a), cfg1,
                               xs[a:a + 1], train=True, noise=n1)
        aux = mixvae_loss(cfg1, outs, xs[a:a + 1])
        total = total + aux.total
        rec.append(aux.loss_rec)
        kl.append(aux.kl)
    return total, torch.cat(rec), torch.cat(kl)


def stacked_forward(params, bn, cfg: VAEConfig, xs, noise,
                    spmd=None) -> tuple:
    """(total, loss_rec (A,), kl (A,)) of the stacked forward; with
    ``spmd``, the parameters, statistics and ``xs`` are this rank's arms,
    the noise whole, and the loss terms come back whole."""
    outs, _ = mixvae.apply(params, bn, cfg, xs, train=True, noise=noise,
                           spmd=spmd)
    aux = mixvae_loss(cfg, outs, xs, spmd=spmd)
    return aux.total, aux.loss_rec, aux.kl


def _timer(dev):
    """ms a call of ``fn``, averaged over ``n`` calls after one warm-up."""
    def timeit(fn, n: int) -> float:
        fn()
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3
    return timeit


def arm_mesh(n_arm: int):
    """The ``arm=n_arm`` mesh of the world's first ranks (every rank of
    the world calls); None on the others, or when the world is smaller."""
    from dvae_tpu_torch.parallel.runtime import process_info
    from dvae_tpu_torch.parallel.sharding import make_submesh
    if process_info()[1] < n_arm:
        return None
    return make_submesh(MeshConfig(arm=n_arm))


def sharded_inputs(mesh, params, bn, cfg: VAEConfig, xs, noise):
    """(params, bn, xs, noise, spmd): the first three cut to this rank's
    arms of ``mesh``; the noise stays whole (the model cuts it)."""
    from dvae_tpu_torch.config import ShardingStrategy
    from dvae_tpu_torch.parallel.sharding import (Spmd, bn_shardings,
                                                  param_shardings, place)
    spmd = Spmd(mesh, ("arm",), (), cfg.n_arm, xs.shape[1])
    return (place(params, param_shardings(params, mesh,
                                          ShardingStrategy.DDP), mesh),
            place(bn, bn_shardings(bn, mesh), mesh), spmd.local(xs), noise,
            spmd)


@torch.no_grad()
def benchmark_arm_strategies(cfg: Optional[VAEConfig] = None,
                             batch_size: int = 1024, n_iters: int = 20,
                             shard: bool = False, device="cuda") -> dict:
    """ms of the loop, the stacked forward and (with ``shard`` and a world
    of at least A ranks, on the ranks of the ``arm`` mesh) the sharded
    one, and the stacked form's speed-up over the loop."""
    from dvae_tpu_torch.parallel.runtime import rank_device
    from dvae_tpu_torch.utils.device import resolve_device

    cfg = cfg or VAEConfig(n_arm=5, input_dim=1024, n_categories=32,
                           fc_dim=64, lowD_dim=16, tau=0.1)
    dev = rank_device(resolve_device(device))
    params = mixvae.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    bn = mixvae.init_bn_state(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((batch_size, cfg.input_dim), generator=g, device=dev)
    xs = x.expand(cfg.n_arm, *x.shape)
    noise = arm_draws(cfg, batch_size, g)
    timeit = _timer(dev)

    results = {
        "loop_ms": timeit(lambda: loop_forward(params, bn, cfg, xs, noise),
                          n_iters),
        "vmap_ms": timeit(lambda: stacked_forward(params, bn, cfg, xs,
                                                  noise), n_iters)}
    mesh = arm_mesh(cfg.n_arm) if shard else None
    if mesh is not None:
        p_l, bn_l, xs_l, noise_l, spmd = sharded_inputs(mesh, params, bn,
                                                        cfg, xs, noise)
        results["sharded_ms"] = timeit(
            lambda: stacked_forward(p_l, bn_l, cfg, xs_l, noise_l, spmd),
            n_iters)
    results["speedup_vmap_over_loop"] = results["loop_ms"] / results["vmap_ms"]
    return results


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for k, v in benchmark_arm_strategies(device=args.device).items():
        print(f"{k}: {v:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
