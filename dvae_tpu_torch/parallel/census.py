"""Strategy × mode multi-device census: execution + equality matrix.

Counterpart of dvae_tpu/parallel/census.py.  It checks the three facts
the multi-device story rests on (reference strategy matrix:
fsdp_mnist.py:215-228):

  (i)   every sharding strategy computes the SAME numbers — executed at a
        small shape for each reconstruction mode (MSE / ZINB /
        aug-in-the-loop);
  (ii)  the production-shape step (A=5, B=5000, D=5032, C=92, bf16, the
        fused kernels on) runs under every strategy × mode without moving
        an input or an activation across ranks at a fused-kernel boundary
        (the "replicate-then-repartition" class);
  (iii) the collectives it issues are consistent with the analytic ring
        model (parallel/collective_cost.py): per-strategy structural facts
        plus a gradient-traffic lower bound.

Where the port differs from the JAX package:

  * ``production_row`` executes one step at the production shape in the
    caller's world (torch has no compile-only lowering); ``compile_s``
    keeps its name and holds that step's wall seconds.
  * ``warnings`` lists every recorded collective whose payload is at least
    one (A_local, B_local, D) tensor of the compute dtype: the port's form
    of the JAX field, which holds XLA's SPMD warnings.  ``run_census``
    raises on it as JAX does.
  * ``main`` runs once per rank of a ``torch.distributed`` world; rank 0
    writes the summary.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional, Sequence

import numpy as np

MODES = ("MSE", "ZINB", "aug")


def mesh_config_for(mesh):
    from dvae_tpu_torch.config import MeshConfig
    return MeshConfig(data=mesh.shape["data"], arm=mesh.shape["arm"],
                      fsdp=mesh.shape["fsdp"])


def production_cfg(mode: str):
    """The flagship production configuration (A=5 Smart-seq shape) in the
    form the trainer runs it on the card: fused kernels on."""
    from dvae_tpu_torch.config import VAEConfig
    cfg = VAEConfig(n_arm=5, fused_recon=True, fused_encoder=True)
    if mode == "ZINB":
        cfg = dataclasses.replace(cfg, mode="ZINB")
    return cfg


def small_cfg(mode: str, n_arm: int = 2):
    from dvae_tpu_torch.config import VAEConfig
    cfg = VAEConfig(n_categories=8, input_dim=64, fc_dim=16, lowD_dim=8,
                    state_dim=2, n_arm=n_arm, tau=0.1,
                    fused_recon=True, fused_encoder=True)
    if mode == "ZINB":
        cfg = dataclasses.replace(cfg, mode="ZINB")
    return cfg


def _augment_fn(input_dim: int, bf16: bool, n_dim: Optional[int] = None,
                device="cuda"):
    """Frozen random-weight augmenter closure (augment/augmenter.py
    ``frozen_random_augment_fn``)."""
    from dvae_tpu_torch.augment.augmenter import frozen_random_augment_fn
    return frozen_random_augment_fn(input_dim, bf16=bf16, n_dim=n_dim,
                                    device=device)


# ---------------------------------------------------------------------------
# (iii) analytic cross-check against the recorded collectives
# ---------------------------------------------------------------------------

def grad_traffic_lower_bound(params, mesh) -> float:
    """Ring-model lower bound on per-step wire bytes from parameter/gradient
    movement alone (dvae_tpu/parallel/census.py:102-128): every gradient
    element crosses its data-parallel group (g = data × fsdp) reduced at
    least once a step, ≥ 2·(g−1)/g · bytes, counted at the bf16 floor
    (2 B an element); arms sharded over ``arm`` divide the volume.  Only
    the leaves' shapes are read (``utils.checkpoint.abstract_like``
    serves)."""
    from dvae_tpu_torch.train.step import tree_leaves

    g = mesh.shape["data"] * mesh.shape["fsdp"]
    if g <= 1:
        return 0.0
    arm = mesh.shape["arm"]
    total = 0.0
    for leaf in tree_leaves(params):
        if not hasattr(leaf, "shape"):
            continue
        n = int(np.prod(tuple(leaf.shape)))
        if arm > 1 and len(leaf.shape) and leaf.shape[0] % arm == 0:
            n //= arm
        total += 2.0 * (g - 1) / g * n * 2  # bf16 floor
    return total


def analytic_check(strategy, stats, bound: float, mesh) -> tuple[bool, str]:
    """Structural + volume consistency of the census vs the ring model."""
    from dvae_tpu_torch.config import ShardingStrategy

    g = mesh.shape["data"] * mesh.shape["fsdp"]
    if g <= 1:
        # no data-parallel group: gradients never cross the wire
        return True, "trivial mesh (g=1)"
    probs = []
    strategy = ShardingStrategy(strategy)
    sharded_params = strategy in (ShardingStrategy.FULL_SHARD,
                                  ShardingStrategy.HYBRID_SHARD)
    if sharded_params and mesh.shape["fsdp"] > 1:
        if stats.counts.get("all-gather", 0) < 1:
            probs.append("sharded-param strategy emitted no all-gather")
    if not (stats.counts.get("all-reduce", 0)
            or stats.counts.get("reduce-scatter", 0)):
        probs.append("no gradient-reduction collective in the module")
    if stats.wire_bytes < 0.9 * bound:
        probs.append(
            f"wire bytes {stats.wire_bytes:.3g} below the gradient-traffic "
            f"lower bound {bound:.3g}")
    return (not probs), "; ".join(probs) or "ok"


# ---------------------------------------------------------------------------
# census rows
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CensusRow:
    strategy: str
    mode: str
    counts: dict
    wire_bytes: float
    wire_ms_per_step: float
    warnings: list
    analytic_ok: bool
    analytic_why: str
    compile_s: float

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def param_shapes(cfg) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors (shapes only, the
    JAX ``eval_shape`` of the initial state's parameters)."""
    import torch

    from dvae_tpu_torch.models.mixvae import _arm_shapes
    A = cfg.n_arm
    return {name: {"w": torch.empty((A, fi, fo), device="meta"),
                   "b": torch.empty((A, fo), device="meta")}
            for name, (fi, fo) in _arm_shapes(cfg).items()}


def activation_bytes(cfg, tcfg, mesh) -> int:
    """Bytes of one (A_local, B_local, D) tensor of the compute dtype: the
    least payload of a collective that moves an input or an activation
    across ranks."""
    from dvae_tpu_torch.train.step import _spmd_axes
    arm_axes, batch_axes = _spmd_axes(cfg, tcfg) or ((), ())
    a = cfg.n_arm // mesh.axis_size(arm_axes)
    b = tcfg.batch_size // mesh.axis_size(batch_axes)
    return a * b * cfg.input_dim * (2 if tcfg.bf16 else 4)


def production_row(strategy, mode: str, mesh, n_train: int = 5000,
                   batch: int = 5000, ici_gbps: Optional[float] = None,
                   cfg=None, bf16: bool = True, device=None) -> CensusRow:
    """Execute the production-shape epoch runner (one step by default) for
    one strategy × mode on this rank's ``mesh`` (every rank calls); census
    and cross-check its collectives.  ``cfg`` overrides
    ``production_cfg(mode)`` (the tests' small widths)."""
    from dvae_tpu_torch.config import ShardingStrategy, TrainConfig
    from dvae_tpu_torch.parallel.collective_cost import (
        NVLINK_GBPS, epoch_runner_collective_stats)

    strategy = ShardingStrategy(strategy)
    cfg = cfg or production_cfg(mode)
    if mode == "ZINB":
        cfg = dataclasses.replace(cfg, mode="ZINB")
    tcfg = TrainConfig(batch_size=batch, epochs_per_jit=1, bf16=bf16,
                       shuffle_block=8 if batch % 8 == 0 else 1,
                       mesh=mesh_config_for(mesh), sharding=strategy)
    augment = (_augment_fn(cfg.input_dim, bf16=bf16, device=device or "cuda")
               if mode == "aug" else None)
    info: dict = {}
    stats = epoch_runner_collective_stats(cfg, tcfg, strategy, mesh, n_train,
                                          augment=augment, device=device,
                                          info=info)
    floor = activation_bytes(cfg, tcfg, mesh)
    warnings = [f"{r.kind} of {r.nbytes} B ({r.dtype}, group {r.group_size})"
                f" >= one (A_l, B_l, D) tensor ({floor} B)"
                for r in info["records"] if r.nbytes >= floor]
    bound = grad_traffic_lower_bound(param_shapes(cfg), mesh)
    ok, why = analytic_check(strategy, stats, bound, mesh)
    return CensusRow(
        strategy=strategy.value, mode=mode, counts=dict(stats.counts),
        wire_bytes=stats.wire_bytes,
        wire_ms_per_step=stats.ici_seconds(ici_gbps or NVLINK_GBPS) * 1e3,
        warnings=warnings, analytic_ok=ok, analytic_why=why,
        compile_s=round(info["seconds"], 3))


def _small_data(cfg, n_train: int) -> np.ndarray:
    """dvae_tpu/parallel/census.py:239-240's inputs, bit for bit."""
    return np.maximum(np.random.default_rng(0).normal(
        1.0, 1.0, (n_train, cfg.input_dim)), 0.0).astype(np.float32)


def small_equality(mode: str, mesh, strategies=None, rtol: float = 2e-4,
                   device=None, state=None, draws=None) -> dict:
    """Execute the small-shape epoch runner under every strategy on this
    rank's ``mesh`` (every rank calls); assert identical numerics (cross-
    rank reductions reassociate sums, hence the small tolerance).  Returns
    {strategy value: per-epoch losses (numpy)}.

    ``state``: a whole ``TrainState`` to start from (default: fresh
    weights from seed 7, the JAX function's ``key(7)`` in spirit);
    ``draws``: a list of (x (B, D), ``Noise``) per step of the epoch, run
    through the mesh train step in place of the runner's own permutation
    and noise, whose loss is their mean (the JAX package's draws carried
    across)."""
    import torch

    from dvae_tpu_torch.config import ShardingStrategy, TrainConfig
    from dvae_tpu_torch.parallel.sharding import place_state, state_specs
    from dvae_tpu_torch.train.step import (init_train_state,
                                           make_epoch_runner, make_optimizer,
                                           make_train_step, tree_leaves,
                                           tree_like)

    dev = torch.device(device or "cuda")
    strategies = [ShardingStrategy(s)
                  for s in (strategies or list(ShardingStrategy))]
    arm = mesh.shape["arm"]
    cfg = small_cfg(mode, n_arm=max(2, arm))
    n_batch = mesh.shape["data"] * mesh.shape["fsdp"]
    B = 16 * max(1, n_batch)
    tcfg = TrainConfig(batch_size=B, epochs_per_jit=1,
                       mesh=mesh_config_for(mesh))
    n_train = 2 * B
    x = torch.from_numpy(_small_data(cfg, n_train)).to(dev)
    augment = (_augment_fn(cfg.input_dim, bf16=False, n_dim=20, device=dev)
               if mode == "aug" else None)

    opt = make_optimizer(cfg)
    losses = {}
    for strat in strategies:
        tc = dataclasses.replace(tcfg, sharding=strat)
        if state is None:
            st = init_train_state(7, cfg, opt, device=dev)
        else:
            st = state._replace(params=tree_like(state.params, [
                p.to(dev).clone() for p in tree_leaves(state.params)]),
                bn=tree_like(state.bn, [v.to(dev).clone()
                                        for v in tree_leaves(state.bn)]),
                mask=state.mask.to(dev))
            st = st._replace(opt_state=opt.init(st.params))
        st = place_state(st, state_specs(cfg, strat, mesh), mesh)
        if draws is None:
            run = make_epoch_runner(cfg, tc, opt, n_train, augment=augment,
                                    mesh=mesh)
            _, ems = run(st, x, None, 1.0)
            total = ems.total.cpu().numpy()
        else:
            step = make_train_step(cfg, tc, opt, augment, mesh)
            ts = []
            for xb, noise in draws:
                noise = type(noise)(*(t.to(dev) if torch.is_tensor(t) else t
                                      for t in noise))
                st, m, _ = step(st, xb.to(dev), None, 1.0, noise=noise)
                ts.append(m.total)
            total = torch.stack(ts).mean(0, keepdim=True).cpu().numpy()
        assert np.isfinite(total).all(), f"{mode}/{strat.value}: {total}"
        losses[strat.value] = total
    base = next(iter(losses.values()))
    for k, v in losses.items():
        np.testing.assert_allclose(
            v, base, rtol=rtol,
            err_msg=f"strategy {k} diverged from the matrix ({mode})")
    return losses


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def census_cells(strategies=None, modes: Sequence[str] = MODES,
                 small: bool = True, ledger: Optional[dict] = None) -> list:
    """Census cells in execution-priority order, tagged by kind:
    ``("prod", strategy, mode)`` production cells and ``("small", None,
    mode)`` executed strategy-equality cells
    (dvae_tpu/parallel/census.py:273-320): the headline FULL_SHARD/MSE
    cell, then ``small:MSE``, then FULL_SHARD's other modes; the rest is a
    pool that ``ledger`` (cell key → last-verified tick) rotates, stalest
    first, production cells before equality cells at equal staleness,
    canonical order as the tie-break."""
    from dvae_tpu_torch.config import ShardingStrategy

    strategies = [ShardingStrategy(s)
                  for s in (strategies or list(ShardingStrategy))]
    FS = ShardingStrategy.FULL_SHARD
    head = [m for m in modes] if FS in strategies else []
    cells: list = []
    if "MSE" in modes:
        if FS in strategies:
            cells.append(("prod", FS, "MSE"))
        if small:
            cells.append(("small", None, "MSE"))
    cells += [("prod", FS, m) for m in head if m != "MSE"]
    tail = [("prod", s, "MSE") for s in strategies
            if s is not FS and "MSE" in modes]
    tail += [("prod", s, m) for m in modes if m != "MSE"
             for s in strategies if s is not FS]
    if small:
        tail += [("small", None, m) for m in modes if m != "MSE"]
    if ledger:
        order = {id(c): i for i, c in enumerate(tail)}
        tail.sort(key=lambda c: (
            ledger.get(f"{c[1].value if c[1] else 'small'}/{c[2]}", 0),
            c[0] == "small", order[id(c)]))
    return cells + tail


def run_census(mesh, budget_s: Optional[float] = None,
               modes: Sequence[str] = MODES, strategies=None,
               do_small: bool = True, log=print,
               ledger_path: Optional[str] = None, device=None) -> dict:
    """Run the census within ``budget_s`` (None = unbounded), highest-value
    cells first; raise on any warning / analytic / equality failure; return
    the summary dict (rows + equality losses + what was skipped).

    ``clean`` requires every production row that ran to be warning-free
    and ring-consistent AND (when ``do_small``) at least one executed
    equality cell to have passed.  ``ledger_path``: JSON file mapping
    "strategy/mode" → the tick the cell last verified clean; cells are
    attempted stalest-first and the ledger is rewritten after every landed
    cell (by rank 0 on a world).  Every rank of the world must call, with
    the same budget: the cells are collective, and the deadline is each
    rank's own, so a world should give them room (a cell reserves 60 s, an
    equality cell 120 s)."""
    import torch

    from dvae_tpu_torch.parallel.runtime import (broadcast, process_info,
                                                 world_group)

    rank = process_info()[0]
    world = world_group()
    deadline = (time.monotonic() + budget_s) if budget_s is not None else None

    def left() -> float:
        """Rank 0's time left, on every rank (the ranks must agree on
        which cells run)."""
        t = float("inf") if deadline is None else deadline - time.monotonic()
        if world is None:
            return t
        buf = torch.tensor([t], dtype=torch.float64, device=device or "cpu")
        return float(broadcast(buf, 0, world).cpu())

    ledger: dict = {}
    if ledger_path:
        try:
            with open(ledger_path) as fh:
                ledger = json.load(fh)
        except (OSError, ValueError):
            ledger = {}
    tick = 1 + max((v for v in ledger.values()
                    if isinstance(v, (int, float))), default=0)

    def credit(key: str) -> None:
        if ledger_path and rank == 0:
            ledger[key] = tick
            try:
                with open(ledger_path, "w") as fh:
                    json.dump(ledger, fh, indent=0, sort_keys=True)
            except OSError:
                pass

    rows, skipped = [], []
    equality: dict = {}
    for kind, strat, mode in census_cells(strategies, modes, small=do_small,
                                          ledger=ledger):
        if kind == "prod":
            if left() < 60:
                skipped.append(f"prod:{strat.value}/{mode}")
                continue
            row = production_row(strat, mode, mesh, device=device)
            rows.append(row)
            log(f"census: prod {strat.value}/{mode}: "
                f"wire {row.wire_bytes / 1e6:.1f} MB/step "
                f"({row.wire_ms_per_step:.3f} ms @450GB/s), "
                f"warnings={len(row.warnings)}, analytic={row.analytic_why} "
                f"[{row.compile_s}s]")
            if row.warnings:
                raise AssertionError(
                    f"activation-sized collectives at {strat.value}/{mode}:\n"
                    + "\n".join(row.warnings[:5]))
            if not row.analytic_ok:
                raise AssertionError(
                    f"collective census inconsistent with the ring model at "
                    f"{strat.value}/{mode}: {row.analytic_why}")
            credit(f"{strat.value}/{mode}")
        else:
            if left() < 120:
                skipped.append(f"small:{mode}")
                continue
            losses = small_equality(mode, mesh, strategies, device=device)
            equality[mode] = {k: [float(x) for x in v]
                              for k, v in losses.items()}
            credit(f"small/{mode}")
            log(f"census: small {mode}: {len(losses)} strategies loss-equal "
                f"(last epoch {next(iter(losses.values()))[-1]:.4f})")

    summary = {
        "mesh": dict(mesh.shape),
        "rows": [r.to_json() for r in rows],
        "equality": equality,
        "skipped": skipped,
        "clean": (all(not r.warnings and r.analytic_ok for r in rows)
                  and (bool(equality) or not do_small)),
    }
    n_prod = sum(1 for k, *_ in census_cells(strategies, modes, small=False)
                 if k == "prod")
    log(f"census summary: {len(rows)}/{n_prod} production rows clean "
        f"(no activation-sized collective, ring-model consistent), "
        f"{len(equality)}/{len(list(modes))} modes strategy-loss-equal"
        + (f", skipped={skipped}" if skipped else ""))
    return summary


def add_world_flags(ap) -> None:
    """``cli train``'s multi-process flags on an argparse parser."""
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda")


def main(argv=None) -> int:
    """``python -m dvae_tpu_torch.parallel.census --num_processes N
    --process_id r --coordinator host:port [--mesh d,a,f] [--budget-s S]
    [--out F]``, once per rank."""
    import argparse

    from dvae_tpu_torch.config import MeshConfig
    from dvae_tpu_torch.parallel.runtime import (initialize_distributed,
                                                 process_info,
                                                 rank_device, shutdown)
    from dvae_tpu_torch.parallel.sharding import make_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_world_flags(ap)
    ap.add_argument("--mesh", default=None, help="data,arm,fsdp")
    ap.add_argument("--budget-s", type=float, default=None)
    ap.add_argument("--out", default=None, help="write summary JSON here")
    args = ap.parse_args(argv)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, backend=args.dist_backend,
                           device=args.device)
    try:
        rank, world = process_info()
        if args.mesh:
            d, a, f = (int(v) for v in args.mesh.split(","))
        else:
            d, a, f = {8: (2, 2, 2), 16: (4, 2, 2)}.get(world, (world, 1, 1))
        mesh = make_mesh(MeshConfig(data=d, arm=a, fsdp=f))
        summary = run_census(mesh, budget_s=args.budget_s,
                             device=rank_device(args.device),
                             log=print if rank == 0 else (lambda *_: None))
        if args.out and rank == 0:
            with open(args.out, "w") as fh:
                json.dump(summary, fh, indent=1)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
