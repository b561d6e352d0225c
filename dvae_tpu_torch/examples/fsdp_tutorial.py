"""The FSDP tutorial's classifier and benchmark run, on one card or on a
data-parallel group of several.

Counterpart of dvae_tpu/examples/fsdp_tutorial.py (the reference's
``fsdp_tutorial.py``: ShallowNet/DeepNet :25-81, train/test :116-174, the
epoch loop :177-254; and ``fsdp_mnist.py``: the sharding matrix :215-228,
mixed precision :231-236, timing :401-452, the run artifact :477-495).

Several devices are one process per device, joined by
``torch.distributed`` (``parallel.runtime.initialize_distributed``):
``make_mesh_1d(n)`` is the ``dp`` group of the world's first n ranks
(None: the whole world), and a rank outside it gets None and takes no
part.  ``mlp_shardings`` keeps the JAX rule as spec tuples: under
FULL_SHARD or HYBRID each 2-D weight shards on dim 1 where the group
divides it, else on dim 0; every other leaf is replicated.  A step
splits the batch over ``dp``, computes on the gathered weights, averages
the gradients over the group and updates each rank's blocks, the Adam
moments placed by the ZeRO rule.  On one device a strategy is a
placement only, so all six give the same numbers bit for bit.  Mixed
precision is a compute-dtype cast (f32 master weights).
MNIST images are synthesized (``synthetic_mnist``, numpy, the JAX
function's bits); pass ``data=(x, y)`` to use real MNIST.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dvae_tpu_torch.config import ShardingStrategy
from dvae_tpu_torch.parallel.runtime import (all_reduce, process_info,
                                             rank_device)
from dvae_tpu_torch.parallel.sharding import (DPMesh, gather_tree,
                                              make_dp_mesh, place, tree_map)
from dvae_tpu_torch.train.step import (Adam, sharded_optimizer_step,
                                       tree_leaves, tree_like)
from dvae_tpu_torch.utils.device import resolve_device
from dvae_tpu_torch.utils.host_ops import to_device


# ---------------------------------------------------------------------------
# Models (reference fsdp_tutorial.py:25-81, fsdp_mnist.py:94-170)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MLPConfig:
    """ShallowNet ≈1.2M params (widths [128, 128]); DeepNet ≈93M
    (widths [4096]*5) — matching the reference benchmark scales."""

    input_dim: int = 784
    n_classes: int = 10
    widths: tuple = (128, 128)

    @staticmethod
    def shallow() -> "MLPConfig":
        return MLPConfig(widths=(1024, 128))           # ≈0.95M params

    @staticmethod
    def deep() -> "MLPConfig":
        # 6×4096 hidden ≈ 87M params (reference DeepNet ≈93M)
        return MLPConfig(widths=(4096,) * 6)


def init_mlp(generator: torch.Generator, cfg: MLPConfig,
             dtype=torch.float32, device="cuda"):
    """A list of ``{"w": (fan_in, fan_out), "b": (fan_out,)}``, each entry
    uniform in ±1/√fan_in (the JAX function's bounds; its draws are JAX's
    own, so carry its weights with ``utils.checkpoint.mlp_params_from_jax``
    where the two must agree).  Drawn on the generator's device, then
    moved to ``device``."""
    dims = (cfg.input_dim,) + tuple(cfg.widths) + (cfg.n_classes,)
    params = []
    for fi, fo in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(fi)
        layer = {}
        for name, shape in (("w", (fi, fo)), ("b", (fo,))):
            t = torch.empty(shape, dtype=dtype, device=generator.device)
            layer[name] = t.uniform_(-bound, bound, generator=generator)
        params.append(layer)
    return tree_like(params, [to_device(p, device)
                              for p in tree_leaves(params)])


def apply_mlp(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """f32 logits of the ReLU MLP; with ``compute_dtype`` the input and the
    parameters are cast to it first."""
    h = x.reshape(x.shape[0], -1)
    if compute_dtype is not None:
        h = h.to(compute_dtype)
        params = [{k: v.to(compute_dtype) for k, v in layer.items()}
                  for layer in params]
    for layer in params[:-1]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    logits = h @ params[-1]["w"] + params[-1]["b"]
    return logits.float()


# ---------------------------------------------------------------------------
# Sharding (the tutorial's core lesson)
# ---------------------------------------------------------------------------

def make_mesh_1d(n_devices: Optional[int] = None) -> Optional[DPMesh]:
    """The ``dp`` mesh of the world's first ``n_devices`` ranks (None: the
    whole world); None on a rank outside it.  More devices than the
    world's ranks is a ``ValueError``."""
    return make_dp_mesh(n_devices)


def _dp_rule(shard: bool, n: int):
    """The JAX rule of fsdp_tutorial.py:94-108 as spec tuples: a 2-D leaf
    sharded on dim 1 where ``n`` divides it, else on dim 0; the rest
    replicated."""
    def rule(p):
        shape = tuple(getattr(p, "shape", ()))
        if shard and len(shape) == 2:
            if shape[1] % n == 0:
                return (None, "dp")
            if shape[0] % n == 0:
                return ("dp", None)
        return ()
    return rule


def mlp_shardings(params, mesh: DPMesh, strategy: ShardingStrategy):
    """FULL_SHARD/HYBRID shard each weight's dim 1 (else dim 0) over the
    mesh; the other strategies replicate (the ZeRO-2 flavours shard only
    the optimizer state, placed by the caller).  ``mesh`` None (a rank
    outside the group) is a ``ValueError``."""
    if mesh is None:
        raise ValueError(f"no mesh: this rank is outside the data-parallel "
                         f"group (a world of {process_info()[1]})")
    shard = ShardingStrategy(strategy) in (ShardingStrategy.FULL_SHARD,
                                           ShardingStrategy.HYBRID_SHARD)
    return tree_map(_dp_rule(shard, mesh.size), params)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def synthetic_mnist(n: int = 60_000, seed: int = 0, proto_seed: int = 1234):
    """Class-conditional blobs with MNIST's shape (N, 784) / labels 0-9.

    The class prototypes come from ``proto_seed`` (fixed) so different
    ``seed`` values give train/test splits of the SAME distribution."""
    protos = np.random.default_rng(proto_seed).random((10, 784))
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 10, n)
    x = protos[y] + 0.3 * rng.normal(0, 1, (n, 784))
    return x.astype(np.float32), y.astype(np.int32)


# ---------------------------------------------------------------------------
# Train / eval
# ---------------------------------------------------------------------------

class RunResult(NamedTuple):
    """The run-artifact dict of the reference benchmark
    (fsdp_mnist.py:477-495), structured."""

    strategy: str
    precision: str
    n_devices: int
    n_params: int
    epoch_times_s: list
    train_losses: list
    test_accs: list


def _rows(mesh: DPMesh, n: int) -> slice:
    """This rank's rows of an ``n``-row batch split over ``dp``; all of
    them where the group does not divide ``n``."""
    if mesh.size == 1 or n % mesh.size:
        return slice(0, n)
    k = n // mesh.size
    return slice(mesh.dp.index * k, mesh.dp.index * k + k)


def train_mnist_fsdp(model: str = "shallow",
                     strategy: ShardingStrategy = ShardingStrategy.FULL_SHARD,
                     n_epochs: int = 2, batch_size: int = 512,
                     lr: float = 1e-3, precision: str = "fp32",
                     n_devices: Optional[int] = None,
                     data=None, test_data=None, seed: int = 0,
                     verbose: bool = True,
                     device="cuda") -> Optional[RunResult]:
    """The whole tutorial in one function; returns the benchmark artifact
    (None on a rank outside the ``n_devices`` group).

    The data are staged on the device once; each epoch draws JAX's
    permutation (``default_rng(seed)``) and gathers its batches there.  On
    several devices each rank takes its rows of every batch (the batch
    must divide over the group), the test set likewise where the group
    divides it.  The step losses stay on the device until the epoch ends:
    one read of them stops the epoch's clock, one more reads the test
    accuracy."""
    strategy = ShardingStrategy(strategy)
    dev = resolve_device(device)
    mesh = make_mesh_1d(n_devices)
    if mesh is None:
        return None
    n_dev = mesh.size
    if n_dev > 1:
        dev = rank_device(dev)
    cfg = MLPConfig.shallow() if model == "shallow" else MLPConfig.deep()
    compute_dtype = {"fp32": None, "bf16": torch.bfloat16,
                     "fp16": torch.float16}[precision]

    x, y = data if data is not None else synthetic_mnist(8192, seed)
    xt, yt = test_data if test_data is not None else synthetic_mnist(2048,
                                                                     seed + 1)
    if batch_size % n_dev:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{n_dev} devices")
    params = init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tx = Adam(lr)
    opt_state = tx.init(params)
    shard_opt = strategy in (
        ShardingStrategy.FULL_SHARD, ShardingStrategy.HYBRID_SHARD,
        ShardingStrategy.SHARD_GRAD_OP, ShardingStrategy.HYBRID_SHARD_ZERO2)
    p_sh = mlp_shardings(params, mesh, strategy)
    o_sh = tree_map(_dp_rule(shard_opt, n_dev), params)   # opt_rule
    params = place(params, p_sh, mesh)
    opt_state = opt_state._replace(mu=place(opt_state.mu, o_sh, mesh),
                                   nu=place(opt_state.nu, o_sh, mesh))
    group = mesh.group("dp")
    x_d, y_d = to_device(x, dev), to_device(np.asarray(y, np.int64), dev)
    t_rows = _rows(mesh, xt.shape[0])
    xt_d = to_device(xt[t_rows], dev)
    yt_d = to_device(np.asarray(yt[t_rows], np.int64), dev)
    mine = _rows(mesh, batch_size)

    n = x.shape[0]
    steps = n // batch_size
    rng = np.random.default_rng(seed)
    epoch_times, losses, accs = [], [], []
    for e in range(n_epochs):
        order = rng.permutation(n)[: steps * batch_size]
        t0 = time.perf_counter()
        order_d = to_device(order, dev)
        step_losses = []
        for i in range(steps):
            sel = order_d[i * batch_size: (i + 1) * batch_size][mine]
            xb, yb = x_d[sel], y_d[sel]
            opt_state, loss, _ = sharded_optimizer_step(
                lambda p: (F.cross_entropy(apply_mlp(p, xb, compute_dtype),
                                           yb), None), params, tx, opt_state,
                p_sh, o_sh, mesh, group)
            step_losses.append(loss)
        host = torch.stack(step_losses).cpu().numpy()
        epoch_times.append(time.perf_counter() - t0)
        losses.append(float(np.mean(host.astype(np.float64))))
        with torch.no_grad():
            logits = apply_mlp(gather_tree(params, p_sh, mesh), xt_d,
                               compute_dtype)
            right = (logits.argmax(-1) == yt_d).float().sum()
            if t_rows.stop - t_rows.start < xt.shape[0]:
                right = all_reduce(right, group)
            acc = float(right / xt.shape[0])
        accs.append(acc)
        if verbose:
            print(f"epoch {e}: loss={losses[-1]:.4f} acc={acc:.4f} "
                  f"({epoch_times[-1]:.2f}s)")

    return RunResult(strategy.value, precision, n_dev, n_params, epoch_times,
                     losses, accs)
