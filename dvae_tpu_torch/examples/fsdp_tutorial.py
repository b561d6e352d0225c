"""The FSDP tutorial's classifier and benchmark run, on one card.

Counterpart of dvae_tpu/examples/fsdp_tutorial.py (the reference's
``fsdp_tutorial.py``: ShallowNet/DeepNet :25-81, train/test :116-174, the
epoch loop :177-254; and ``fsdp_mnist.py``: the sharding matrix :215-228,
mixed precision :231-236, timing :401-452, the run artifact :477-495).

On one device a ``ShardingStrategy`` is a placement only, so every
strategy runs here and gives the same numbers bit for bit.  Placement
across several cards (``make_mesh_1d``, ``mlp_shardings``, ``n_devices``
above 1) arrives with the second multi-GPU slice of the port (A6-2) and
is refused until then.  Mixed precision is a compute-dtype cast (f32
master weights).
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
from dvae_tpu_torch.utils.device import not_ported, resolve_device
from dvae_tpu_torch.train.step import (Adam, optimizer_step, tree_leaves,
                                       tree_like)
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
# Sharding: placement across several cards, refused on one
# ---------------------------------------------------------------------------

def make_mesh_1d(n_devices: Optional[int] = None):
    raise not_ported("a device mesh", "multi-GPU (A6-2)")


def mlp_shardings(params, mesh, strategy: ShardingStrategy):
    raise not_ported("parameter sharding across devices",
                     "multi-GPU (A6-2)")


def _one_device(n_devices: Optional[int], device) -> torch.device:
    """The one card (or the CPU) a run uses; more devices are refused."""
    if n_devices not in (None, 1):
        raise not_ported(f"a run on {n_devices} devices",
                         "multi-GPU (A6-2)")
    return resolve_device(device)


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


def train_mnist_fsdp(model: str = "shallow",
                     strategy: ShardingStrategy = ShardingStrategy.FULL_SHARD,
                     n_epochs: int = 2, batch_size: int = 512,
                     lr: float = 1e-3, precision: str = "fp32",
                     n_devices: Optional[int] = None,
                     data=None, test_data=None, seed: int = 0,
                     verbose: bool = True, device="cuda") -> RunResult:
    """The whole tutorial in one function; returns the benchmark artifact.

    The data are staged on the device once; each epoch draws JAX's
    permutation (``default_rng(seed)``) and gathers its batches there.  The
    step losses stay on the device until the epoch ends: one read of them
    stops the epoch's clock, one more reads the test accuracy."""
    strategy = ShardingStrategy(strategy)
    dev = _one_device(n_devices, device)
    cfg = MLPConfig.shallow() if model == "shallow" else MLPConfig.deep()
    compute_dtype = {"fp32": None, "bf16": torch.bfloat16,
                     "fp16": torch.float16}[precision]

    x, y = data if data is not None else synthetic_mnist(8192, seed)
    xt, yt = test_data if test_data is not None else synthetic_mnist(2048,
                                                                     seed + 1)
    params = init_mlp(torch.Generator().manual_seed(seed), cfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tx = Adam(lr)
    opt_state = tx.init(params)
    x_d, y_d = to_device(x, dev), to_device(np.asarray(y, np.int64), dev)
    xt_d, yt_d = to_device(xt, dev), to_device(np.asarray(yt, np.int64), dev)

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
            sel = order_d[i * batch_size: (i + 1) * batch_size]
            xb, yb = x_d[sel], y_d[sel]
            opt_state, loss, _ = optimizer_step(
                lambda p: (F.cross_entropy(apply_mlp(p, xb, compute_dtype),
                                           yb), None), params, tx, opt_state)
            step_losses.append(loss)
        host = torch.stack(step_losses).cpu().numpy()
        epoch_times.append(time.perf_counter() - t0)
        losses.append(float(np.mean(host.astype(np.float64))))
        with torch.no_grad():
            logits = apply_mlp(params, xt_d, compute_dtype)
            acc = float((logits.argmax(-1) == yt_d).float().mean())
        accs.append(acc)
        if verbose:
            print(f"epoch {e}: loss={losses[-1]:.4f} acc={acc:.4f} "
                  f"({epoch_times[-1]:.2f}s)")

    return RunResult(strategy.value, precision, 1, n_params, epoch_times,
                     losses, accs)

