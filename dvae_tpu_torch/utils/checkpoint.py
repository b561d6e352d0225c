"""Pickle-of-numpy checkpoints, readable by both packages.

The JAX package writes ``{"tree": <numpy pytree>, "metadata": dict}`` with
``pickle`` (dvae_tpu/utils/checkpoint.py:34-62).  Such a file also pickles
references to the optimizer's state classes (``optax._src.base.EmptyState``,
``optax._src.transform.ScaleByAdamState``) and to the JAX package's
``ReparamNoise`` enum inside the ``cfg`` metadata.  A plain ``pickle.load``
would import optax, and through it JAX.  ``_PortUnpickler`` maps those
references instead:

  * ``dvae_tpu.config.*`` → this package's own ``config``;
  * ``optax.*`` → ``ForeignState``, a tuple stand-in that keeps the
    optimizer leaves as numpy for the training slice.

``params_from_jax`` / ``bn_from_jax`` turn the numpy pytrees into tensors
(and ``*_to_jax`` back): the weight bridge between the two packages.  The
layout is the JAX one, stacked leading arm axis, ``(A, fan_in, fan_out)``.
"""

from __future__ import annotations

import functools
import glob
import os
import pickle
import re
from typing import Any, Optional

import numpy as np
import torch


class ForeignState(tuple):
    """Stand-in for an optimizer-state named tuple pickled by the JAX
    package.  ``kind`` is the original ``module.Name``; the fields keep
    their order and stay numpy.  Pickles back under its own name."""

    kind = "?"

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __reduce__(self):
        return foreign_state, (self.kind, tuple(self))

    def __repr__(self):
        return f"ForeignState[{self.kind}]{tuple.__repr__(self)}"


@functools.cache
def _foreign_class(kind: str) -> type:
    return type(kind.rsplit(".", 1)[-1], (ForeignState,), {"kind": kind})


def foreign_state(kind: str, fields: tuple) -> ForeignState:
    return _foreign_class(kind)(*fields)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "dvae_tpu.config" or module == "dvae_tpu_torch.config":
            from dvae_tpu_torch import config
            return getattr(config, name)
        if module == "optax" or module.startswith("optax."):
            return _foreign_class(f"{module}.{name}")
        if module.split(".")[0] in ("jax", "jaxlib", "dvae_tpu"):
            raise pickle.UnpicklingError(
                f"checkpoint references {module}.{name}, which the port "
                "does not map")
        return super().find_class(module, name)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, ForeignState):
        return foreign_state(tree.kind, tuple(_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            raise TypeError("bf16 tensors have no numpy dtype; store f32")
        return t.numpy()
    if tree is None:
        return None
    return np.asarray(tree)


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[dict] = None) -> str:
    """Write a pytree of tensors/arrays (+ small metadata dict) in the JAX
    package's pickle-of-numpy format.  Returns the written path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"tree": _to_numpy(tree), "metadata": metadata or {}}, f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return path


def load_checkpoint(path: str):
    """(tree, metadata) of a pickle checkpoint written by either package.
    Orbax directories (the JAX package's other format) are not read."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax directory; the port reads the "
                         "pickle format only")
    with open(path, "rb") as f:
        out = _PortUnpickler(f).load()
    return out["tree"], out.get("metadata", {})


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------

def _tree_to_torch(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))  # a copy: JAX arrays are read-only
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, device="cpu", dtype=None):
    """Stacked-arm parameter pytree (numpy) → the same nested dict of
    tensors; layout unchanged, ``(A, fan_in, fan_out)`` weights."""
    return _tree_to_torch(tree, device, dtype)


def bn_from_jax(tree, device="cpu", dtype=None):
    """Batch-norm running statistics (numpy) → tensors."""
    return _tree_to_torch(tree, device, dtype)


def params_to_jax(tree):
    """Inverse of ``params_from_jax``: nested dict of numpy arrays."""
    return _to_numpy(tree)


bn_to_jax = params_to_jax


# ---------------------------------------------------------------------------
# Checkpoint discovery (dvae_tpu/utils/checkpoint.py:125-163)
# ---------------------------------------------------------------------------

_EPOCH_RE = re.compile(r"_epoch_(\d+)")


def parse_epoch(filename: str) -> int:
    """Epoch number from a checkpoint filename; -1 if absent."""
    m = _EPOCH_RE.search(os.path.basename(filename))
    return int(m.group(1)) if m else -1


def latest_checkpoint(folder: str, pattern: str = "*_epoch_*") -> Optional[str]:
    """Checkpoint discovery: glob + max epoch."""
    files = [f for f in glob.glob(os.path.join(folder, pattern))
             if parse_epoch(f) >= 0]
    return max(files, key=parse_epoch) if files else None
