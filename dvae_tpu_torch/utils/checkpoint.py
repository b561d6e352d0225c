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
    optimizer leaves as numpy.

Writing goes the other way (``_PortPickler``): the port's config classes
are pickled under ``dvae_tpu.config`` and the stand-ins under their optax
names, so the JAX package reads a checkpoint of the port with plain
``pickle`` and resumes it, optimizer state included.
``adam_state_from_jax`` / ``adam_state_to_jax`` map optax's
``ScaleByAdamState(count, mu, nu)`` to and from the port's Adam state.

``params_from_jax`` / ``bn_from_jax`` turn the numpy pytrees into tensors
(and ``*_to_jax`` back): the weight bridge between the two packages.  The
layout is the JAX one, stacked leading arm axis, ``(A, fan_in, fan_out)``.
``augmenter_from_jax`` / ``augmenter_to_jax`` do the same for the trees
of the augmenter, its generator and its discriminator
(``augment/augmenter.py``); augmenter checkpoints use this format too.
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


class Bfloat16Bits(np.void):
    """Stand-in scalar type for ``ml_dtypes.bfloat16``, under which the JAX
    package pickles bf16 arrays (numpy has no bf16 of its own): an array of
    it keeps the 16 raw bits of each value, and ``_tree_to_torch`` views
    them as ``torch.bfloat16``.  The port needs no ``ml_dtypes``."""


class ForeignState(tuple):
    """Stand-in for an optimizer-state named tuple pickled by the JAX
    package.  ``kind`` is the original ``module.Name``; the fields keep
    their order and stay numpy.  Pickles back under its own name."""

    kind = "?"

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __reduce__(self):
        return type(self), tuple(self)

    def __repr__(self):
        return f"ForeignState[{self.kind}]{tuple.__repr__(self)}"


@functools.cache
def _foreign_class(kind: str) -> type:
    return type(kind.rsplit(".", 1)[-1], (ForeignState,), {"kind": kind})


def foreign_state(kind: str, fields: tuple) -> ForeignState:
    return _foreign_class(kind)(*fields)


def adam_state_to_jax(count: int, mu, nu, n_empty: int = 1) -> tuple:
    """optax's state of adam (``n_empty`` = 1) or adamw (2):
    (ScaleByAdamState(count, mu, nu), EmptyState(), ...) with numpy leaves."""
    adam = foreign_state(_ADAM_KIND, (np.asarray(count, np.int32),
                                      _to_numpy(mu), _to_numpy(nu)))
    return (adam,) + tuple(foreign_state(_EMPTY_KIND, ())
                           for _ in range(n_empty))


def adam_state_from_jax(opt_state) -> Optional[tuple]:
    """(count, mu, nu) of the ScaleByAdamState inside a loaded optax state
    (numpy trees), or None when it holds none."""
    for part in opt_state or ():
        if isinstance(part, ForeignState) and part.kind == _ADAM_KIND:
            count, mu, nu = part
            return int(np.asarray(count)), mu, nu
    return None


_ADAM_KIND = "optax._src.transform.ScaleByAdamState"
_EMPTY_KIND = "optax._src.base.EmptyState"


def _global_name(obj) -> Optional[tuple]:
    """(module, name) under which the port pickles ``obj``, or None."""
    if isinstance(obj, type) and issubclass(obj, ForeignState):
        return tuple(obj.kind.rsplit(".", 1))
    if getattr(obj, "__module__", None) == "dvae_tpu_torch.config":
        return "dvae_tpu.config", obj.__qualname__
    return None


class _PortPickler(pickle._Pickler):
    """Pickles the stand-ins and the port's config classes under the names
    the JAX package knows (written as a STACK_GLOBAL of the two names:
    neither optax nor dvae_tpu is imported to write them)."""

    def save_global(self, obj, name=None):
        target = _global_name(obj)
        if target is None:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == "dvae_tpu.config" or module == "dvae_tpu_torch.config":
            from dvae_tpu_torch import config
            return getattr(config, name)
        if module == "optax" or module.startswith("optax."):
            return _foreign_class(f"{module}.{name}")
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return Bfloat16Bits
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
        _PortPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(
            {"tree": _to_numpy(tree), "metadata": metadata or {}})
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
    if tree is None:  # a bias-free layer's "b"
        return None
    arr = np.array(tree)  # a copy: JAX arrays are read-only
    if arr.dtype.type is Bfloat16Bits or arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
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


def augmenter_from_jax(params, bn, device="cpu", dtype=torch.float32):
    """The numpy pytrees of the augmenter, its generator or its
    discriminator (dvae_tpu/augment/augmenter.py: flat ``(fan_in,
    fan_out)`` weights; the augmenter's bias-free ``noise`` layer, whose
    ``b`` is None, and ``bnz`` with its affine ``scale``/``bias``) →
    (params, bn) of tensors; layout unchanged.  The weights are cast to
    ``dtype``: the committed checkpoints store them in bf16, which JAX
    promotes against f32 activations in every product and torch does not,
    so the port widens them once (exactly).  The statistics keep their
    stored f32."""
    return _tree_to_torch(params, device, dtype), _tree_to_torch(bn, device)


def augmenter_to_jax(params, bn):
    """Inverse of ``augmenter_from_jax``: the (params, bn) numpy trees the
    JAX package's augmenter, generator and discriminator take (a None leaf
    stays None)."""
    return _to_numpy(params), _to_numpy(bn)


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


def newest_checkpoint(folder: str, pattern: str = "*.ckpt") -> Optional[str]:
    """Newest checkpoint by mtime, tag-only ones (``best_*``) included; None
    for an empty ``folder`` argument."""
    if not folder:
        return None
    files = glob.glob(os.path.join(folder, pattern))
    return max(files, key=os.path.getmtime) if files else None


def _run_base(base: str, prefix: str) -> str:
    """``base`` and ``prefix`` joined; a bare directory base gets a path
    separator (dvae_tpu/utils/checkpoint.py:139-147)."""
    if base and not base.endswith(os.sep):
        return base + os.sep + prefix
    return f"{base}{prefix}"


def make_run_dir(base: str, prefix: str = "") -> str:
    """Create and return the next ``{base}{prefix}_RUN{n}`` folder."""
    stem = _run_base(base, prefix)
    n = 0
    while os.path.exists(f"{stem}_RUN{n}"):
        n += 1
    path = f"{stem}_RUN{n}"
    os.makedirs(path, exist_ok=True)
    return path


def latest_run_dir(base: str, prefix: str = "") -> Optional[str]:
    """Newest existing ``{base}{prefix}_RUN{n}`` folder, or None."""
    def num(p: str) -> int:
        m = re.search(r"_RUN(\d+)$", p)
        return int(m.group(1)) if m else -1

    runs = [r for r in glob.glob(f"{_run_base(base, prefix)}_RUN*")
            if num(r) >= 0]
    return max(runs, key=num) if runs else None
