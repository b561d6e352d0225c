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

On a mesh the file holds whole leaves, as one device's does: the trainer
gathers them on every rank before rank 0 writes
(``parallel.sharding.gather_state``), and cuts each rank's blocks out of
what it read (``place_state``), so a mesh's checkpoint serves on one
device and the other way round.

``save_sharded`` / ``restore_sharded`` are the multi-process path
(dvae_tpu/utils/checkpoint.py:79-125) on ``torch.distributed.checkpoint``
(DCP): every rank writes only its own blocks of a sharded tree, rank 0
writes ``dvae_meta.json``, and a restore lands each leaf in the
template's placement, which may be another mesh or strategy (DCP
reshards on load).  A block carries no spec, so both take ``specs=`` and
``mesh=``.  Such a directory is not the JAX package's orbax one (the
card's machine has no JAX): sharded checkpoints do not cross the
packages, and ``load_checkpoint`` refuses either kind of directory.

``params_from_jax`` / ``bn_from_jax`` turn the numpy pytrees into tensors
(and ``*_to_jax`` back): the weight bridge between the two packages.  The
layout is the JAX one, stacked leading arm axis, ``(A, fan_in, fan_out)``.
``augmenter_from_jax`` / ``augmenter_to_jax`` do the same for the trees
of the augmenter, its generator and its discriminator
(``augment/augmenter.py``); augmenter checkpoints use this format too.

``abstract_like`` (a tree of ``meta`` tensors: shapes and dtypes, no
bytes) and ``compare_pytrees`` (the reference's ``compare_state_dicts``)
walk trees of dicts, lists, tuples and named tuples, dict keys in sorted
order and None as an empty subtree, as JAX's tree utilities do.
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
    A directory (``save_sharded``'s, or the JAX package's orbax one) is
    not read here."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, ".metadata")):
            raise ValueError(f"{path} is a sharded checkpoint directory: "
                             "read it with restore_sharded(path, template, "
                             "specs=..., mesh=...) on the ranks of a mesh")
        raise ValueError(f"{path} is an orbax directory; the port reads the "
                         "pickle format only")
    with open(path, "rb") as f:
        out = _PortUnpickler(f).load()
    return out["tree"], out.get("metadata", {})


# ---------------------------------------------------------------------------
# Sharded checkpoints (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

def _spec_tree(tree, specs):
    """``specs`` as a tree of ``tree``'s structure: a
    ``parallel.sharding.StateSpecs`` becomes the spec tree of a
    ``train.step.TrainState`` (the mask replicated, the host integers
    without a spec)."""
    from dvae_tpu_torch.parallel.sharding import StateSpecs
    if not isinstance(specs, StateSpecs):
        return specs
    opt = tree.opt_state
    if opt is not None:
        opt = opt._replace(count=None, mu=specs.moments, nu=specs.moments)
    return tree._replace(params=specs.params, bn=specs.bn, mask=(),
                         seed=None, epoch=None, opt_state=opt)


def _flat_with_specs(tree, specs, path=""):
    """(key, leaf, spec) of every leaf of ``tree`` (None leaves skipped),
    keys spelled ``a/b/0``; a non-tensor leaf's spec is None."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_with_specs(tree[k], None if specs is None
                                        else specs[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            sub = None if specs is None else specs[i]
            name = tree._fields[i] if _is_namedtuple(tree) else str(i)
            yield from _flat_with_specs(v, sub, f"{path}/{name}")
    elif tree is not None:
        yield path.lstrip("/"), tree, specs


def _device_mesh(mesh, device_type: str):
    """A ``DeviceMesh`` of the port's (data, arm, fsdp) mesh (rank r at its
    row-major coordinates), without process groups of its own: DCP plans
    over the world's default group."""
    from torch.distributed.device_mesh import DeviceMesh
    cfg = mesh.cfg
    ranks = torch.arange(cfg.n_devices).reshape(cfg.data, cfg.arm, cfg.fsdp)
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=("data", "arm", "fsdp"),
                      _init_backend=False)


def _placements(spec, ndim: int):
    """DTensor placements of a spec tuple: mesh dim m shards tensor dim i
    where the spec's entry i names m's axis.  An entry of two axes
    (``("data", "fsdp")``) shards one tensor dim over both, data major,
    as DTensor orders mesh dims left to right and the port's
    ``local_block`` does."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for ax in ("data", "arm", "fsdp"):
        dims = [i for i, e in enumerate(tuple(spec)[:ndim])
                if e == ax or (isinstance(e, (tuple, list)) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _dtensor(block, spec, mesh, dmesh):
    """``block`` as this rank's piece of the whole leaf under ``spec``."""
    from torch.distributed.tensor import DTensor
    shape = list(block.shape)
    for i, e in enumerate(tuple(spec)[:block.dim()]):
        shape[i] *= mesh.axis_size(e)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block, dmesh, _placements(spec, block.dim()),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _sharded(mesh) -> bool:
    return (mesh is not None and getattr(mesh, "cfg", None) is not None
            and mesh.cfg.n_devices > 1)


def save_sharded(path: str, tree: Any, metadata: Optional[dict] = None, *,
                 specs, mesh) -> str:
    """Distributed save of a sharded tree on ``torch.distributed.checkpoint``.

    ``tree`` holds this rank's blocks, ``specs`` their spec tree (or the
    ``parallel.sharding.StateSpecs`` of a ``TrainState``), ``mesh`` this
    rank's ``parallel.sharding.Mesh``.  Every rank calls and writes only
    its own blocks (a replicated block once); non-tensor leaves (the
    state's seed, epoch and step count) are stored as objects.  Blocks in
    host memory (offloaded moments) are staged through the mesh's device.
    Rank 0 writes ``metadata`` to ``dvae_meta.json``.  Returns the
    absolute path."""
    import json

    import torch.distributed.checkpoint as dcp

    from dvae_tpu_torch.parallel.runtime import process_info

    path = os.path.abspath(path)
    specs = _spec_tree(tree, specs)
    sharded = _sharded(mesh)
    dmesh, dev = None, None
    state = {}
    for key, leaf, spec in _flat_with_specs(tree, specs):
        if isinstance(leaf, torch.Tensor) and sharded:
            if dmesh is None:
                dev = _mesh_device(tree)
                dmesh = _device_mesh(mesh, dev.type)
            leaf = _dtensor(leaf.to(dev), spec, mesh, dmesh)
        state[key] = leaf
    os.makedirs(path, exist_ok=True)
    dcp.save(state, checkpoint_id=path)
    if metadata and process_info()[0] == 0:
        with open(os.path.join(path, "dvae_meta.json"), "w") as f:
            json.dump(metadata, f)
    return path


def _mesh_device(tree) -> torch.device:
    """The device the mesh's blocks live on: the first tensor leaf's that
    is not on the host, else the CPU."""
    devs = [leaf.device for _, leaf in _leaves_with_path(tree)
            if isinstance(leaf, torch.Tensor)]
    return next((d for d in devs if d.type not in ("cpu", "meta")),
                torch.device("cpu"))


def restore_sharded(path: str, template: Any, *, specs, mesh):
    """Restore a ``save_sharded`` directory into ``template``'s placement:
    ``template`` is a tree of this rank's blocks (a freshly placed state)
    under ``specs`` on ``mesh``, which may be another mesh or strategy
    than the save's (DCP reshards on load).  Every rank calls.  Returns
    (tree, metadata): new tensors of the template's blocks, dtypes and
    devices (pinned host memory stays so; a ``meta`` leaf, as
    ``abstract_like`` makes, lands on the mesh's device), the non-tensor
    leaves as saved."""
    import json

    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    specs = _spec_tree(template, specs)
    sharded = _sharded(mesh)
    dev = _mesh_device(template)
    dmesh = _device_mesh(mesh, dev.type) if sharded else None
    state, blocks = {}, {}
    for key, leaf, spec in _flat_with_specs(template, specs):
        if isinstance(leaf, torch.Tensor) and leaf.is_meta and spec is None:
            leaf = 0   # ``abstract_like`` of a host integer: loaded as saved
        if isinstance(leaf, torch.Tensor):
            buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                              device=dev if sharded or leaf.is_meta
                              else leaf.device)
            blocks[key] = buf
            state[key] = (_dtensor(buf, spec, mesh, dmesh) if sharded
                          else buf)
        else:
            state[key] = leaf
    dcp.load(state, checkpoint_id=path)

    def rebuild(node, pre=""):
        if isinstance(node, dict):
            return {k: rebuild(node[k], f"{pre}/{k}") for k in node}
        if isinstance(node, (list, tuple)):
            names = (node._fields if _is_namedtuple(node)
                     else [str(i) for i in range(len(node))])
            out = [rebuild(v, f"{pre}/{n}") for v, n in zip(node, names)]
            return type(node)(*out) if _is_namedtuple(node) \
                else type(node)(out)
        if node is None:
            return None
        key = pre.lstrip("/")
        if key in blocks:
            out = blocks[key]
            if not node.is_meta and out.device != node.device:
                out = out.to(node.device)
                if node.is_pinned():
                    out = out.pin_memory()
            return out
        return state[key]

    meta_path = os.path.join(path, "dvae_meta.json")
    metadata = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metadata = json.load(f)
    return rebuild(template), metadata


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------

def _tree_to_torch(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if tree is None:  # a bias-free layer's "b"
        return None
    # a C-ordered copy: JAX arrays are read-only, and an array the pickle
    # kept in another layout (Fortran order survives pickle protocol 5)
    # would become a strided tensor, which the CUDA kernels refuse
    arr = np.array(tree, order="C")
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


def mlp_params_from_jax(tree, device="cpu", dtype=None):
    """The MLP of dvae_tpu/examples/fsdp_tutorial.py (``init_mlp``'s list
    of ``{"w": (fan_in, fan_out), "b": (fan_out,)}``, as numpy) → the same
    list of dicts of tensors."""
    return [_tree_to_torch(layer, device, dtype) for layer in tree]


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


# ---------------------------------------------------------------------------
# Tree utilities (dvae_tpu/utils/checkpoint.py:65-75, :178-201)
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _structure(tree):
    """Hashable description of a tree's nodes (not its leaves)."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if _is_namedtuple(tree):
        return (type(tree), tuple(_structure(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_structure(v) for v in tree))
    return None if tree is None else "leaf"


def _leaves_with_path(tree, path=""):
    """(path, leaf) pairs in JAX's order, paths spelled as
    ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_path(v, f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def abstract_like(tree):
    """The tree with every leaf replaced by a ``meta`` tensor of its shape
    and dtype (the port's ``jax.ShapeDtypeStruct``): a template that holds
    no bytes.  numpy leaves get the torch dtype of their numpy dtype."""

    def one(x):
        if isinstance(x, torch.Tensor):
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        a = np.asarray(x)
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        return torch.empty(a.shape, dtype=dtype, device="meta")

    return _tree_map(one, tree)


def compare_pytrees(a, b, rtol: float = 0.0, atol: float = 0.0) -> dict:
    """Structural and numerical comparison of two trees of tensors or
    arrays (reference ``compare_state_dicts``, mmidas/_utils.py:296-310):
    ``{'match', 'structure_equal', 'mismatched_paths'}``, a leaf mismatched
    when its shape differs or ``np.allclose`` fails."""
    if _structure(a) != _structure(b):
        return {"match": False, "structure_equal": False,
                "mismatched_paths": ["<tree structure differs>"]}
    bad = []
    for (path, x), (_, y) in zip(_leaves_with_path(a), _leaves_with_path(b)):
        x, y = _to_numpy(x), _to_numpy(y)
        if x.shape != y.shape or not np.allclose(x, y, rtol=rtol, atol=atol):
            bad.append(path)
    return {"match": not bad, "structure_equal": True,
            "mismatched_paths": bad}
