"""The mesh of a multi-device run and the six sharding strategies.

Counterpart of dvae_tpu/parallel/sharding.py.  The JAX package lays one
logical mesh ``('data', 'arm', 'fsdp')`` over its devices and lets the XLA
partitioner place arrays and insert collectives.  The port runs one
process per device (``parallel/runtime.py``) and does both by hand; this
docstring is the model of such a run.

Ranks and the mesh.  The world size equals ``MeshConfig.n_devices``; any
other world is a ``ValueError`` naming the flags that set it.  Rank r has
the mesh coordinates (d, a, f) of the JAX package's row-major reshape
(dvae_tpu/parallel/sharding.py:56-72): ``r = (d·arm + a)·fsdp + f``.
``make_mesh`` creates the process groups explicitly, in one fixed order
on every rank: the arm groups (ranks that share d and f), the batch
groups, data × fsdp flattened (ranks that share a), the fsdp groups and
the data groups.  ``Mesh.groups`` holds this rank's four.

Placement.  ``param_shardings``, ``opt_state_shardings`` (``offload_host``
included), ``batch_sharding`` and ``bn_shardings`` return the JAX package's
partition specs as tuples, leaf for leaf: ``("arm", "fsdp", None)`` is the
JAX ``P("arm", "fsdp", None)``.  From a spec each rank keeps only its block
of a leaf (``place``); ``gather_tree`` rebuilds the whole leaf and
``reshard`` moves a block between two specs.  The strategies:

  | strategy              | params        | gradients          | Adam moments |
  |-----------------------|---------------|--------------------|--------------|
  | no / ddp              | replicated    | all-reduced over   | replicated   |
  |                       |               | the batch group    |              |
  | full / hybrid (ZeRO-3)| fsdp-sharded  | reduce-scattered   | on the shard |
  |                       |               | over fsdp, all-    |              |
  |                       |               | reduced over data  |              |
  | grad-op / hybrid-zero2| replicated    | reduce-scattered   | sharded; the |
  |  (ZeRO-2)             |               |                    | updates all- |
  |                       |               |                    | gathered     |

"Replicated" is over fsdp: the leading arm axis of every parameter shards
over ``arm`` under every strategy, where it divides.  ``full`` and
``hybrid`` place identically (as in the JAX package, where only the
devices the fsdp axis spans tell them apart) and share one code path, as
do ``grad-op`` and ``hybrid-zero2``.  A step computes on the parameters of
its arms gathered over fsdp.  Under the four ZeRO strategies the
gradients are reduce-scattered over fsdp, each rank keeping the block its
moments hold, and then all-reduced over data (``train/step._sync_grads``);
under ``no``/``ddp`` they are all-reduced over the batch group.  fc1's
and fc11's gradients are the exception: the partitioned kernels sum them
over the batch group, and each rank then keeps its moments' block.  The
JAX package's ``constrain`` has no counterpart: the local tensors are
explicit.

Data.  As in the JAX package every rank holds the whole dataset and draws
the same permutation from the same generator; each rank takes the
contiguous rows of each batch of its batch-shard index i = d·fsdp + f,
rows [i·B/n, (i+1)·B/n) with n = data·fsdp.  An axis that does not divide
its dimension is dropped (dvae_tpu/train/step.py:162-181): arm ∤ A or
data·fsdp ∤ B.  Every rank of a dropped axis then computes the whole
dimension, as the JAX partitioner replicates it, and the axis reduces
nothing.

Noise.  Every draw but the fused encoder's in-kernel mask is drawn whole,
(A, B, ·), from the generator every rank shares, and sliced: the
reparameterisation noise, the state dropout, the input dropout of the
plain path and the Gumbel uniforms off the fused sampler.  With
``x_drop = 0`` a sharded step then equals the one-process step.  The
partitioned encoder offsets its seed as dvae_tpu/ops/partitioned.py:43 and
:215-217 do: ``seed + off·_SEED_STRIDE`` with int32 wrap-around, ``off``
flattened over (arm, data, fsdp), in that order, which is not the rank
order (``Spmd.seed_offset``); forward and backward use the same offset.

Collectives inside the loss.  Batch norm over a sharded batch is global
(dvae_tpu/models/mixvae.py:153-165): the forward all-reduces the per-
feature sum and then the sum of squared deviations over the batch group,
the backward all-reduces Σ gy and Σ gy·x̂, and the running statistics are
the same on every rank.  Under ``local_bn_stats`` a rank's group count is
``bn_groups / (data·fsdp)`` and the normalisation has no collective; the
step averages the running statistics over the batch group once, so that
they stay those of the JAX package's mean over the groups.  Terms that
need every row or every arm (the coupling distance, the entropies, the
L2 term; the Gumbel kernels under ``use_pallas``) are computed on all-
gathered tensors, as the JAX partitioner replicates what it cannot split,
and the gather's backward keeps the local block, so each such term
reaches the parameters once.

Eval: a trailing batch that the batch axes cannot divide is evaluated
whole on every rank, through the same kernels (the batch axes dropped,
the arms still sharded), as a train step on such a batch is.  The JAX
package takes the materialising path there (dvae_tpu/train/step.py
:496-520) because its partitioning rule cannot split the batch; the
port's ops run on whatever rows a rank holds.  The eval outputs are
gathered, so ``eval_model`` returns the whole arrays on every rank.  A
checkpoint is written by rank 0 from gathered leaves, in the one-device
format.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dvae_tpu_torch.config import MeshConfig, ShardingStrategy
from dvae_tpu_torch.parallel.runtime import (Group, all_gather, process_info,
                                             world_group)

AXES = ("data", "arm", "fsdp")
BATCH_AXES = ("data", "fsdp")  # every device computes a distinct micro-batch

# the process-group families, in the order every rank creates them
_FAMILIES = (("arm",), ("data", "fsdp"), ("fsdp",), ("data",))


class HostSpec(tuple):
    """A partition spec whose leaf lives in pinned host memory (the JAX
    ``memory_kind='pinned_host'``); equal to the plain spec tuple."""

    memory_kind = "pinned_host"


@dataclass
class Mesh:
    """One rank's view of the (data, arm, fsdp) mesh: its coordinates and
    its process groups (``groups`` is empty for a layout without a world,
    which serves the spec functions and ``place``)."""

    cfg: MeshConfig
    rank: int = 0
    groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return {"data": self.cfg.data, "arm": self.cfg.arm,
                "fsdp": self.cfg.fsdp}

    @property
    def coords(self) -> dict:
        return _coords(self.rank, self.cfg)

    def axis_size(self, axes) -> int:
        n = 1
        for ax in _axes(axes):
            n *= self.shape[ax]
        return n

    def axis_index(self, axes) -> int:
        """Row-major index of this rank over ``axes`` in the given order
        (the JAX ``_shard_offset``, dvae_tpu/ops/partitioned.py:55-60)."""
        off, c = 0, self.coords
        for ax in _axes(axes):
            off = off * self.shape[ax] + c[ax]
        return off

    def group(self, axes) -> Optional[Group]:
        """The group of ranks that differ from this one only along
        ``axes``; None for no axes or a size-1 span."""
        axes = tuple(ax for ax in _axes(axes) if self.shape[ax] > 1)
        if not axes:
            return None
        key = frozenset(axes)
        for fam in _FAMILIES:
            if frozenset(ax for ax in fam if self.shape[ax] > 1) == key:
                g = self.groups.get(fam)
                if g is None:
                    raise RuntimeError(f"mesh {self.cfg} has no process "
                                       f"group for {axes}: it was built "
                                       "without a world")
                return g
        raise ValueError(f"no process group spans {axes}")

    @property
    def world(self) -> Optional[Group]:
        """Every rank of the mesh (None for one device or a layout)."""
        return self.groups.get("world")

    @property
    def arm_group(self) -> Optional[Group]:
        return self.group(("arm",))

    @property
    def batch_group(self) -> Optional[Group]:
        return self.group(BATCH_AXES)

    @property
    def fsdp_group(self) -> Optional[Group]:
        return self.group(("fsdp",))

    @property
    def data_group(self) -> Optional[Group]:
        return self.group(("data",))

    @property
    def batch_index(self) -> int:
        """This rank's batch-shard index d·fsdp + f."""
        return self.axis_index(BATCH_AXES)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _coords(rank: int, cfg: MeshConfig) -> dict:
    d, rest = divmod(rank, cfg.arm * cfg.fsdp)
    a, f = divmod(rest, cfg.fsdp)
    return {"data": d, "arm": a, "fsdp": f}


def _family_members(cfg: MeshConfig, fam) -> list:
    """The groups of one family: lists of ranks that agree on every axis
    outside ``fam``, ordered by their first rank."""
    by_key: dict = {}
    for r in range(cfg.n_devices):
        c = _coords(r, cfg)
        key = tuple(c[ax] for ax in AXES if ax not in fam)
        by_key.setdefault(key, []).append(r)
    return sorted(by_key.values())


def mesh_layout(cfg: MeshConfig, rank: int = 0) -> Mesh:
    """The mesh geometry of ``rank`` without process groups: enough for
    the spec functions, ``place`` and ``Spmd.seed_offset``."""
    return Mesh(cfg, rank)


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """This rank's mesh over the world it has joined (one process per
    device; ``parallel.runtime.initialize_distributed``).

    With ``cfg=None`` every process sits on the ``data`` axis.  The world
    size must equal ``data × arm × fsdp``.  Every rank creates every
    process group of every family in the same order (a collective), and
    keeps its own."""
    rank, world = process_info()
    cfg = cfg or MeshConfig(data=world)
    n = cfg.n_devices
    if n != world:
        raise ValueError(
            f"mesh {cfg} needs {n} processes, one per device, and the "
            f"world has {world}: start {n} processes with --num_processes "
            f"{n} --coordinator host:port --process_id r, or set "
            "--mesh_data/--mesh_arm/--mesh_fsdp to multiply to "
            f"{world}")
    return _mesh_over(cfg, prefix_group(n))


def _mesh_over(cfg: MeshConfig, group: Optional[Group]) -> Optional[Mesh]:
    """The mesh ``cfg`` over ``group``, the world's first ranks (None on a
    rank outside it).  Every rank of the world creates every group of
    every family, in ``_FAMILIES``' order, and keeps its own."""
    rank = process_info()[0]
    mesh = Mesh(cfg, rank) if group is not None else None
    if cfg.n_devices == 1:
        return mesh
    if mesh is not None:
        mesh.groups["world"] = group
    for fam in _FAMILIES:
        if _span(cfg, fam) == 1:
            continue  # every group of the family has one rank
        for ranks in _family_members(cfg, fam):
            pg = dist.new_group(ranks)
            if mesh is not None and rank in ranks:
                mesh.groups[fam] = Group(tuple(ranks), ranks.index(rank), pg)
    return mesh


def _span(cfg: MeshConfig, fam) -> int:
    return int(np.prod([getattr(cfg, ax) for ax in fam]))


_PREFIX_GROUPS: dict = {}


def prefix_group(n: Optional[int]) -> Optional[Group]:
    """The group of the world's first ``n`` ranks (None: the whole world),
    or None on a rank outside it.  A count above the world size is a
    ``ValueError`` naming it.  Every rank of the world must call, in the
    same order (a group's creation is collective); the groups are kept,
    one for each count."""
    rank, world = process_info()
    n = world if n is None else int(n)
    if not 1 <= n <= world:
        raise ValueError(
            f"{n} devices asked for in a world of {world} process(es), one "
            f"per device: start {n} processes with --num_processes {n} "
            "--coordinator host:port --process_id r "
            "(parallel.runtime.initialize_distributed)")
    if n == world:
        return world_group() or Group((0,), 0)
    if n == 1:
        return Group((0,), 0) if rank == 0 else None
    key = (n, id(dist.distributed_c10d._get_default_group()))
    if key not in _PREFIX_GROUPS:
        _PREFIX_GROUPS[key] = dist.new_group(list(range(n)))
    return (Group(tuple(range(n)), rank, _PREFIX_GROUPS[key]) if rank < n
            else None)


@dataclass(frozen=True)
class DPMesh:
    """A 1-D data-parallel mesh ``("dp",)`` over a group of ranks (the JAX
    package's ``Mesh(devices[:n], ("dp",))``), with the axis interface of
    ``Mesh`` that ``local_block``, ``full_leaf`` and ``reshard`` use."""

    dp: Group

    @property
    def size(self) -> int:
        return self.dp.size

    def axis_size(self, axes) -> int:
        return self.size if "dp" in _axes(axes) else 1

    def axis_index(self, axes) -> int:
        return self.dp.index if "dp" in _axes(axes) else 0

    def group(self, axes) -> Optional[Group]:
        return self.dp if "dp" in _axes(axes) and self.size > 1 else None


def make_dp_mesh(n_devices: Optional[int] = None) -> Optional[DPMesh]:
    """The ``dp`` mesh of the world's first ``n_devices`` ranks (None: the
    whole world, one device outside a world); None on the ranks outside
    it, which take no part.  Every rank of the world must call."""
    group = prefix_group(n_devices)
    return None if group is None else DPMesh(group)


def make_submesh(cfg: MeshConfig) -> Optional[Mesh]:
    """``make_mesh`` over the world's first ``cfg.n_devices`` ranks; None
    on the others.  Every rank of the world must call."""
    return _mesh_over(cfg, prefix_group(cfg.n_devices))


# ---------------------------------------------------------------------------
# Partition specs (dvae_tpu/parallel/sharding.py:75-221)
# ---------------------------------------------------------------------------

def _leaf_pspec(shape, mesh: Mesh, shard_fsdp: bool, shard_arm: bool):
    """Spec of one stacked-arm leaf of shape (A, ...): the leading A axis
    over ``arm`` where it divides; under an fsdp strategy the largest
    other dimension that the fsdp axis divides over ``fsdp``."""
    arm_size, fsdp_size = mesh.shape["arm"], mesh.shape["fsdp"]
    spec = [None] * len(shape)
    if shard_arm and arm_size > 1 and shape[0] % arm_size == 0:
        spec[0] = "arm"
    if shard_fsdp and fsdp_size > 1 and len(shape) > 1:
        cands = [(shape[i], i) for i in range(1, len(shape))
                 if shape[i] % fsdp_size == 0]
        if cands:
            _, i = max(cands)
            spec[i] = "fsdp"
    return tuple(spec)


def _is_leaf(x) -> bool:
    return not isinstance(x, (dict, list, tuple)) or isinstance(x, HostSpec)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists, tuples and
    named tuples; None stays None), with the matching nodes of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, HostSpec):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def param_shardings(params, mesh: Mesh, strategy: ShardingStrategy):
    """Spec tree of the stacked-arm parameters."""
    shard_fsdp = ShardingStrategy(strategy) in (
        ShardingStrategy.FULL_SHARD, ShardingStrategy.HYBRID_SHARD)
    return tree_map(lambda p: _leaf_pspec(_shape(p), mesh, shard_fsdp,
                                          shard_arm=True), params)


def opt_state_shardings(opt_state, mesh: Mesh, strategy: ShardingStrategy,
                        offload_host: bool = False):
    """Spec tree of the Adam state: the moments follow the parameter rule
    with fsdp under the ZeRO strategies (both ZeRO-2 ones included), and
    are replicated, arms too, under ``no``/``ddp``; the step count is
    replicated.  ``offload_host`` marks every leaf ``HostSpec``: the
    moments then live in pinned host memory and each update stages them
    through the device."""
    shard_opt = ShardingStrategy(strategy) in (
        ShardingStrategy.FULL_SHARD, ShardingStrategy.HYBRID_SHARD,
        ShardingStrategy.SHARD_GRAD_OP, ShardingStrategy.HYBRID_SHARD_ZERO2)
    wrap = HostSpec if offload_host else tuple

    def rule(leaf):
        shape = _shape(leaf)
        if not shape or not shard_opt:
            return wrap(())
        return wrap(_leaf_pspec(shape, mesh, shard_fsdp=True,
                                shard_arm=True))

    return tree_map(rule, opt_state)


def batch_sharding(mesh: Mesh, batch_axis: int = 1, ndim: int = 3,
                   arm_axis: Optional[int] = 0) -> tuple:
    """Spec of an (A, B, D) input batch: arms over ``arm``, rows over
    data × fsdp."""
    spec = [None] * ndim
    if arm_axis is not None and mesh.shape["arm"] > 1:
        spec[arm_axis] = "arm"
    spec[batch_axis] = BATCH_AXES
    return tuple(spec)


def replicated(mesh: Mesh) -> tuple:
    del mesh
    return ()


def bn_shardings(bn_state, mesh: Mesh):
    """Batch-norm running statistics: over ``arm`` only."""
    return tree_map(lambda s: _leaf_pspec(_shape(s), mesh, shard_fsdp=False,
                                          shard_arm=True), bn_state)


def strategy_shardings(strategy: ShardingStrategy, mesh: Mesh, params,
                       bn_state, opt_state):
    """(param specs, bn specs, opt-state specs) of a strategy."""
    return (param_shardings(params, mesh, strategy),
            bn_shardings(bn_state, mesh),
            opt_state_shardings(opt_state, mesh, strategy))


def compute_spec(spec) -> tuple:
    """The spec a step computes a parameter in: ``spec`` gathered over
    fsdp (this rank's arms, every other dimension whole)."""
    return tuple(None if e == "fsdp" else e for e in spec)


# ---------------------------------------------------------------------------
# Blocks of a leaf
# ---------------------------------------------------------------------------

def local_block(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``spec`` (a view).
    A dimension of size 1 is a broadcast and stays whole (no spec shards
    one: the axis would not divide it)."""
    for i, entry in enumerate(spec):
        n = mesh.axis_size(entry)
        if n > 1 and t.shape[i] > 1:
            k = t.shape[i] // n
            t = t.narrow(i, mesh.axis_index(entry) * k, k)
    return t


def full_leaf(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from this rank's block under ``spec`` (gathers over
    the spec's axes; every rank of those groups must call)."""
    for i, entry in enumerate(spec):
        if mesh.axis_size(entry) > 1:
            t = _gather_leaf(t, mesh.group(entry), i)
    return t


def _gather_leaf(t, group, dim):
    """``all_gather`` of a leaf that may live on the host (offloaded
    moments): staged through the device the mesh communicates on."""
    dev = t.device
    if dev.type == "cpu" and torch.cuda.is_available() and _nccl(group):
        out = all_gather(t.cuda(), group, dim)
        return out.to(dev)
    return all_gather(t, group, dim)


def _nccl(group) -> bool:
    return (group is not None and group.pg is not None
            and dist.get_backend(group.pg) == "nccl")


def reshard(t: torch.Tensor, src, dst, mesh: Mesh) -> torch.Tensor:
    """Move a leaf's block from spec ``src`` to spec ``dst``: a dimension
    that ``dst`` shards and ``src`` does not is sliced, one that ``src``
    shards and ``dst`` does not is all-gathered."""
    pad = (None,) * t.dim()
    for i, (s, d) in enumerate(zip(tuple(src) + pad, tuple(dst) + pad)):
        if i >= t.dim():
            break
        if s == d:
            continue
        if s is not None and mesh.axis_size(s) > 1:
            t = _gather_leaf(t, mesh.group(s), i)
        if d is not None and mesh.axis_size(d) > 1:
            k = t.shape[i] // mesh.axis_size(d)
            t = t.narrow(i, mesh.axis_index(d) * k, k)
    return t


def place(tree, specs, mesh: Mesh):
    """Every leaf of a whole tree cut to this rank's block (its own copy,
    so the whole leaf is freed); a ``HostSpec`` leaf goes to (pinned) host
    memory.  Leaves without a shape (the Adam step count) pass through."""
    def cut(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        out = local_block(t, spec, mesh).contiguous().clone()
        if isinstance(spec, HostSpec):
            out = out.cpu()
            if torch.cuda.is_available():
                out = out.pin_memory()
        return out
    return tree_map(cut, tree, specs)


def gather_tree(tree, specs, mesh: Mesh):
    """The whole tree from this rank's blocks (every rank must call)."""
    return tree_map(lambda t, s: full_leaf(t, s, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, specs)


def put_dataset(x, dtype=None, device="cpu") -> torch.Tensor:
    """A dataset on ``device``, cast on the host first and contiguous (the
    JAX package's row-major host cast, sharding.py:131-156; every rank
    holds all of it)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))
    if dtype is not None:
        t = t.to(dtype)
    return t.contiguous().to(device)


# ---------------------------------------------------------------------------
# One step's shards
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Spmd:
    """What one step computes on this rank: the arms and the rows of an
    (A, B) problem it owns, and the groups that share its arms' rows
    (``batch_group``) and its rows' arms (``arm_group``).  An axis the
    step dropped (``arm_axes`` or ``batch_axes`` empty) has no group: this
    rank computes that whole dimension."""

    mesh: Mesh
    arm_axes: tuple
    batch_axes: tuple
    n_arm: int
    n_rows: int

    @property
    def arm_group(self) -> Optional[Group]:
        return self.mesh.group(self.arm_axes) if self.arm_axes else None

    @property
    def batch_group(self) -> Optional[Group]:
        return self.mesh.group(self.batch_axes) if self.batch_axes else None

    @property
    def arms(self) -> slice:
        n = self.mesh.axis_size(self.arm_axes)
        k = self.n_arm // n
        i = self.mesh.axis_index(self.arm_axes)
        return slice(i * k, i * k + k)

    @property
    def rows(self) -> slice:
        n = self.mesh.axis_size(self.batch_axes)
        k = self.n_rows // n
        i = self.mesh.axis_index(self.batch_axes)
        return slice(i * k, i * k + k)

    @property
    def seed_offset(self) -> int:
        """The partitioned encoder's shard index, flattened over (arm,
        data, fsdp) as dvae_tpu/ops/partitioned.py:215-217 does."""
        return self.mesh.axis_index(self.arm_axes + self.batch_axes)

    def local(self, t: Optional[torch.Tensor]):
        """This rank's (arms, rows) block of a whole (A, B, ...) tensor, a
        contiguous copy (kernels read it)."""
        if t is None:
            return None
        return t[self.arms, self.rows].contiguous()

    def local_rows(self, t: Optional[torch.Tensor]):
        """This rank's rows of a whole (B, ...) tensor."""
        return None if t is None else t[self.rows]


# ---------------------------------------------------------------------------
# The training state's specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StateSpecs:
    """The spec trees of a training state under one strategy: the stored
    parameters, the parameters as a step computes on them (gathered over
    fsdp), the Adam moments (one tree, for mu and for nu) and the running
    statistics."""

    params: dict
    compute: dict
    moments: dict
    bn: dict


def state_specs(cfg, strategy, mesh: Mesh,
                offload_host: bool = False) -> StateSpecs:
    """``StateSpecs`` of the model ``cfg`` (shapes only; no tensor)."""
    from dvae_tpu_torch.models.mixvae import _arm_shapes
    A, F, L = cfg.n_arm, cfg.fc_dim, cfg.lowD_dim

    def meta(*shape):
        return torch.empty(shape, device="meta")
    shapes = {name: {"w": meta(A, fi, fo), "b": meta(A, fo)}
              for name, (fi, fo) in _arm_shapes(cfg).items()}
    bn = {name: {"mean": meta(A, d), "var": meta(A, d)}
          for name, d in (("bn1", F), ("bn2", F), ("bn3", F), ("bn4", F),
                          ("bn5", L))}
    p = param_shardings(shapes, mesh, strategy)
    return StateSpecs(
        params=p, compute={n: {k: compute_spec(v) for k, v in layer.items()}
                           for n, layer in p.items()},
        moments=opt_state_shardings(shapes, mesh, strategy, offload_host),
        bn=bn_shardings(bn, mesh))


def place_state(state, specs: StateSpecs, mesh: Mesh):
    """A whole training state (``train.step.TrainState``) cut to this
    rank's blocks."""
    opt = state.opt_state
    if opt is not None:
        opt = opt._replace(mu=place(opt.mu, specs.moments, mesh),
                           nu=place(opt.nu, specs.moments, mesh))
    return state._replace(params=place(state.params, specs.params, mesh),
                          bn=place(state.bn, specs.bn, mesh), opt_state=opt)


def gather_state(state, specs: StateSpecs, mesh: Mesh):
    """The whole training state from this rank's blocks (every rank must
    call)."""
    opt = state.opt_state
    if opt is not None:
        opt = opt._replace(mu=gather_tree(opt.mu, specs.moments, mesh),
                           nu=gather_tree(opt.nu, specs.moments, mesh))
    return state._replace(params=gather_tree(state.params, specs.params, mesh),
                          bn=gather_tree(state.bn, specs.bn, mesh),
                          opt_state=opt)
