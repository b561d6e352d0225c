"""The multi-process runtime of the PyTorch port: one process per device.

Counterpart of dvae_tpu/parallel/runtime.py.  Where the JAX package runs
one process per host and addresses the host's devices through its mesh,
the port runs one process per device, joined by ``torch.distributed``:

  * ``initialize_distributed`` is the rendezvous (``tcp://host:port``, the
    world size and this process's rank, given explicitly; a no-op for one
    process, as in the JAX package).  The backend is NCCL for CUDA and
    gloo for the CPU unless ``backend=`` names one; NCCL refuses two ranks
    on one device, and so does this function, with a message that says
    so, instead of switching backends behind the caller's back.
  * ``process_info``, ``global_batch`` and ``local_slice`` as in the JAX
    package.
  * The collectives the port uses: all-reduce (a sum), all-gather into
    one tensor, reduce-scatter and broadcast, the same calls on every
    backend; all-reduce and reduce-scatter also take several tensors in
    one collective (``flat_all_reduce``, ``flat_reduce_scatter``).
    ``scripts/gloo_cuda_probe.py`` found that gloo (torch 2.11, on an
    NVIDIA H100) takes CUDA tensors for each of them in f32, bf16, int64,
    int32 and uint8, so one code path serves NCCL on several cards, gloo
    on the CPU and gloo with several ranks on one card.

``record_collectives`` is the port's counterpart of the optimised HLO
module that the JAX package's census parses: while it is open, every
collective this process issues through these functions appends one
``CollectiveRecord`` (its kind under XLA's name, dtype, local payload
bytes and group size).  A group of one rank records nothing (the no-op
path), and a closed recorder costs one test of a list and never a
synchronising call.

A ``Group`` is a process group and the ranks in it.  A group of one rank
(an axis of size 1, or an axis the step does not shard) makes every
collective a no-op, so callers never branch on the mesh.

Two collectives have autograd forms for values that every rank of the
group then uses the same way (a replicated computation):
``gather_for_replicated`` keeps only the local block of the incoming
gradient and ``sum_for_replicated`` passes it through; either way a term
computed identically on every rank reaches each rank's parameters once.
"""

from __future__ import annotations

import contextlib
import datetime
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """A process group: its global ranks (ascending) and this process's
    place among them.  ``pg`` is None for a group of one rank."""

    ranks: tuple
    index: int
    pg: object = None

    @property
    def size(self) -> int:
        return len(self.ranks)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None, device=None,
                           timeout_s: float = 600.0) -> None:
    """Join the world of ``num_processes`` processes as rank
    ``process_id`` through ``coordinator_address`` (``host:port`` or a
    ``tcp://`` URL).  A no-op for one process or when this process has
    joined already (with the same world size; another one raises).

    ``backend``: ``"nccl"`` or ``"gloo"``; by default NCCL when ``device``
    (default: CUDA where a card is present) is CUDA, else gloo.  NCCL needs
    one device a rank: more ranks than cards is a ``ValueError`` (pass
    ``backend="gloo"`` to put several ranks on one card)."""
    if num_processes is None or num_processes <= 1:
        return
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise ValueError(f"this process is in a world of "
                             f"{dist.get_world_size()}, not {num_processes}")
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("--num_processes N needs --coordinator host:port "
                         "and --process_id r (0 <= r < N)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is outside "
                         f"[0, {num_processes})")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        n_cards = torch.cuda.device_count()
        if num_processes > n_cards:
            raise ValueError(
                f"NCCL needs one device a rank: {num_processes} ranks on "
                f"{n_cards} device(s) would put two ranks on one device, "
                "which NCCL refuses; pass backend='gloo' to run several "
                "ranks on one card")
        torch.cuda.set_device(process_id % n_cards)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the world (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(device) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    ``cuda:(rank mod cards)``; anything else is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        rank, _ = process_info()
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def local_slice(n_global: int, batch_axis_size: int) -> slice:
    """This process's contiguous row range of a globally indexed dataset
    (dvae_tpu/parallel/runtime.py:57-73): ``n_global`` must divide evenly
    over the processes and over the ``batch_axis_size`` devices of the
    batch axis.  Raises instead of silently dropping tail rows."""
    rank, procs = process_info()
    if n_global % procs:
        raise ValueError(
            f"n_global={n_global} rows do not divide evenly over "
            f"{procs} processes — the tail would silently never be seen; "
            "pad (e.g. by wrapping) or trim the dataset first")
    if batch_axis_size and n_global % batch_axis_size:
        raise ValueError(
            f"n_global={n_global} rows do not divide evenly over the "
            f"{batch_axis_size}-device batch axis")
    per = n_global // procs
    return slice(rank * per, rank * per + per)


def global_batch(local_data, group: Optional[Group] = None) -> torch.Tensor:
    """This process's rows of a batch laid over ``group`` (the mesh's batch
    group), as a tensor: the counterpart of JAX's global array, whose
    local shard is all a process computes on here.  Every process of the
    group must hold a batch of the same shape; another shape is a
    ``ValueError`` on every rank."""
    t = torch.as_tensor(local_data)
    if t.dim() == 0:
        raise ValueError("a batch needs a row axis")
    if group is not None and group.size > 1:
        shape = torch.tensor([t.dim(), *t.shape, *([0] * (8 - t.dim()))],
                             dtype=torch.int64, device=t.device)
        shapes = all_gather(shape[None], group).cpu()
        if not bool((shapes == shapes[0]).all()):
            raise ValueError(f"the processes of the batch group hold "
                             f"batches of different shapes: "
                             f"{shapes.tolist()}")
    return t


# ---------------------------------------------------------------------------
# The collective recorder
# ---------------------------------------------------------------------------

class CollectiveRecord(NamedTuple):
    """One collective as the census counts it: ``kind`` is XLA's name
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``broadcast``),
    ``nbytes`` the payload of the ring model (the all-reduced tensor, the
    gathered result, the reduce-scatter's whole input, the broadcast
    tensor), ``group_size`` the ranks it spans.  ``kind == "step"`` is a
    mark the epoch runner leaves after each train step (no payload)."""

    kind: str
    dtype: str
    nbytes: int
    group_size: int


_RECORDERS: list = []


@contextlib.contextmanager
def record_collectives():
    """A list that, while the block runs, receives one ``CollectiveRecord``
    for each collective this process issues through this module."""
    rec: list = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _record(kind: str, t: torch.Tensor, group: Group) -> None:
    """Record a collective whose ring-model payload is the whole of ``t``."""
    if _RECORDERS:
        r = CollectiveRecord(kind, str(t.dtype).replace("torch.", ""),
                             t.numel() * t.element_size(), group.size)
        for rec in _RECORDERS:
            rec.append(r)


def record_mark(kind: str = "step") -> None:
    """Leave a mark (a record without payload) in every open recorder."""
    if _RECORDERS:
        for rec in _RECORDERS:
            rec.append(CollectiveRecord(kind, "", 0, 0))


# ---------------------------------------------------------------------------
# Collectives: the same calls on every backend (gloo takes CUDA tensors in
# all of them)
# ---------------------------------------------------------------------------


def _single(group: Optional[Group]) -> bool:
    return group is None or group.size == 1


def all_reduce(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """The sum of ``t`` over the group, a new tensor (``t`` itself for a
    group of one).  Every rank receives the same bits."""
    if _single(group):
        return t
    out = t.detach().contiguous().clone()
    _record("all-reduce", out, group)
    dist.all_reduce(out, group=group.pg)
    return out


def all_gather(t: torch.Tensor, group: Optional[Group],
               dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``t`` concatenated along ``dim`` in rank
    order, contiguous (the kernels take no other); every rank's block must
    have ``t``'s shape."""
    if _single(group):
        return t
    src = t.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] * group.size,) + src.shape[1:])
    _record("all-gather", out, group)
    dist.all_gather_into_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


def broadcast(t: torch.Tensor, src_index: int,
              group: Optional[Group]) -> torch.Tensor:
    """``t`` of the group's rank ``src_index`` on every rank (in place)."""
    if _single(group):
        return t
    t = t.contiguous()
    _record("broadcast", t, group)
    dist.broadcast(t, src=group.ranks[src_index], group=group.pg)
    return t


def barrier(group: Optional[Group], device) -> None:
    """Wait for every rank of the group (an all-reduce of one number, so
    that it works on every backend and device)."""
    all_reduce(torch.zeros(1, device=device), group)


def broadcast_string(s: Optional[str], group: Optional[Group], device,
                     src_index: int = 0, max_bytes: int = 4096) -> str:
    """The string of the group's rank ``src_index`` on every rank."""
    if _single(group):
        return s
    buf = torch.zeros(max_bytes + 1, dtype=torch.int32, device=device)
    if group.index == src_index:
        raw = (s or "").encode()
        if len(raw) > max_bytes:
            raise ValueError(f"string of {len(raw)} bytes exceeds {max_bytes}")
        buf[0] = len(raw)
        buf[1:1 + len(raw)] = torch.tensor(list(raw), dtype=torch.int32)
    buf = broadcast(buf, src_index, group).cpu()
    n = int(buf[0])
    return bytes(buf[1:1 + n].to(torch.uint8).tolist()).decode()


def flat_all_reduce(tensors: Sequence[torch.Tensor],
                    group: Optional[Group]) -> list:
    """``all_reduce`` of several tensors of one dtype and device in one
    collective (one flat buffer); returns new tensors, ``tensors`` for a
    group of one."""
    if _single(group) or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _record("all-reduce", flat, group)
    dist.all_reduce(flat, group=group.pg)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def flat_reduce_scatter(tensors: Sequence[torch.Tensor], dims: Sequence[int],
                        group: Optional[Group]) -> list:
    """This rank's blocks of the group's sums of several tensors of one
    dtype and device, in one collective: tensor i is cut along ``dims[i]``
    into as many blocks as the group has ranks, in rank order.  Returns
    new contiguous tensors, ``tensors`` for a group of one."""
    if _single(group) or not tensors:
        return list(tensors)
    n = group.size
    rows = [t.movedim(d, 0).reshape(n, -1) for t, d in zip(tensors, dims)]
    flat = torch.cat(rows, dim=1)  # (n, Σ block sizes): row j is block j
    mine = flat.new_empty(flat.shape[1])
    _record("reduce-scatter", flat, group)
    dist.reduce_scatter_tensor(mine, flat.reshape(-1), group=group.pg)
    out, i = [], 0
    for t, d, r in zip(tensors, dims, rows):
        shape = list(t.movedim(d, 0).shape)
        shape[0] //= n
        out.append(mine[i:i + r.shape[1]].view(shape).movedim(0, d)
                   .contiguous())
        i += r.shape[1]
    return out


# ---------------------------------------------------------------------------
# Autograd forms for replicated consumers
# ---------------------------------------------------------------------------

class _GatherForReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.k = group, dim, t.shape[dim]
        return all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.narrow(ctx.dim, ctx.group.index * ctx.k, ctx.k)
        return g.contiguous(), None, None


class _SumForReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_for_replicated(t: torch.Tensor, group: Optional[Group],
                          dim: int = 0) -> torch.Tensor:
    """``all_gather`` whose backward keeps this rank's block of the
    gradient: right when every rank of the group computes the same
    function of the gathered tensor, so that the term reaches each block
    once, through its owner."""
    if _single(group):
        return t
    return _GatherForReplicated.apply(t, group, dim)


def sum_for_replicated(t: torch.Tensor,
                       group: Optional[Group]) -> torch.Tensor:
    """``all_reduce`` whose backward passes the gradient through: right
    when every rank of the group computes the same function of the sum, so
    that each rank's partial sum gets the sum's gradient once."""
    if _single(group):
        return t
    return _SumForReplicated.apply(t, group)


def world_group() -> Optional[Group]:
    """Every process of the world (None outside one)."""
    rank, world = process_info()
    if world == 1:
        return None
    return Group(tuple(range(world)), rank, dist.group.WORLD)
