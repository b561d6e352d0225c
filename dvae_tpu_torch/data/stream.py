"""Host→device streaming of the PyTorch port, for datasets larger than the
card's memory.

Counterpart of dvae_tpu/data/stream.py: ``StreamBatch``, ``StreamStats``,
``BatchStreamer`` (:81), ``feed_census`` (:251) and
``make_streaming_runner`` (:322).  The resident epoch runner
(``train/step.make_epoch_runner``) keeps the whole dataset on the device;
here the dataset stays on the host and each batch is gathered there and
copied to the card while the card computes the steps before it.

Semantics are the JAX module's:
  * dense input, or a scipy sparse matrix converted to CSR once (each
    batch densifies only its (B, D) rows);
  * a cast to the storage dtype on the host, so the link carries the
    storage dtype (bf16: half the bytes); the cast is torch's, which
    rounds to nearest even as ml_dtypes does;
  * ref-prior rows gathered with the batch rows;
  * ``drop_last`` batching, and a ``ValueError`` when ``batch_size``
    exceeds N;
  * the batch plan of epoch ``e`` is ``np.random.default_rng((seed,
    e)).permutation(n)``, so both packages draw the same plan;
  * ``prefetch`` batches in flight beyond the current one, and
    ``stats.ahead`` recording that issue-ahead invariant.

On a CUDA device each batch is gathered into one of a ring of
``prefetch + 1`` pinned host slots and copied with ``.to(device,
non_blocking=True)`` on a dedicated copy stream; an event recorded after
the copy is what the compute stream waits on (``wait_event``, on the
device), and ``record_stream`` keeps the caching allocator from handing a
batch's memory to the next copy while a step still reads it.  A slot is
written again only after its copy's event has completed.  On the CPU the
streamer hands out plain tensors (the path the tests run).

The streaming runner is the resident runner's epoch loop
(``train/step.make_chunk_loop``: noise chain, steps, consensus) fed from
the streamer.  Its backpressure waits on the event of the step issued
``prefetch`` iterations earlier (never on a value read back), so at most
``prefetch + 1`` steps and their batches are queued on the device.  No
permutation is drawn from the chunk's generator (the plan is numpy's), so
a streamed run differs from a resident one in its batch plan and in the
stretch of the noise chain it draws: the two are statistically, not
bitwise, interchangeable, as in the JAX package.

On a mesh (dvae_tpu/data/stream.py:125-175) every rank holds the whole
host dataset, draws the same plan, and gathers on the host only its rows
of each batch (``_local_span``: the rows of its batch-shard index, when the
batch axes divide the batch; the whole batch where they do not, as the
step then computes it whole).  A world of several processes without a
mesh is a ``ValueError``, as is a batch the batch axes cannot divide.
Under a frozen augmenter the streaming runner has every rank stream the
whole batch: the augmenter's draws are made whole, like the model's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from dvae_tpu_torch.parallel.runtime import process_info
from dvae_tpu_torch.train.step import make_chunk_loop
from dvae_tpu_torch.utils.host_ops import as_host_tensor, gather_rows


class StreamBatch(NamedTuple):
    x: torch.Tensor
    prior: Optional[torch.Tensor]


@dataclasses.dataclass
class StreamStats:
    """Per-batch instrumentation (``record_stats=True``).

    ``gather_s``: host time to gather, densify and cast one batch into its
    slot.  ``commit_s``: host time of the copy's enqueue (the DMA itself
    runs on the copy stream).  ``ahead``: batches issued and not yet
    handed out at each hand-out, the issue-ahead invariant.  ``waits``:
    host waits on an event (a slot's copy, the backpressure step) made
    before each hand-out and step, a wait counted only where the event had
    not completed."""

    gather_s: list = dataclasses.field(default_factory=list)
    commit_s: list = dataclasses.field(default_factory=list)
    ahead: list = dataclasses.field(default_factory=list)
    waits: list = dataclasses.field(default_factory=list)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or np.dtype(dtype).name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "float64": torch.float64}[name]


def _wait(event, stats) -> None:
    """Block the host on ``event`` where it has not completed; count it."""
    if event is not None and not event.query():
        event.synchronize()
        if stats is not None:
            stats.waits[-1] += 1


class BatchStreamer:
    """Shuffled, prefetching host→device batch stream.

    Args:
      x: (N, D) host matrix: numpy or a CPU tensor (best already in the
        storage dtype: a cast per batch doubles the host's work), or a
        scipy sparse matrix (CSR; another format is converted once).
      batch_size: rows a batch; ``drop_last`` semantics.
      prior: optional (N, C) ref-prior table streamed row-aligned with x.
      seed: shuffle seed; epoch ``e`` uses ``default_rng((seed, e))``.
      dtype: the batches' dtype (a torch or numpy dtype; None keeps x's).
      device: where batches land (``"cuda"`` by default).
      prefetch: batches in flight beyond the current one (at least 1).
      mesh: this rank's ``parallel.sharding.Mesh`` in a world of several
        processes: ``batch_size`` is the whole batch's, and each batch
        holds this rank's rows of it (``rows_local``).
      whole_batch: on a mesh, stream every rank the whole batch.
    """

    def __init__(self, x, batch_size: int, *,
                 prior: Optional[np.ndarray] = None, seed: int = 0,
                 shuffle: bool = True, dtype=None, device="cuda",
                 prefetch: int = 2, record_stats: bool = False, mesh=None,
                 whole_batch: bool = False):
        self.stats = StreamStats() if record_stats else None
        if batch_size > x.shape[0]:
            raise ValueError(
                f"batch_size {batch_size} > dataset size {x.shape[0]}")
        if process_info()[1] > 1 and mesh is None:
            raise ValueError(
                "multi-process streaming needs the mesh: every rank holds "
                "the whole dataset and streams its rows of each batch")
        self._span = None   # (start, rows) of this rank's rows of a batch
        n = 1 if mesh is None else mesh.axis_size(("data", "fsdp"))
        if n > 1 and not whole_batch:
            if batch_size % n:
                raise ValueError(
                    f"global batch_size {batch_size} must divide evenly "
                    f"over the {n}-device row axis")
            k = batch_size // n
            self._span = (mesh.batch_index * k, k)
        if hasattr(x, "tocsr"):
            x = x.tocsr()  # row gathers on CSC/COO are pathological
            src_dtype = _torch_dtype(x.dtype)
        else:
            x = as_host_tensor(x)
            src_dtype = x.dtype
        self.x = x
        self.dtype = _torch_dtype(dtype) or src_dtype
        self.prior = None if prior is None else as_host_tensor(
            np.asarray(prior, np.float32))
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.device = torch.device(device)
        self.prefetch = max(int(prefetch), 1)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = None
        self._issued = 0  # batches issued: the next one's ring entry
        self._slots = []  # [x slot, prior slot, copy event] per ring entry

    @property
    def steps_per_epoch(self) -> int:
        return self.x.shape[0] // self.batch_size

    def __len__(self) -> int:
        return self.steps_per_epoch

    @property
    def rows_local(self) -> bool:
        """True when a batch holds this rank's rows only."""
        return self._span is not None

    def _local_span(self, sel: np.ndarray) -> np.ndarray:
        """This rank's row indices of a global batch selection."""
        if self._span is None:
            return sel
        start, k = self._span
        return sel[start: start + k]

    def plan(self, epoch_idx: int) -> np.ndarray:
        """(steps, batch_size) row indices of the epoch's batches."""
        n = self.x.shape[0]
        order = (np.random.default_rng((self.seed, epoch_idx)).permutation(n)
                 if self.shuffle else np.arange(n))
        steps = self.steps_per_epoch
        return order[: steps * self.batch_size].reshape(steps,
                                                        self.batch_size)

    def _slot(self, i: int) -> list:
        """Ring entry of batch ``i``: pinned host buffers for x and the
        prior, and the event of the copy that last read them."""
        if not self._slots:
            B = self.batch_size if self._span is None else self._span[1]
            D = self.x.shape[1]
            for _ in range(self.prefetch + 1):
                xs = torch.empty((B, D), dtype=self.dtype, pin_memory=True)
                ps = (None if self.prior is None else
                      torch.empty((B, self.prior.shape[1]),
                                  dtype=torch.float32, pin_memory=True))
                self._slots.append([xs, ps, None])
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._slots[i % len(self._slots)]

    def _issue(self, sel: np.ndarray) -> tuple:
        """Gather the rows ``sel`` on the host and start their copy: the
        batch and the event the consumer waits on (None on the CPU)."""
        st = self.stats
        sel = self._local_span(sel)
        t0 = time.perf_counter()
        if not self._cuda:
            xb = gather_rows(self.x, sel, self.dtype)
            pb = None if self.prior is None else gather_rows(self.prior, sel)
            t1 = time.perf_counter()
            event = None
        else:
            slot = self._slot(self._issued)
            _wait(slot[2], st)  # the slot's last copy must have read it
            t0 = time.perf_counter()
            gather_rows(self.x, sel, out=slot[0])
            if self.prior is not None:
                gather_rows(self.prior, sel, out=slot[1])
            t1 = time.perf_counter()
            with torch.cuda.stream(self._copy_stream):
                xb = slot[0].to(self.device, non_blocking=True)
                pb = (None if self.prior is None else
                      slot[1].to(self.device, non_blocking=True))
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            slot[2] = event
        self._issued += 1
        if st is not None:
            st.gather_s.append(t1 - t0)
            st.commit_s.append(time.perf_counter() - t1)
        return StreamBatch(xb, pb), event

    def epoch(self, epoch_idx: int) -> Iterator[StreamBatch]:
        """Yield the epoch's batches, keeping ``prefetch`` in flight.  On
        CUDA a batch is handed out once the current stream has been told
        to wait for its copy."""
        plan = self.plan(epoch_idx)
        steps = len(plan)
        pending: deque = deque()
        st = self.stats
        depth = min(self.prefetch, steps)
        if st is not None:
            st.waits.append(0)
        for i in range(depth):
            pending.append(self._issue(plan[i]))
        for i in range(steps):
            if i + depth < steps:
                pending.append(self._issue(plan[i + depth]))
            if st is not None:
                st.ahead.append(len(pending))
            batch, event = pending.popleft()
            if event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(event)
                for t in batch:
                    if t is not None:
                        t.record_stream(cur)
            yield batch
            if st is not None and i + 1 < steps:
                st.waits.append(0)


def feed_census(x, batch_size: int, *, dtype=None, n_batches: int = 8,
                seed: int = 0, device="cuda",
                device_ms_per_step: Optional[float] = None,
                link_gbps: Optional[float] = None,
                commit: bool = True) -> dict:
    """Capacity figures of the streaming path (dvae_tpu/data/stream.py
    :251): per batch, ``host_gather_ms`` (the median host time to gather,
    densify and cast one batch, the first batch dropped), ``batch_mb``,
    ``commit_ms`` (the copy's enqueue, with ``commit``), ``link_ms`` =
    batch_mb / ``link_gbps`` where a link rate is given, and with
    ``device_ms_per_step`` the predicted share of the feed hidden behind
    compute, ``predicted_overlap_pct`` = 100·min(1, device / max(host,
    link)), and the stage that bounds the pipeline (``bound_by``).
    ``commit=False`` measures the host stage alone and never touches the
    device."""
    bs = BatchStreamer(x, batch_size, seed=seed, dtype=dtype,
                       device=device if commit else "cpu", prefetch=1,
                       record_stats=True)
    n = min(max(n_batches, 2), bs.steps_per_epoch)
    for i, _ in enumerate(bs.epoch(0)):
        if i + 1 >= n:
            break
    if commit and bs._cuda:
        torch.cuda.synchronize(bs.device)
    gather = sorted(bs.stats.gather_s[1:])
    commits = sorted(bs.stats.commit_s[1:])
    host_ms = 1e3 * gather[len(gather) // 2]
    itemsize = torch.empty((), dtype=bs.dtype).element_size()
    batch_mb = batch_size * int(np.prod(x.shape[1:])) * itemsize / 1e6
    out = {"host_gather_ms": round(host_ms, 3),
           "batch_mb": round(batch_mb, 2)}
    if commit:
        out["commit_ms"] = round(1e3 * commits[len(commits) // 2], 3)
    link_ms = None
    if link_gbps:
        link_ms = batch_mb / link_gbps  # MB / (GB/s) = ms
        out["link_ms"] = round(link_ms, 3)
        out["link_gbps_assumed"] = link_gbps
    if device_ms_per_step is not None:
        feed_ms = max(host_ms, link_ms or 0.0)
        out["device_ms_per_step"] = device_ms_per_step
        out["predicted_overlap_pct"] = round(
            100.0 * min(1.0, device_ms_per_step / feed_ms)
            if feed_ms > 0 else 100.0, 1)
        stages = {"host": host_ms, "link": link_ms or 0.0,
                  "device": device_ms_per_step}
        out["bound_by"] = max(stages, key=stages.get)
    return out


# ---------------------------------------------------------------------------
# Streaming epoch runner (the resident make_epoch_runner's contract)
# ---------------------------------------------------------------------------

def make_streaming_runner(cfg, tcfg, opt, n_train: int, augment=None,
                          prefetch: int = 2, device="cuda",
                          record_stats: bool = False, mesh=None):
    """Streaming twin of ``train.step.make_epoch_runner``.

    Returns ``runner(n_chunk)`` → ``run(state, x_host, prior_host, temp)``
    with the resident runner's contract (``(TrainState, EpochMetrics)``
    stacked over ``n_chunk`` epochs), so ``CplMixVAE._run_phase`` drives
    either.  ``x_host``/``prior_host`` stay on the host; the device holds
    the batches in flight.  One streamer (and its pinned ring) serves
    every chunk of a dataset; ``runner.streamer`` is the last one used."""
    loop = make_chunk_loop(cfg, tcfg, opt, n_train, augment, mesh)
    B = tcfg.batch_size
    store = torch.bfloat16 if tcfg.bf16 else torch.float32
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cache = {}

    def streamer_for(x_host, prior_host) -> BatchStreamer:
        key = (id(x_host), id(prior_host))
        if cache.get("key") != key:
            cache["key"] = key
            cache["streamer"] = BatchStreamer(
                x_host, B, prior=prior_host, seed=tcfg.seed, dtype=store,
                device=dev, prefetch=prefetch, record_stats=record_stats,
                mesh=mesh, whole_batch=augment is not None)
        runner.streamer = cache["streamer"]
        return cache["streamer"]

    def run(state, x_host, prior_host, temp, *, n_chunk: int):
        streamer = streamer_for(x_host, prior_host)

        def batches(gen, epoch):
            done = []
            for s, batch in enumerate(streamer.epoch(epoch)):
                yield batch
                if cuda:
                    # backpressure, once the step on this batch is issued:
                    # the step issued ``prefetch`` iterations ago must be
                    # done before another batch is gathered
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                    done.append(ev)
                    if s >= prefetch:
                        _wait(done[s - prefetch], streamer.stats)
                        done[s - prefetch] = None

        return loop(state, temp, n_chunk, dev, batches,
                    **({"n_rows": B} if streamer.rows_local else {}))

    def runner(n_chunk: int):
        return lambda state, x_host, prior_host, temp: run(
            state, x_host, prior_host, temp, n_chunk=n_chunk)

    runner.streamer = None
    return runner
