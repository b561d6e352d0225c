"""Collective-traffic accounting for the multi-device training step.

Counterpart of dvae_tpu/parallel/collective_cost.py.  The JAX package
compiles the epoch runner over an N-device mesh and parses the
collectives out of the optimised HLO module.  The port emits no HLO: its
collectives are the calls of ``parallel/runtime.py``, and the recorder
there (``record_collectives``) lists each one as it is issued (kind,
dtype, local payload bytes, group size).  ``stats_from_records`` applies
the JAX package's ring-cost model to that list:

    all-reduce       2·(g−1)/g · bytes     (reduce-scatter + all-gather)
    all-gather         (g−1)/g · gathered bytes
    reduce-scatter     (g−1)/g · input bytes
    broadcast, all-to-all, collective-permute: bytes

(g = the group's size; the bytes are one rank's local tensors).  A
reduce-scatter is recorded with its whole input, as the JAX census counts
the async form.  ``predict`` divides wire bytes by a link rate to bound a
step's communication time.  Its default is 450 GB/s a direction, the
NVLink 4 figure of NVIDIA's H100 SXM datasheet (900 GB/s both ways), not
a measurement; two ranks over gloo on one card move their bytes through
host memory and reach nothing near it.

``epoch_runner_collective_stats`` runs one chunk of the real mesh runner
(``train/step.make_epoch_runner`` with the mesh) under the recorder.  The
JAX module holds each in-loop collective once (its step loop is rolled);
the port's Python loop issues a step's list once a step, so the census
keeps one step's list (every step must record the same one, or it
raises) and adds the chunk's own collectives (the labels gathered for the
consensus) once, as the JAX module holds its out-of-loop ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch

# NVIDIA H100 SXM datasheet: NVLink 4, 900 GB/s bidirectional
NVLINK_GBPS = 450.0

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "broadcast",
          "all-to-all", "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    """Per-step collective census.

    ``counts``/``bytes_by_kind``: per collective kind, number of ops and
    summed local tensor bytes.  ``wire_bytes``: ring-model bytes a single
    rank moves per *step* (see the module docstring for how a chunk's
    records become one step's)."""

    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]
    wire_bytes: float

    @property
    def total_ops(self) -> int:
        return sum(self.counts.values())

    def ici_seconds(self, gbps: float = NVLINK_GBPS) -> float:
        """Non-overlapped wire time at ``gbps`` GB/s a rank a direction
        (default: the H100 SXM's NVLink 4 datasheet figure)."""
        return self.wire_bytes / (gbps * 1e9)


def stats_from_records(records: Iterable, n_devices: int) -> CollectiveStats:
    """The census of a list of ``runtime.CollectiveRecord``s (marks are
    skipped); a record without a group size spans ``n_devices``."""
    counts: Dict[str, int] = {}
    bytes_by_kind: Dict[str, int] = {}
    wire = 0.0
    for r in records:
        if r.kind not in _KINDS:
            continue
        g = r.group_size or n_devices
        counts[r.kind] = counts.get(r.kind, 0) + 1
        bytes_by_kind[r.kind] = bytes_by_kind.get(r.kind, 0) + r.nbytes
        if g <= 1:
            continue
        if r.kind == "all-reduce":
            wire += 2.0 * (g - 1) / g * r.nbytes
        elif r.kind in ("all-gather", "reduce-scatter"):
            wire += (g - 1) / g * r.nbytes
        else:                                     # broadcast / permute
            wire += r.nbytes
    return CollectiveStats(counts, bytes_by_kind, wire)


def per_step_records(records: list) -> list:
    """One step's records plus the chunk's own (those after the last step
    mark), from a chunk's list; raises when the steps recorded different
    lists."""
    steps, tail = [], []
    for r in records:
        if r.kind == "step":
            steps.append(tail)
            tail = []
        else:
            tail.append(r)
    if not steps:
        raise ValueError("the records hold no step mark: record a chunk of "
                         "train/step.make_epoch_runner")
    for i, s in enumerate(steps[1:], 1):
        if s != steps[0]:
            raise AssertionError(
                f"step {i} recorded other collectives than step 0: "
                f"{len(s)} against {len(steps[0])}")
    return steps[0] + tail


def _whole_dataset(cfg, n_train: int, dtype, device, seed: int = 0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n_train, cfg.input_dim), generator=g).clamp_min_(0.0)
    return x.to(dtype).to(device)


def epoch_runner_collective_stats(cfg, tcfg, strategy, mesh, n_train: int,
                                  augment=None, device=None,
                                  info: Optional[dict] = None
                                  ) -> CollectiveStats:
    """Run one chunk of the real epoch runner sharded per ``strategy`` on
    this rank's ``mesh`` (every rank of the world calls) and census its
    collectives per step.  ``device``: the mesh's device (default CUDA);
    ``info``, if a dict, receives ``seconds``, the chunk's wall time
    (synchronised), ``steps`` and ``records``, the per-step records the
    census counts."""
    import time

    from dvae_tpu_torch.parallel.runtime import record_collectives
    from dvae_tpu_torch.parallel.sharding import place_state, state_specs
    from dvae_tpu_torch.train.step import (init_train_state,
                                           make_epoch_runner, make_optimizer)

    tcfg = dataclasses.replace(tcfg, sharding=strategy, mesh=mesh.cfg)
    dev = torch.device(device or "cuda")
    opt = make_optimizer(cfg, tcfg.optimizer)
    state = init_train_state(0, cfg, opt, device=dev)
    state = place_state(state, state_specs(cfg, strategy, mesh), mesh)
    x = _whole_dataset(cfg, n_train,
                       torch.bfloat16 if tcfg.bf16 else torch.float32, dev)
    run = make_epoch_runner(cfg, tcfg, opt, n_train, epochs_per_chunk=1,
                            augment=augment, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with record_collectives() as records:
        _, ems = run(state, x, None, 1.0)
    ems.total.cpu()
    seconds = time.perf_counter() - t0
    step = per_step_records(records)
    if info is not None:
        info.update(seconds=seconds, steps=n_train // tcfg.batch_size,
                    records=step)
    return stats_from_records(step, mesh.cfg.n_devices)


def predict(stats: CollectiveStats, step_seconds: Optional[float],
            gbps: float = NVLINK_GBPS) -> dict:
    """Scaling summary: per-step wire time and the efficiency bracket.

    ``step_seconds``: measured single-device step time (the compute the
    collectives must hide under).  ``no_overlap`` assumes every wire byte
    serializes after compute, ``full_overlap`` that all of it hides."""
    wire_s = stats.ici_seconds(gbps)
    out = {
        "wire_bytes_per_step": stats.wire_bytes,
        "wire_seconds_per_step": wire_s,
        "collective_ops": stats.total_ops,
    }
    if step_seconds:
        out["efficiency_no_overlap"] = step_seconds / (step_seconds + wire_s)
        out["efficiency_full_overlap"] = min(
            1.0, step_seconds / max(step_seconds, wire_s))
    return out
