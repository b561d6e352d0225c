"""Metric logging and printing of the PyTorch port.

Counterpart of dvae_tpu/utils/logging.py: ``MetricLogger`` keeps an
in-memory history, appends JSON lines to a file and, when asked and
``wandb`` imports, forwards every record to wandb; without wandb it
prints one line and logs locally, as the JAX package does.  The rank of
``is_master``/``rprint`` is ``torch.distributed``'s when a process group is
initialised, else 0.  ``device_memory_mb`` reads
``torch.cuda.memory_allocated``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_master() -> bool:
    """True on process 0 (the reference's rank-0 check, cpl_mixvae.py:50)."""
    return _rank() == 0


def mprint(*args, **kwargs) -> None:
    """Print from process 0 only."""
    if is_master():
        print(*args, **kwargs, flush=True)


def rprint(*args, **kwargs) -> None:
    """Print with the process's rank in front (reference ``set_print``,
    mmidas/_dist_utils.py:54-55)."""
    print(f"[proc {_rank()}]", *args, **kwargs)


class MetricLogger:
    """In-memory history plus an optional JSONL file, one record per call,
    and wandb when ``use_wandb`` and it imports (dvae_tpu/utils/logging.py
    :36-93)."""

    def __init__(self, use_wandb: bool = False, project: str = "dvae-tpu",
                 run_name: Optional[str] = None, group: Optional[str] = None,
                 config: Optional[dict] = None,
                 jsonl_path: Optional[str] = None,
                 auto_group_prefix: Optional[str] = None):
        self.history: list[dict] = []
        self.jsonl_path = jsonl_path
        self.config = dict(config or {})
        self._wandb = None
        if use_wandb and is_master():
            try:
                import wandb
                self._wandb = wandb
                if group is None and auto_group_prefix:
                    group = self._next_group(wandb, project,
                                             auto_group_prefix)
                wandb.init(project=project, name=run_name, group=group,
                           config=self.config)
            except Exception as e:
                print(f"wandb unavailable ({e}); falling back to local "
                      "logging")
                self._wandb = None

    @staticmethod
    def _next_group(wandb, project: str, prefix: str) -> str:
        """``{prefix}-{n}`` with n the number of the project's run groups
        that start with ``prefix`` (reference dist/train_smartseq.py:292-370)."""
        try:
            existing = {r.group for r in wandb.Api().runs(project)
                        if r.group and r.group.startswith(prefix)}
            return f"{prefix}-{len(existing)}"
        except Exception:
            return f"{prefix}-0"

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if not is_master():
            return
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec["_time"] = time.time()
        self.history.append(rec)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


_ANSI = {"red": "\033[91m", "green": "\033[92m", "yellow": "\033[93m",
         "blue": "\033[94m", "magenta": "\033[95m", "cyan": "\033[96m",
         "end": "\033[0m"}


def dprint(*args, color: str = "cyan", **kwargs) -> None:
    """Coloured debug print, off under ``python -O`` (the reference's ANSI
    ``dprint``, dist/my_utils.py:87-119)."""
    if __debug__:
        print(_ANSI.get(color, ""), end="")
        print(*args, **kwargs)
        print(_ANSI["end"], end="", flush=True)


def bytes_to_mb(n_bytes: float) -> float:
    """Bytes → MB of 2**20 bytes (reference ``convert``, dist/my_utils.py:125)."""
    return n_bytes / 2**20


def avg(xs) -> float:
    """Arithmetic mean of an iterable, 0 when it is empty (reference
    dist/my_utils.py:73)."""
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def device_memory_mb(device=None) -> float:
    """Allocated memory of a CUDA device in MB (2**20 bytes); 0 without a
    CUDA device."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(device) / 2 ** 20
