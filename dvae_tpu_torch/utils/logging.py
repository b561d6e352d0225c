"""Metric logging and printing of the PyTorch port.

Counterpart of dvae_tpu/utils/logging.py without wandb: ``MetricLogger``
keeps an in-memory history and appends JSON lines to a file; ``mprint``
prints (one process: the port runs on one card); ``device_memory_mb``
reads ``torch.cuda.memory_allocated``.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import torch


def mprint(*args, **kwargs) -> None:
    """Print from the main process (the port runs one process)."""
    print(*args, **kwargs, flush=True)


class MetricLogger:
    """In-memory history plus an optional JSONL file, one record per call."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 config: Optional[dict] = None):
        self.history: list[dict] = []
        self.jsonl_path = jsonl_path
        self.config = dict(config or {})

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec["_time"] = time.time()
        self.history.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")

    def finish(self) -> None:
        """Nothing to flush: every record is written when it is logged."""


def device_memory_mb(device=None) -> float:
    """Allocated memory of a CUDA device in MB (2**20 bytes); 0 without a
    CUDA device."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(device) / 2 ** 20
