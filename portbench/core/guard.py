"""What a run may not have loaded, and the card it needs.

The benchmark measures the PyTorch port.  The JAX package beside it, and
JAX itself, are neither measured nor loaded: a run that finds one of them
in ``sys.modules`` prints no result.  Names are compared by their top-level
part whole, so ``dvae_tpu_torch`` (the port) is not ``dvae_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dvae_tpu")


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names of loaded modules that a run may not load."""
    names = sys.modules if modules is None else modules
    tops = {str(n).split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))


def environment() -> dict:
    """Settings for the run's process: libraries the port uses kept from
    loading JAX.  Nothing else is set: the host's allocator and its math
    libraries' threads stay as an analyst's own process has them."""
    return {"USE_FLAX": "0", "USE_JAX": "0"}


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark "
                     "runs on NVIDIA GPUs only")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell asks for {n} GPUs; {have} visible")
