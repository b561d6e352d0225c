"""Host-side batch gather of the PyTorch port.

Counterpart of the numpy path of ``gather_rows`` in
dvae_tpu/utils/host_ops.py (:127): the rows ``sel`` of a host matrix, with
an optional cast.  The JAX package's native threaded gather
(``native/host_ops``) is not ported: ``torch.index_select`` on a CPU
tensor already runs on the host's threads, and the cast is torch's, which
rounds to nearest even as ml_dtypes does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def as_host_tensor(x) -> torch.Tensor:
    """A dense host matrix (numpy or CPU tensor) as a CPU tensor, without a
    copy where numpy's layout allows it."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"expected a host matrix, got one on {x.device}")
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def gather_rows(src, sel: np.ndarray, out_dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``src[sel]`` cast to ``out_dtype`` (or ``out``'s dtype), as a CPU
    tensor.

    ``src``: a 2-D numpy array, CPU tensor, or scipy sparse matrix in CSR
    (densified here, only the selected rows).  ``out``: a (len(sel), D)
    buffer to write into (a pinned slot of the streamer), so that a dense
    batch in the storage dtype is copied once on the host."""
    if out is not None:
        out_dtype = out.dtype
    if hasattr(src, "toarray"):
        rows = src[sel]
        if out is not None and out_dtype == torch.float32 \
                and rows.dtype == np.float32:
            rows.toarray(out=out.numpy())  # scipy zeroes ``out`` first
            return out
        rows = torch.from_numpy(rows.toarray())
    else:
        t = as_host_tensor(src)
        idx = torch.from_numpy(np.ascontiguousarray(sel, np.int64))
        if out is not None and out.dtype == t.dtype:
            return torch.index_select(t, 0, idx, out=out)
        rows = t.index_select(0, idx)
    if out is not None:
        return out.copy_(rows)
    if out_dtype is not None and rows.dtype != out_dtype:
        rows = rows.to(out_dtype)
    return rows
