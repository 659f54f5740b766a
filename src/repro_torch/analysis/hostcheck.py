"""Host-boundary validation of request->tenant ids.

JAX's gather clamps an out-of-range index, so the JAX package checks ids
where they enter from the host.  In the port an out-of-range index is
worse: a torch index raises deep inside a layer, and a CUDA kernel would
read out of bounds.  So ids are checked here, at the host boundary, and
checked again by the kernel wrappers in ``kernels/bgmv.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def check_adapter_ids(adapter_ids, size: int, *, what: str = "adapter_id"):
    """Raise if any id lies outside ``[0, size)``; return the ids unchanged.

    ``adapter_ids`` may be a list, a numpy array or a tensor (a CUDA tensor
    is copied to the host, which waits for the device)."""
    ids = torch.as_tensor(adapter_ids).detach().cpu().numpy()
    bad = np.argwhere((ids < 0) | (ids >= size)).reshape(-1)
    if bad.size:
        raise ValueError(
            f"{what} out of range for a bank of {size} tenants: rows "
            f"{bad.tolist()} hold ids {ids.reshape(-1)[bad].tolist()}")
    return adapter_ids
