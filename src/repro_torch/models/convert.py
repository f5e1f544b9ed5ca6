"""Carry the JAX package's params, optimizer state and caches into the
port's tensors.

``params_from_numpy(jax.tree.map(np.asarray, params), device)`` turns a
reference param tree (nested dicts, stacked layers) into the same tree of
torch tensors: same paths, same shapes; ``opt_state_from_numpy((step, m,
v), device)`` does the same for an AdamW state.  A bf16 array (numpy dtype
``bfloat16`` from ``ml_dtypes``) arrives through its ``uint16`` bit
pattern, so this module needs no ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.serialization.pack import BF16, numpy_to_tensor

PyTree = Any


def tensor_from_numpy(arr, device, dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == BF16:
        t = numpy_to_tensor(a.view(np.uint16).copy(), BF16)
    else:
        t = torch.from_numpy(a.copy())
    t = t.to(device)
    return t.to(dtype) if dtype is not None else t


def params_from_numpy(tree: PyTree, device,
                      dtype: Optional[torch.dtype] = None) -> PyTree:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    `device` (cast to `dtype` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return tensor_from_numpy(tree, device, dtype)


def opt_state_from_numpy(state, device):
    """(step, m, v) as numpy (the fields of the reference's ``OptState``)
    -> the port's ``OptState``: step a 0-d int32 tensor, m and v trees of
    tensors on `device`."""
    from repro_torch.optim.adamw import OptState
    step, m, v = state
    return OptState(step=torch.as_tensor(np.asarray(step, np.int32),
                                         device=device),
                    m=params_from_numpy(m, device),
                    v=params_from_numpy(v, device))


#: a cache is the same kind of tree: ``pos0/{k,v}`` of (L, B, S, KV, hd),
#: or ``pos0/{h,conv_x,conv_B,conv_C}`` for Mamba layers (dtypes kept)
cache_from_numpy = params_from_numpy
