"""Device choice for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU: with no card
and no explicit ``device="cpu"`` they raise, and never move to the CPU
quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); else as given.  A
    CUDA device comes back with its index (``cuda`` alone: the current
    one), so threads the port starts select the same card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def device_kind(device: Optional[torch.device]) -> str:
    """Human-readable device kind: the CUDA device name, or 'cpu'."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def set_deterministic() -> None:
    """Bitwise-reproducible CUDA runs in this process: the deterministic
    cuBLAS workspace (read when cuBLAS initialises, so call this before
    the first matmul on the card), deterministic algorithms without their
    NaN fill of fresh allocations (a debugging aid; results do not depend
    on it), and no TF32."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
