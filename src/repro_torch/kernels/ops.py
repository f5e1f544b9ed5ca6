"""Dispatch over the hand-written kernels, by the tensor's device.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the kernel, which raises on what it does not take.  There
is no fallback from CUDA to the plain version and no switch that forces
one: a CUDA run either went through the kernel or failed.

Forward only: serving takes no gradient.  (The JAX package's ``ops``
wraps each kernel in a ``custom_vjp``; the ``torch.autograd.Function``
counterparts come with training.)
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd_scan as _ssd


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    if q.device.type == "cpu":
        return _fa.attention_plain(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm/Cm
    (B,S,N) -> y (B,S,nh,P), h_final (B,nh,P,N) f32."""
    if x.device.type == "cpu":
        return _ssd.ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
    return _ssd.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,) -> same shape and dtype as x."""
    if x.device.type == "cpu":
        return _rn.rmsnorm_plain(x, scale, eps)
    return _rn.rmsnorm(x, scale, eps=eps)
