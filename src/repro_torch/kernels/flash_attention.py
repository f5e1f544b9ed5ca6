"""Flash-attention forward on Hopper (CUDA C++), with its plain version.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``.  The kernel
(``repro_torch/csrc/flash_attention.cu``) keeps the online-softmax state
(m, l, acc) in f32 registers and streams K/V tiles through shared memory,
so the (Sq x Sk) score matrix never reaches device memory.  On the H100
the work is bounded by operations (4·B·H·Sq·Sk·hd FLOPs, halved under the
causal mask, against q/k/v/o bytes read or written once); this first
version does its products as FMAs on the CUDA cores rather than on the
tensor cores, so it stays well above that bound (``PERF.md``).

``attention_plain`` is the same function in plain PyTorch: the CPU path,
and what ``chip_smoke.py`` holds the kernel against on the card.  Unlike
``ref.attention_ref`` (NaN), a row with no visible key gives 0 here, as in
the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel (plain-version calls are not counted)
launches = 0

_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _visible(Sq: int, Sk: int, causal: bool, window: int,
             device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd); k/v (B, Sk, KV, hd) -> (B, Sq, H, hd), f32 math."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) / math.sqrt(hd)
    mask = _visible(Sq, Sk, causal, window, q.device)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: untyped, ctypes would pass
        # each Python int as a 32-bit C int and cut it
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel.  CUDA tensors only: no fallback."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,Sq,H,hd), k/v (B,Sk,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"incompatible q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"the kernel runs on CUDA tensors only")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; want "
                             f"one of {_DTYPES}, the same for q, k, v")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{_HEAD_DIMS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, hd, int(causal), int(window),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(code {rc})")
    launches += 1
    return out
