"""Flash-attention forward on Hopper (CUDA C++), with its plain version.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``src/repro/kernels/flash_attention.py``.  Two kernels keep the
online-softmax state (m, l, acc) in f32 registers and stream K/V tiles
through shared memory, so the (Sq x Sk) score matrix never reaches device
memory:

- ``csrc/flash_attention_tc.cu`` ("tc"): bf16 on the tensor cores (wgmma,
  TMA loads through a 2-stage ring, one producer warp, two consumer
  warpgroups of 64 query rows), head dims ``TC_HEAD_DIMS``;
- ``csrc/flash_attention.cu`` ("fma"): FMAs on the CUDA cores, for f32
  (TF32 tensor cores would miss the f32 tolerance of 2e-5) and for bf16
  head dims the tensor-core kernel does not take.

``variant(dtype, hd)`` picks one; nothing falls back from one to the other.
The work is 4·B·H·hd·(visible pairs) operations against q/k/v/o crossing
device memory once.  At the serving path's prefill (B=4, S=512, H=16,
hd=64, causal, bf16) the bytes bound it (16.8 MB: 5.0 us at 3.35 TB/s,
against 2.2 us for the 2.15 GFLOP at 989 TFLOP/s); at long prompts the
operations do (phi3-medium at S=4096: 172 GFLOP against 105 MB).  Times
against both bounds are in ``PERF.md``.

``attention_plain`` is the same function in plain PyTorch: the CPU path,
and what ``chip_smoke.py`` holds the kernels against on the card.  Unlike
``ref.attention_ref`` (NaN), a row with no visible key gives 0 here, as in
the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import build

#: launches of each CUDA kernel, and their sum (plain-version calls are
#: not counted); ``served`` counts them by (variant, dtype, head dim)
launches_tc = 0
launches_fma = 0
launches = 0
served = collections.Counter()

#: head dims of the CUDA-core kernel (f32, bf16) and of the tensor-core
#: kernel (bf16 only)
FMA_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
TC_HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def variant(dtype: torch.dtype, hd: int) -> str:
    """The kernel that serves (dtype, hd): "tc" (tensor cores, bf16) or
    "fma" (CUDA cores).  Raises on what neither takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {dtype}; want one of "
                         f"{_DTYPES}")
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS:
        return "tc"
    if hd in FMA_HEAD_DIMS:
        return "fma"
    raise ValueError(f"flash_attention: head dim {hd} not in "
                     f"{FMA_HEAD_DIMS}")


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


# (library, C entry, whether it takes the is_bf16 flag) of each variant
_ENTRIES = {"tc": ("flash_attention_tc", "repro_flash_attention_tc_fwd",
                   False),
            "fma": ("flash_attention", "repro_flash_attention_fwd", True)}


def _entry(kind: str):
    name, symbol, has_dtype = _ENTRIES[kind]
    fn = getattr(build.load(name), symbol)
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: untyped, ctypes would pass
        # each Python int as a 32-bit C int and cut it
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int] * (9 if has_dtype else 8)
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel that ``variant`` picks.  CUDA tensors only: no
    fallback."""
    global launches, launches_tc, launches_fma
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
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}; q, k, "
                             f"v must share one dtype")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
    kind = variant(q.dtype, hd)
    if kind == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: TMA reads q, k, v from 16-byte "
                         "aligned addresses only")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, KV, hd, int(causal), int(window)]
    if kind == "fma":
        args.append(int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        rc = _entry(kind)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({kind}) kernel launch failed "
                           f"(code {rc})")
    if kind == "tc":
        launches_tc += 1
    else:
        launches_fma += 1
    launches += 1
    served[kind, str(q.dtype).replace("torch.", ""), hd] += 1
    return out
