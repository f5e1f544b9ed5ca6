"""Mamba2 SSD chunked scan on Hopper (CUDA C++), with its plain versions.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan`` of
``src/repro/kernels/ssd_scan.py``.  Per (batch, head) the state h (P x N,
f32) is carried across the sequence; per chunk ``cum = cumsum(dt·A)``,
``y = (C·Bᵀ ⊙ tril(exp(cum_i − cum_j)))·(dt⊙x) + exp(cum)⊙(C·hᵀ)`` and
``h ← exp(cum[-1])·h + xᵀ·(exp(cum[-1]−cum)⊙dt⊙B)``.

Two kernels, picked by ``variant(dtype, P, N)``; nothing falls back from
one to the other:

- ``csrc/ssd_scan_tc.cu`` ("tc"): bf16 at P = 64 (mamba2, Jamba), on the
  tensor cores.  Three launches: the chunks' own states in parallel over
  (batch, chunk, head) (wgmma, TMA), a scan over the chunk states, and the
  output in parallel again, with C·Bᵀ computed once per block and shared
  by its heads; the wrapper allocates the scratch between them.  Its tile
  is ``tc_tile(chunk)`` = 64 or 128 steps.  The f32 operands of its
  products (the state factor, h_prev and G) are split into hi + lo bf16
  parts; ``ssd_tc_plain`` rounds where it rounds.
- ``csrc/ssd_scan.cu`` ("fma"): f32, and P = 16 or 32 (the smoke
  configs and the small reference checks); one thread block
  per (head, batch) walks the sequence in tiles of ``min(chunk, 64)`` steps
  with h in shared memory, f32 FMAs on the CUDA cores.

The result does not depend on the chunk or tile.  Times against the
bounds (bytes at the bf16 serving shape) are in ``PERF.md``.

``ssd_plain`` is the same function in plain PyTorch, a port of the
reference's ``models/mamba.py:ssd_chunked`` (with ``h0`` and the dt=0
padding of a ragged S): the CPU path, and what ``chip_smoke.py`` holds
both kernels against on the card.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: launches of each CUDA kernel, and their sum (plain-version calls are
#: not counted); ``served`` counts them by (variant, dtype, P, N)
launches_tc = 0
launches_fma = 0
launches = 0
served = collections.Counter()

HEAD_DIMS = (16, 32, 64)            # P of the CUDA-core kernel
TC_HEAD_DIMS = (64,)                # P of the tensor-core kernel (bf16)
STATE_SIZES = (16, 32, 64, 128)     # N, both kernels
MAX_TILE = 64                       # the CUDA-core kernel's longest tile
_DTYPES = (torch.float32, torch.bfloat16)


def variant(dtype: torch.dtype, P: int, N: int) -> str:
    """The kernel that serves (dtype, P, N): "tc" (tensor cores, bf16) or
    "fma" (CUDA cores).  Raises on what neither takes."""
    if dtype not in _DTYPES:
        raise ValueError(f"ssd_scan: dtype {dtype}; want one of {_DTYPES}")
    if P not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(f"ssd_scan: head dim P={P} and state N={N}; the "
                         f"kernels take P in {HEAD_DIMS}, N in {STATE_SIZES}")
    return "tc" if dtype == torch.bfloat16 and P in TC_HEAD_DIMS else "fma"


def tc_tile(chunk: int) -> int:
    """Steps per chunk of the tensor-core kernel: 64 up to a chunk of 64,
    else 128 (wgmma's 64-row tiles, one or two warpgroups)."""
    return 64 if chunk <= 64 else 128


def _whole(v: torch.Tensor) -> Sequence[torch.Tensor]:
    return (v,)


def _hi_lo(v: torch.Tensor) -> Sequence[torch.Tensor]:
    """v as the sum of two bf16 values (hi = bf16(v), lo = bf16(v - hi)),
    in f32: what the tensor-core kernel feeds wgmma for an f32 operand."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _chunked(x, dt, A, Bm, Cm, Q: int, h0: Optional[torch.Tensor],
             parts: Callable[[torch.Tensor], Sequence[torch.Tensor]]):
    """The chunked scan at chunk length Q; each f32 operand of a product
    with x, C or h_prev goes in as ``parts(operand)``, summed."""
    B, S, nh, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % Q
    if pad:
        # dt=0 steps: decay exp(0)=1, contribution 0 — a no-op for the
        # recurrence, sliced off the output below
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nC = x.shape[1] // Q

    xf = x.float().reshape(B, nC, Q, nh, P)
    dtf = dt.float().reshape(B, nC, Q, nh)
    Bf = Bm.float().reshape(B, nC, Q, N)
    Cf = Cm.float().reshape(B, nC, Q, N)
    cum = torch.cumsum(dtf * A.float(), dim=2)            # (B,nC,Q,nh)
    decay_in = torch.exp(cum)
    total = cum[:, :, -1:, :]
    decay_out = torch.exp(total - cum)
    chunk_decay = torch.exp(total[:, :, 0, :])            # (B,nC,nh)

    # intra-chunk: L[i,j] = exp(cum_i - cum_j) for j <= i; the upper
    # triangle is set to -inf before the exp (it could overflow there)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nC,Qi,Qj,nh)
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    CB = torch.einsum("bcin,bcjn->bcij", Cf, Bf)          # (B,nC,Q,Q)
    G = CB[..., None] * L * dtf[:, :, None, :, :]         # (B,nC,Qi,Qj,nh)
    y_intra = sum(torch.einsum("bcijh,bcjhp->bcihp", g, xf)
                  for g in parts(G))

    # inter-chunk: state contribution of each chunk, then the recurrence
    w = (decay_out * dtf)[..., None] * Bf[:, :, :, None, :]   # (B,nC,Q,nh,N)
    contrib = sum(torch.einsum("bcjhp,bcjhn->bchpn", xf, wp)
                  for wp in parts(w))
    h = (torch.zeros((B, nh, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + contrib[:, c]
    y_inter = sum(torch.einsum("bcin,bchpn->bcihp", Cf, hp)
                  for hp in parts(torch.stack(h_prevs, dim=1))
                  ) * decay_in[..., None]

    y = (y_intra + y_inter).reshape(B, nC * Q, nh, P)[:, :S]
    return y.to(x.dtype), h


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm/Cm (B,S,N) -> y (B,S,nh,P)
    in x.dtype and the final state (B,nh,P,N) in f32."""
    return _chunked(x, dt, A, Bm, Cm, min(chunk, x.shape[1]), h0, _whole)


def ssd_tc_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core kernel's numerics in plain PyTorch: its tile
    ``tc_tile(chunk)``, and the state factor exp(total − cum)⊙dt⊙B, h_prev
    and G each split into hi + lo bf16 parts before their products with
    x or C (x, B, C, products and sums otherwise exact or f32)."""
    return _chunked(x, dt, A, Bm, Cm, tc_tile(chunk), None, _hi_lo)


# (library, C entry, argument types after the seven tensor pointers) of
# each variant; pointers and the stream as c_void_p: untyped, ctypes would
# pass each Python int as a 32-bit C int and cut it
_ENTRIES = {
    "tc": ("ssd_scan_tc", "repro_ssd_scan_tc_fwd",
           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6),
    "fma": ("ssd_scan", "repro_ssd_scan_fwd", [ctypes.c_int] * 7),
}


def _entry(kind: str):
    name, symbol, rest = _ENTRIES[kind]
    fn = getattr(build.load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + rest + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, shape, dtypes, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, the kernel "
                         f"runs on CUDA tensors only")
    if t.device != device:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd_scan: {name} has shape {tuple(t.shape)}, "
                         f"want {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"ssd_scan: {name} is {t.dtype}; want one of "
                         f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"ssd_scan: {name} is not contiguous")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             kind: Optional[str] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel that ``variant`` picks, or ``kind="fma"`` (which
    takes every dtype, P and N that "tc" takes, for timing the two in
    turns).  CUDA tensors only: no fallback.

    x, Bm, Cm in one of f32/bf16; dt, A in f32; the state starts at 0.
    The tile is ``tc_tile(chunk)`` steps on "tc" and ``min(chunk, 64)`` on
    "fma"; the result does not depend on it."""
    global launches, launches_tc, launches_fma
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"ssd_scan: want x (B,S,nh,P) and Bm/Cm (B,S,N); "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, S, nh, P = x.shape
    N = Bm.shape[-1]
    picked = variant(x.dtype, P, N)
    if kind is None:
        kind = picked
    elif kind not in (picked, "fma"):
        raise ValueError(f"ssd_scan: kind {kind!r} does not take "
                         f"({x.dtype}, P={P}, N={N})")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} must be positive")
    dev = x.device
    _check("x", x, (B, S, nh, P), _DTYPES, dev)
    _check("dt", dt, (B, S, nh), (torch.float32,), dev)
    _check("A", A, (nh,), (torch.float32,), dev)
    _check("Bm", Bm, (B, S, N), (x.dtype,), dev)
    _check("Cm", Cm, (B, S, N), (x.dtype,), dev)
    if kind == "tc" and any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan: TMA reads x, Bm, Cm from 16-byte "
                         "aligned addresses only")
    y = torch.empty_like(x)
    h_final = torch.empty((B, nh, P, N), dtype=torch.float32, device=dev)
    if h_final.numel() == 0:
        return y, h_final
    args = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h_final.data_ptr()]
    if kind == "tc":
        Q = tc_tile(chunk)
        nC = -(-S // Q)
        # scratch: the chunks' own states and decays, then the state
        # entering each chunk as bf16 hi and lo parts
        states = torch.empty((B, nC, nh, P, N), dtype=torch.float32,
                             device=dev)
        totals = torch.empty((B, nC, nh), dtype=torch.float32, device=dev)
        hprev = torch.empty((B, nC, nh, 2, P, N), dtype=torch.bfloat16,
                            device=dev)
        args += [states.data_ptr(), totals.data_ptr(), hprev.data_ptr(),
                 B, S, nh, P, N, Q]
    else:
        args += [B, S, nh, P, N, min(chunk, MAX_TILE),
                 int(x.dtype == torch.bfloat16)]
    with torch.cuda.device(dev):
        rc = _entry(kind)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan ({kind}) kernel launch failed "
                           f"(code {rc})")
    if kind == "tc":
        launches_tc += 1
    else:
        launches_fma += 1
    launches += 1
    served[kind, str(x.dtype).replace("torch.", ""), P, N] += 1
    return y, h_final
