"""Mamba2 SSD chunked scan on Hopper (CUDA C++), with its plain version.

Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_scan`` of
``src/repro/kernels/ssd_scan.py``.  Per (batch, head) the state h (P x N,
f32) is carried across the sequence; per chunk ``cum = cumsum(dt·A)``,
``y = (C·Bᵀ ⊙ tril(exp(cum_i − cum_j)))·(dt⊙x) + exp(cum)⊙(C·hᵀ)`` and
``h ← exp(cum[-1])·h + xᵀ·(exp(cum[-1]−cum)⊙dt⊙B)``.

The kernel (``repro_torch/csrc/ssd_scan.cu``) gives each (head, batch) one
thread block that walks the sequence in tiles of ``min(chunk, 64)`` steps
with h in shared memory, where the Pallas kernel relied on the TPU's
sequential grid.  On the H100 the work is bounded by operations (four
small products per tile, f32 FMAs on the CUDA cores in this first
version), not by the bytes of x, y, B, C and h (``PERF.md``).

``ssd_plain`` is the same function in plain PyTorch, a port of the
reference's ``models/mamba.py:ssd_chunked`` (with ``h0`` and the dt=0
padding of a ragged S): the CPU path, and what ``chip_smoke.py`` holds the
kernel against on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: launches of the CUDA kernel (plain-version calls are not counted)
launches = 0

HEAD_DIMS = (16, 32, 64)            # P
STATE_SIZES = (16, 32, 64, 128)     # N
MAX_TILE = 64
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm/Cm (B,S,N) -> y (B,S,nh,P)
    in x.dtype and the final state (B,nh,P,N) in f32."""
    B, S, nh, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
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
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", G, xf)

    # inter-chunk: state contribution of each chunk, then the recurrence
    w = (decay_out * dtf)[..., None] * Bf[:, :, :, None, :]   # (B,nC,Q,nh,N)
    contrib = torch.einsum("bcjhp,bcjhn->bchpn", xf, w)
    h = (torch.zeros((B, nh, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + contrib[:, c]
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cf,
                           torch.stack(h_prevs, dim=1)) * decay_in[..., None]

    y = (y_intra + y_inter).reshape(B, nC * Q, nh, P)[:, :S]
    return y.to(x.dtype), h


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: untyped, ctypes would pass
        # each Python int as a 32-bit C int and cut it
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


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
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel.  CUDA tensors only: no fallback.

    x, Bm, Cm in one of f32/bf16; dt, A in f32; the state starts at 0.
    The kernel's tile is ``min(chunk, 64)`` steps; the result does not
    depend on it."""
    global launches
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"ssd_scan: want x (B,S,nh,P) and Bm/Cm (B,S,N); "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)}")
    B, S, nh, P = x.shape
    N = Bm.shape[-1]
    if P not in HEAD_DIMS or N not in STATE_SIZES:
        raise ValueError(f"ssd_scan: head dim P={P} and state N={N}; the "
                         f"kernel takes P in {HEAD_DIMS}, N in {STATE_SIZES}")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk {chunk} must be positive")
    dev = x.device
    _check("x", x, (B, S, nh, P), _DTYPES, dev)
    _check("dt", dt, (B, S, nh), (torch.float32,), dev)
    _check("A", A, (nh,), (torch.float32,), dev)
    _check("Bm", Bm, (B, S, N), (x.dtype,), dev)
    _check("Cm", Cm, (B, S, N), (x.dtype,), dev)
    y = torch.empty_like(x)
    h_final = torch.empty((B, nh, P, N), dtype=torch.float32, device=dev)
    if h_final.numel() == 0:
        return y, h_final
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().repro_ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(), B, S, nh, P, N,
            min(chunk, MAX_TILE), int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (code {rc})")
    launches += 1
    return y, h_final
