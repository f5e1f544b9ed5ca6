"""Naive torch oracles for the attention, SSD-scan and RMSNorm kernels.

Ports of ``attention_ref``, ``ssd_ref`` and ``rmsnorm_ref`` from the JAX
package's ``kernels/ref.py``: full score matrices in f32, a token-by-token
SSM recurrence, no tiling, so they are independent of both the
hand-written kernels and of the plain versions kept beside each kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive exact attention with GQA.

    q (B, Sq, H, hd); k/v (B, Sk, KV, hd); returns (B, Sq, H, hd).
    ``window`` > 0 restricts key j to (i - window, i] (sliding window).
    A fully masked row is NaN, as in the reference.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float().reshape(B, Sq, KV, rep, hd)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.float()) / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token SSD recurrence (the ground-truth semantics).

    x (B, S, nh, P); dt (B, S, nh) post-softplus; A (nh,) negative;
    Bm/Cm (B, S, N).  Returns y (B, S, nh, P), final state (B, nh, P, N).

      h_t = exp(dt_t A) * h_{t-1} + dt_t * B_t ⊗ x_t
      y_t = C_t · h_t
    """
    B, S, nh, P = x.shape
    N = Bm.shape[-1]
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf = A.float(), Bm.float(), Cm.float()
    h = (torch.zeros((B, nh, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None])                 # (B, nh)
        contrib = torch.einsum("bh,bn,bhp->bhpn", dtf[:, t], Bf[:, t],
                               xf[:, t])
        h = h * decay[:, :, None, None] + contrib
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((B, 0, nh, P))
    return y.to(x.dtype), h


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
