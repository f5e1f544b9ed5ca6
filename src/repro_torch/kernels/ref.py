"""Naive torch oracles for the attention and RMSNorm kernels.

Ports of ``attention_ref`` and ``rmsnorm_ref`` from the JAX package's
``kernels/ref.py``: full score matrices in f32, no tiling, so they are
independent of both the hand-written kernels and of the plain versions
kept beside each kernel.  ``ssd_ref`` comes with the SSD-scan slice.
"""
from __future__ import annotations

import math

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


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), scale (d,)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
