"""Mamba2 (SSD, state-space duality) block in PyTorch.

Port of the JAX package's ``models/mamba.py`` and of ``_mamba_prefill``
(``models/lm.py``), with the reference's param paths and cache layout:

  * ``mamba_specs``: ``w_x``, ``w_z``, ``w_B``, ``w_C``, ``w_dt``,
    ``dt_bias``, ``A_log``, ``D``, ``conv_x``, ``conv_B``, ``conv_C``,
    ``norm``, ``w_out``;
  * ``mamba_block``: the training forward over a sequence (no cache);
  * ``mamba_prefill``: the same block over a prompt, also returning the
    final SSM state and the conv tails (the last W-1 pre-conv inputs) that
    seed decode;
  * ``mamba_decode``: the O(1)-per-token recurrence on the cache
    ``{h (B,nh,P,N) f32, conv_x/B/C (B,W-1,·) compute dtype}``.

Shapes: x (B, S, d_model); d_inner = expand·d_model, nh = d_inner / P
heads, state N.  With ``use_kernels`` the scan of training and prefill
goes through ``ops.ssd`` (the SSD-scan kernel on the card; the reference's
prefill calls ``ssd_chunked``, the same function) and the gated norm over
d_inner through ``ops.rmsnorm``.  Decode stays plain torch, as in the reference,
and updates h and the conv tails in place (no second state per token).
The depthwise causal conv is ``F.conv1d(groups=C)``: the reference
computes it outside any kernel too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec, rmsnorm


def mamba_specs(cfg) -> Dict[str, ParamSpec]:
    d, di, N, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    w = cfg.ssm_conv_width
    return {
        "w_x": ParamSpec((d, di), ("d_model", "ssm_inner")),
        "w_z": ParamSpec((d, di), ("d_model", "ssm_inner")),
        "w_B": ParamSpec((d, N), ("d_model", "state")),
        "w_C": ParamSpec((d, N), ("d_model", "state")),
        "w_dt": ParamSpec((d, nh), ("d_model", "ssm_heads")),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "conv_x": ParamSpec((w, di), ("conv", "ssm_inner")),
        "conv_B": ParamSpec((w, N), ("conv", "state")),
        "conv_C": ParamSpec((w, N), ("conv", "state")),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "w_out": ParamSpec((di, d), ("ssm_inner", "d_model")),
    }


# ----------------------------------------------------------------------
# causal depthwise conv
# ----------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C): depthwise causal convolution, out[t] =
    sum_k x[t - W + 1 + k] · w[k] (zeros before the start)."""
    W, C = w.shape
    xp = F.pad(x.transpose(1, 2), (W - 1, 0))                   # (B, C, S+W-1)
    out = F.conv1d(xp, w.T.to(x.dtype)[:, None, :], groups=C)   # (B, C, S)
    return out.transpose(1, 2)


def conv_step(x_new: torch.Tensor, conv_state: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """One decode step.  x_new (B, C), conv_state (B, W-1, C) shifted in
    place to hold the newest W-1 inputs, w (W, C) -> (B, C)."""
    full = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full.float(), w.float()).to(x_new.dtype)
    conv_state.copy_(full[:, 1:])
    return y


# ----------------------------------------------------------------------
# SSD
# ----------------------------------------------------------------------
def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor
                    ) -> torch.Tensor:
    """One-token recurrence.  x (B,nh,P), dt (B,nh), Bm/Cm (B,N); h
    (B,nh,P,N) f32 becomes h·exp(dt·A) + dt·x⊗B in place; returns y
    (B,nh,P) = C·h_new in x.dtype."""
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())                          # (B, nh)
    contrib = ((dtf[:, :, None] * x.float())[..., None]
               * Bm.float()[:, None, None, :])                  # (B,nh,P,N)
    h.mul_(decay[:, :, None, None]).add_(contrib)
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), h)
    return y.to(x.dtype)


def _gated_norm(params, cfg, y: torch.Tensor, z: torch.Tensor,
                use_kernels: bool) -> torch.Tensor:
    return rmsnorm({"scale": params["norm"]}, y * F.silu(z), cfg.norm_eps,
                   use_kernels)


def _dt_A(params, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["A_log"].float())


# ----------------------------------------------------------------------
# block: prefill and decode
# ----------------------------------------------------------------------
def _mixer(params, cfg, x: torch.Tensor, use_kernels: bool,
           with_tails: bool):
    """The block over a sequence, shared by training and prefill: (out,
    h_final, the conv tails when `with_tails`, else None)."""
    B, S, _ = x.shape
    di, nh, P = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    W = cfg.ssm_conv_width
    dt_ = x.dtype
    xz = x @ params["w_z"].to(dt_)
    xi = x @ params["w_x"].to(dt_)
    Bm = x @ params["w_B"].to(dt_)
    Cm = x @ params["w_C"].to(dt_)
    dt = x @ params["w_dt"].to(dt_)
    tails = None
    if with_tails:
        # the last W-1 pre-conv inputs (zeros before the start, as the
        # conv sees them), copied so the full activations are not kept
        # alive
        tails = {name: F.pad(t, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):]
                 .contiguous()
                 for name, t in (("conv_x", xi), ("conv_B", Bm),
                                 ("conv_C", Cm))}
    xi = F.silu(causal_conv(xi, params["conv_x"]))
    Bm = F.silu(causal_conv(Bm, params["conv_B"])).contiguous()
    Cm = F.silu(causal_conv(Cm, params["conv_C"])).contiguous()
    dt, A = _dt_A(params, dt)
    xh = xi.reshape(B, S, nh, P).contiguous()
    if use_kernels:
        from repro_torch.kernels import ops
        y, h_final = ops.ssd(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        from repro_torch.kernels.ssd_scan import ssd_plain
        y, h_final = ssd_plain(xh, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    y = (y + params["D"].float()[None, None, :, None] * xh).to(dt_)
    y = _gated_norm(params, cfg, y.reshape(B, S, di), xz, use_kernels)
    return y @ params["w_out"].to(dt_), h_final, tails


def mamba_block(params, cfg, x: torch.Tensor, use_kernels: bool = False
                ) -> torch.Tensor:
    """Training forward.  x (B, S, d_model) -> (B, S, d_model)."""
    return _mixer(params, cfg, x, use_kernels, with_tails=False)[0]


def mamba_prefill(params, cfg, x: torch.Tensor, use_kernels: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Dict[str, torch.Tensor]]:
    """x (B, S, d_model) -> (out (B, S, d_model), h_final (B,nh,P,N) f32,
    conv tails {conv_x, conv_B, conv_C} of (B, W-1, ·))."""
    return _mixer(params, cfg, x, use_kernels, with_tails=True)


def mamba_decode(params, cfg, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 use_kernels: bool = False) -> torch.Tensor:
    """One-token decode.  x (B, d_model); `cache` {h, conv_x, conv_B,
    conv_C} of one layer, updated in place.  Returns (B, d_model)."""
    B, _ = x.shape
    di, nh, P = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    dt_ = x.dtype
    xz = x @ params["w_z"].to(dt_)
    xi = x @ params["w_x"].to(dt_)
    Bm = x @ params["w_B"].to(dt_)
    Cm = x @ params["w_C"].to(dt_)
    dt = x @ params["w_dt"].to(dt_)
    xi = F.silu(conv_step(xi, cache["conv_x"], params["conv_x"]))
    Bm = F.silu(conv_step(Bm, cache["conv_B"], params["conv_B"]))
    Cm = F.silu(conv_step(Cm, cache["conv_C"], params["conv_C"]))
    dt, A = _dt_A(params, dt)
    xh = xi.reshape(B, nh, P)
    y = ssd_decode_step(xh, dt, A, Bm, Cm, cache["h"])
    y = (y + params["D"].float()[None, :, None] * xh).to(dt_)
    y = _gated_norm(params, cfg, y.reshape(B, di), xz, use_kernels)
    return y @ params["w_out"].to(dt_)


# the cache's logical axes (a leading "layers" dim is added by the model)
MAMBA_CACHE_AXES = {
    "h": ("batch", "ssm_heads", None, None),
    "conv_x": ("batch", None, "ssm_inner"),
    "conv_B": ("batch", None, "state"),
    "conv_C": ("batch", None, "state"),
}


# ----------------------------------------------------------------------
# cache
# ----------------------------------------------------------------------
def mamba_cache_init(cfg, batch: int, dtype=torch.float32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """h in f32, the conv tails in the compute dtype (reference layout);
    ``device="meta"`` gives the abstract skeleton (no allocation)."""
    di, N, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    w = cfg.ssm_conv_width
    return {
        "h": torch.zeros((batch, nh, P, N), dtype=torch.float32,
                         device=device),
        "conv_x": torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w - 1, N), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, N), dtype=dtype, device=device),
    }
