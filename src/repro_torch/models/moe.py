"""Mixture-of-Experts FFN on one device.

Port of the single-device path of the JAX package's ``models/moe.py``
(``moe_block`` with no mesh: ``_local_moe`` over every expert, no
collectives).  Expert-parallel sharding has no counterpart on one card.

Routing runs in f32: softmax over the experts, the top-k, renormalised.
Dispatch is the reference's sort-free table: a cumsum over the one-hot
of the flat ``(token, k)`` assignments gives each its slot in its
expert's column, in that order, so the same assignments overflow an
expert's capacity ``C = ceil(T·k/E · capacity_factor)`` (GShard drop
semantics) as in the reference; an overflowing assignment lands in the
garbage slot ``C``, which is cut off.  An empty slot points at token 0
with weight 0: its input is zeroed, so it adds exactly +0.  The experts'
SwiGLU runs as batched products over ``(E, C, d)`` and the combine is an
f32 ``index_add_``, which has a deterministic CUDA path under
``torch.use_deterministic_algorithms(True)``.  The top-k is a stable
descending sort, so ties pick the lower expert first, as ``lax.top_k``
does.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamSpec

CAPACITY_FACTOR = 1.25


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    E, d, f = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": ParamSpec((d, E), (None, None)),
        "w_gate": ParamSpec((E, d, f), ("experts", "d_model", "moe_ff")),
        "w_up": ParamSpec((E, d, f), ("experts", "d_model", "moe_ff")),
        "w_down": ParamSpec((E, f, d), ("experts", "moe_ff", "d_model")),
    }


def capacity(tokens: int, k: int, num_experts: int,
             factor: float = CAPACITY_FACTOR) -> int:
    # an expert can receive at most `tokens` assignments, so C is capped there
    return min(tokens, max(k, int(math.ceil(tokens * k / num_experts
                                            * factor))))


def route(x: torch.Tensor, router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, d) -> (probs (T, E) f32, top_w (T, k) renormalised, top_e
    (T, k) expert ids in descending probability)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    return probs, top_w / top_w.sum(dim=-1, keepdim=True), top_e


def dispatch(top_e: torch.Tensor, top_w: torch.Tensor, num_experts: int,
             C: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (E, C) tables: token id, weight (f32) and whether the slot is
    taken, filled in flat (token, k) order; assignments past C dropped."""
    T, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(-1)                                  # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    onehot = flat_e[:, None] == torch.arange(num_experts, device=dev)
    slot_per_e = torch.cumsum(onehot.int(), dim=0) - 1          # (T*k, E)
    slot = torch.where(onehot, slot_per_e, 0).sum(dim=1)        # (T*k,)
    keep = slot < C
    le_c = torch.where(keep, flat_e, 0)
    slot_c = torch.where(keep, slot, C)          # overflow slot C = garbage
    idx = (le_c, slot_c)
    shape = (num_experts, C + 1)
    table = torch.zeros(shape, dtype=torch.long, device=dev).index_put(
        idx, flat_t)
    wtab = torch.zeros(shape, dtype=torch.float32, device=dev).index_put(
        idx, flat_w)
    vtab = torch.zeros(shape, dtype=torch.bool, device=dev).index_put(
        idx, keep)
    return table[:, :C], wtab[:, :C], vtab[:, :C]


def _local_moe(x: torch.Tensor, params, cfg, dropless: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d) in x's dtype, aux scalar f32)."""
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T, d = x.shape
    probs, top_w, top_e = route(x, params["router"], k)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e, top-1 routing
    f_e = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(f_e * probs.mean(dim=0))

    C = T if dropless else capacity(T, k, E, cfg.moe_capacity_factor)
    table, wtab, vtab = dispatch(top_e, top_w, E, C)

    dt = x.dtype
    xin = x[table.reshape(-1)].reshape(E, C, d)
    xin = torch.where(vtab[..., None], xin, 0).to(dt)
    g = torch.bmm(xin, params["w_gate"].to(dt))
    u = torch.bmm(xin, params["w_up"].to(dt))
    out = torch.bmm(F.silu(g) * u, params["w_down"].to(dt))
    out = out * (wtab * vtab)[..., None].to(dt)

    # combine: f32 scatter-add back to the tokens
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, table.reshape(-1), out.reshape(-1, d).float())
    return y.to(dt), aux


def moe_block(params, cfg, x: torch.Tensor, dropless: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), or (B, d) for a decode step -> (y of x's shape,
    aux_loss scalar), over the T = B·S tokens.  ``dropless`` sets C = T
    (decode)."""
    y, aux = _local_moe(x.reshape(-1, x.shape[-1]), params, cfg, dropless)
    return y.reshape(x.shape), aux
