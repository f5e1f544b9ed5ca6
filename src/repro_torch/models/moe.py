"""Mixture-of-Experts FFN, expert-parallel across the ranks of a mesh.

Port of the JAX package's ``models/moe.py``.  The reference writes its
block as a ``shard_map`` body (``_local_moe``) run on every shard of the
mesh: tokens over the data-parallel axes, expert weights over ``model``
on the experts dim (EP) and over ``data`` on ``d_model`` (FSDP).  The
port runs the same body in each rank of a process mesh:

  * a rank holds its ``E_loc = E / |model|`` experts whole in ``d``:
    the models gather expert leaves over ``data`` alone
    (``sharding.policy.param_gather``), the body's FSDP gather;
  * routing runs in f32 over all E experts on every model rank (the
    same on each: the tokens are the data row's);
  * the dispatch table covers the local experts only, ``first_e =
    index · E_loc`` on: a cumsum over the one-hot of the flat ``(token,
    k)`` assignments to them gives each its slot in its expert's column,
    in that order, with ``C = ceil(T·k/E · capacity_factor)`` from the
    local token count and the full E, so an expert's column, and its
    dropped assignments, are those of the one-rank table for the same
    tokens (GShard drop semantics); an overflowing assignment lands in
    the garbage slot ``C``, which is cut off, and an empty slot points
    at token 0 with weight 0: its input is zeroed, so it adds exactly
    +0;
  * the local experts' SwiGLU runs as batched products over ``(E_loc,
    C, d)`` and the combine is an f32 ``index_add_`` (deterministic on
    a card under ``torch.use_deterministic_algorithms(True)``); the
    partial outputs are summed in f32 over the model ranks
    (``distributed.AllReduce``, whose backward sums the grads as the
    transpose of the reference's ``psum`` does) before the cast;
  * the load-balance aux loss is averaged over the data-parallel ranks
    (the reference's ``pmean``);
  * decode is dropless (``C = T``).

The block learns where it stands from a :class:`ExpertShard`
(``sharding.policy``), which the models take from the gather of their
call.  Without one (one rank, or no mesh) the body holds every expert
and runs no collective.  The top-k is a stable descending sort, so ties
pick the lower expert first, as ``lax.top_k`` does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import AllReduce
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
             C: int, first_e: int = 0, local: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (E_loc, C) tables of the `local` experts from `first_e` on
    (default: all `num_experts`): token id, weight (f32) and whether the
    slot is taken, filled in flat (token, k) order; assignments past C,
    or to other experts, left out."""
    T, k = top_e.shape
    dev = top_e.device
    E_loc = num_experts if local is None else local
    flat_e = top_e.reshape(-1) - first_e                        # (T*k,)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    onehot = flat_e[:, None] == torch.arange(E_loc, device=dev)
    slot_per_e = torch.cumsum(onehot.int(), dim=0) - 1      # (T*k, E_loc)
    slot = torch.where(onehot, slot_per_e, 0).sum(dim=1)        # (T*k,)
    keep = (slot < C) & (flat_e >= 0) & (flat_e < E_loc)
    le_c = torch.where(keep, flat_e, 0)
    slot_c = torch.where(keep, slot, C)          # overflow slot C = garbage
    idx = (le_c, slot_c)
    shape = (E_loc, C + 1)
    table = torch.zeros(shape, dtype=torch.long, device=dev).index_put(
        idx, flat_t)
    wtab = torch.zeros(shape, dtype=torch.float32, device=dev).index_put(
        idx, flat_w)
    vtab = torch.zeros(shape, dtype=torch.bool, device=dev).index_put(
        idx, keep)
    return table[:, :C], wtab[:, :C], vtab[:, :C]


def partial_moe(x: torch.Tensor, params, cfg, dropless: bool,
                first_e: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The body before its collectives: x (T, d), `params`' expert
    leaves this rank's ``E_loc`` experts from `first_e` on -> (the local
    experts' share of y (T, d) in f32, this rank's aux scalar f32)."""
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    T, d = x.shape
    E_loc = params["w_gate"].shape[0]
    probs, top_w, top_e = route(x, params["router"], k)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e, top-1 routing
    f_e = F.one_hot(top_e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(f_e * probs.mean(dim=0))

    C = T if dropless else capacity(T, k, E, cfg.moe_capacity_factor)
    table, wtab, vtab = dispatch(top_e, top_w, E, C, first_e, E_loc)

    dt = x.dtype
    xin = x[table.reshape(-1)].reshape(E_loc, C, d)
    xin = torch.where(vtab[..., None], xin, 0).to(dt)
    g = torch.bmm(xin, params["w_gate"].to(dt))
    u = torch.bmm(xin, params["w_up"].to(dt))
    out = torch.bmm(F.silu(g) * u, params["w_down"].to(dt))
    out = out * (wtab * vtab)[..., None].to(dt)

    # combine: f32 scatter-add back to the tokens
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device).index_add(
        0, table.reshape(-1), out.reshape(-1, d).float())
    return y, aux


def _local_moe(x: torch.Tensor, params, cfg, dropless: bool, ep=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d) -> (y (T, d) in x's dtype, aux scalar f32): the body on
    this rank's experts (all of them without `ep`, an ``ExpertShard``),
    on each of the reference's token shards of x where they divide it
    (``ep.token_shards``, their aux losses averaged, as its ``pmean``),
    its partial outputs summed over the model ranks and its aux averaged
    over the data ranks."""
    first_e = 0 if ep is None else ep.index * params["w_gate"].shape[0]
    n = 1 if ep is None or x.shape[0] % ep.token_shards else ep.token_shards
    parts = [partial_moe(c, params, cfg, dropless, first_e)
             for c in x.chunk(n)]
    y, aux = (parts[0] if n == 1 else
              (torch.cat([p[0] for p in parts]),
               torch.stack([p[1] for p in parts]).mean()))
    if ep is not None and ep.group is not None:
        y = AllReduce.apply(y, ep.group)
    if ep is not None and ep.data is not None:
        aux = AllReduce.apply(aux, ep.data) / ep.data.world
    return y.to(x.dtype), aux


def moe_block(params, cfg, x: torch.Tensor, dropless: bool = False,
              ep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d), or (B, d) for a decode step -> (y of x's shape,
    aux_loss scalar), over this rank's T = B·S tokens.  ``dropless``
    sets C = T (decode); `ep` places the block on a process mesh (see
    the module docstring)."""
    y, aux = _local_moe(x.reshape(-1, x.shape[-1]), params, cfg, dropless,
                        ep)
    return y.reshape(x.shape), aux
