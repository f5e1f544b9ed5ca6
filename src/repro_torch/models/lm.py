"""Decoder LM: training forward and loss, prefill and decode over a
stacked-layer param tree.

Port of the JAX package's ``models/lm.py`` for every decoder-only
pattern of the zoo: dense attention (qwen1.5, phi3, deepseek),
sliding-window attention (``"swa"``, h2o-danube), pure Mamba (mamba2),
the Mamba/attention hybrid (jamba) and MoE FFNs with Qwen3's q/k-norm
(qwen3-moe).  Param specs keep the reference's paths
(``blocks/pos0/attn/wq``, ``blocks/pos1/moe/w_gate``,
``blocks/pos0/mamba/w_x``, with a leading stacked-layer dim: a pattern of
length P stacks ``num_layers / P`` layers per ``pos{j}``); ``forward`` and
``loss`` (full-length next-token cross-entropy plus 0.01 x the MoE aux
loss summed over layers), ``prefill``, ``decode_step`` and the cache per
layer kind: ``pos{j}/{k,v}`` of (L, B, S, KV, hd) for attention, where an
SWA layer's S is ``min(max_seq, window)`` and is a ring (position p at
slot ``p % S``), and ``pos{j}/{h,conv_x,conv_B,conv_C}`` for Mamba (h
(L, B, nh, P, N) in f32, the conv tails (L, B, W-1, ·) in the compute
dtype).  Layers run as a Python loop over the stacked dim where the
reference scans; with ``remat`` each layer is recomputed in the backward
(``torch.utils.checkpoint``), returning its MoE aux beside x so the aux's
gradient flows, as the reference rematerialises each super-block.
Encoder-decoder (whisper) and VLM (qwen2-vl: M-RoPE, vision embeddings)
configs are not ported.

``use_kernels`` routes training and prefill attention through the
flash-attention kernel (with the window of an SWA layer), their SSD scan
through the SSD-scan kernel, and the block, final and gated norms through
the RMSNorm kernel (``repro_torch.kernels.ops``, differentiable: kernel
forward, oracle backward); those compute the same functions as the plain
layers.  Decode attention reads the whole cache for one query per
sequence, and the decode SSM step is one recurrence step: both stay plain
``torch`` math, as in the reference; so do the MoE router and experts and
the q/k-norm, which the reference computes outside any kernel.

Unlike the reference, ``decode_step`` writes the new K/V, SSM state and
conv tails into the cache in place (no second cache per token) and
returns the same cache object.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig

PyTree = Any
ATTN_KINDS = ("attn", "swa")


# ======================================================================
# specs
# ======================================================================
def _layer_specs(cfg: ModelConfig, pos: int) -> Dict[str, Any]:
    # pre_mlp_norm is declared even without an FFN, as in the reference,
    # so images of both packages name the same entries
    s: Dict[str, Any] = {
        "pre_mixer_norm": L.rmsnorm_spec(cfg.d_model),
        "pre_mlp_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if cfg.layer_kind(pos) in ATTN_KINDS:
        s["attn"] = L.attention_specs(cfg)
    else:
        s["mamba"] = M.mamba_specs(cfg)
    if cfg.is_moe_layer(pos):
        s["moe"] = MOE.moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
    return s


def lm_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    P = len(cfg.layer_pattern)
    if cfg.num_layers % P:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of "
                         f"the pattern length {P}")
    n_sb = cfg.num_layers // P
    specs: Dict[str, Any] = {
        "embed": {"tok": L.ParamSpec((cfg.padded_vocab, cfg.d_model),
                                     ("vocab", "d_model"), scale=0.02)},
        "blocks": {f"pos{j}": L.stack_specs(_layer_specs(cfg, j), n_sb)
                   for j in range(P)},
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.ParamSpec((cfg.d_model, cfg.padded_vocab),
                                       ("d_model", "vocab"))
    return specs


def check_supported(cfg: ModelConfig) -> None:
    """The port covers every decoder-only config; encoder-decoder and VLM
    configs are not ported yet."""
    if cfg.encoder_layers or cfg.mrope or cfg.vision_stub:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM configs (encoder layers, "
            f"M-RoPE, vision embeddings) are not ported yet")


def _unstack(tree: PyTree, n: int) -> List[PyTree]:
    """Every layer of a stacked tree (views), by one ``unbind`` per leaf:
    its backward stacks the n layers' grads once, where indexing each
    layer would add n full-size zero-padded grads."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


# ======================================================================
# model
# ======================================================================
class LM:
    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32, remat: bool = True,
                 use_kernels: bool = False, device: DeviceLike = None):
        check_supported(cfg)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.remat = remat
        self.use_kernels = use_kernels
        self.device = resolve_device(device)
        self._specs = lm_param_specs(cfg)
        self._P = len(cfg.layer_pattern)
        self._n_sb = cfg.num_layers // self._P

    # ---------------- params ----------------
    def init(self, seed: int = 0) -> PyTree:
        return L.init_params(self._specs, seed, self.param_dtype, self.device)

    def init_abstract(self) -> PyTree:
        return L.abstract_params(self._specs, self.param_dtype)

    # ---------------- embedding / head ----------------
    def _norm(self, params, x):
        return L.rmsnorm(params, x, self.cfg.norm_eps, self.use_kernels)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        # gather, then cast: the same values as casting the whole table
        return params["embed"]["tok"][tokens].to(self.compute_dtype)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            w = params["embed"]["tok"].to(x.dtype).T
        else:
            w = params["lm_head"].to(x.dtype)
        return L.mask_padded_vocab(x @ w, self.cfg)

    def _ffn(self, lp, x, dropless: bool = False):
        """x + the layer's FFN, and the MoE aux (None without MoE)."""
        if "moe" in lp:
            f, aux = MOE.moe_block(lp["moe"], self.cfg,
                                   self._norm(lp["pre_mlp_norm"], x),
                                   dropless=dropless)
            return x + f, aux
        if "mlp" in lp:
            return x + L.mlp(lp["mlp"], self._norm(lp["pre_mlp_norm"], x)), \
                None
        return x, None                      # pure-SSM archs: no FFN

    def _layers(self, params) -> Dict[str, List[PyTree]]:
        """pos{j} -> the params of each of its stacked layers."""
        return {f"pos{j}": _unstack(params["blocks"][f"pos{j}"], self._n_sb)
                for j in range(self._P)}

    def _positions(self, batch) -> torch.Tensor:
        pos = batch.get("positions")
        if pos is not None:
            return pos
        B, S = batch["tokens"].shape
        return torch.arange(S, dtype=torch.int32,
                            device=batch["tokens"].device).expand(B, S)

    # ---------------- forward / loss (training) ----------------
    def _block(self, lp, j: int, x, positions):
        """One layer: (x, its MoE aux or None)."""
        h = self._norm(lp["pre_mixer_norm"], x)
        if self.cfg.layer_kind(j) in ATTN_KINDS:
            o = self._attn(lp, j, h, positions)[0]
        else:
            o = M.mamba_block(lp["mamba"], self.cfg, h, self.use_kernels)
        return self._ffn(lp, x + o)

    def _forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, the MoE aux summed over layers, f32)."""
        x = self._embed(params, batch["tokens"])
        positions = self._positions(batch)
        layers = self._layers(params)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self._n_sb):
            for j in range(self._P):
                lp = layers[f"pos{j}"][i]
                if self.remat:
                    x, a = checkpoint(self._block, lp, j, x, positions,
                                      use_reentrant=False)
                else:
                    x, a = self._block(lp, j, x, positions)
                if a is not None:
                    aux = aux + a
        x = self._norm(params["final_norm"], x)
        return self._head(params, x), aux

    def forward(self, params, batch) -> torch.Tensor:
        """Logits (B, S, padded_vocab) in the compute dtype."""
        return self._forward(params, batch)[0]

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Full-length next-token loss: targets are the tokens rolled by
        one, the last position masked (S stays whole, as in the
        reference).  ``total = loss + 0.01 * aux``, aux the MoE layers'
        load-balance losses summed (0 without MoE)."""
        logits, aux = self._forward(params, batch)
        tokens = batch["tokens"]
        targets = torch.roll(tokens, -1, dims=1)
        mask = batch.get("loss_mask")
        mask = (torch.ones(tokens.shape, dtype=torch.float32,
                           device=tokens.device) if mask is None
                else mask.float().clone())
        mask[:, -1] = 0.0
        loss, ntok = L.softmax_xent_sharded(logits, targets, mask)
        total = loss + 0.01 * aux
        return total, {"loss": loss, "aux_loss": aux, "ntokens": ntok}

    # ---------------- KV / SSM cache ----------------
    def _cache(self, batch: int, max_seq: int, device) -> PyTree:
        cfg = self.cfg
        out = {}
        for j in range(self._P):
            kind = cfg.layer_kind(j)
            if kind in ATTN_KINDS:
                # an SWA layer keeps a ring of its window's positions
                S = (min(max_seq, cfg.sliding_window) if kind == "swa"
                     else max_seq)
                shp = (batch, S, cfg.num_kv_heads, cfg.head_dim)
                leaf = {k: torch.empty(shp, dtype=self.compute_dtype,
                                       device="meta") for k in ("k", "v")}
            else:
                leaf = M.mamba_cache_init(cfg, batch, self.compute_dtype,
                                          "meta")
            out[f"pos{j}"] = {
                k: torch.zeros((self._n_sb,) + t.shape, dtype=t.dtype,
                               device=device)
                for k, t in leaf.items()}
        return out

    def init_cache(self, batch: int, max_seq: int) -> PyTree:
        return self._cache(batch, max_seq, self.device)

    def cache_abstract(self, batch: int, max_seq: int) -> PyTree:
        return self._cache(batch, max_seq, "meta")

    # ---------------- prefill (build cache + logits) ----------------
    @torch.no_grad()
    def prefill(self, params, batch) -> Tuple[torch.Tensor, PyTree]:
        """Forward over a prompt, returning last-position logits (B, V)
        and the populated KV/SSM cache (KV length == prompt length; an
        SWA layer keeps its last `window` positions, position p at slot
        ``p % window``)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        positions = self._positions(batch)
        layers = self._layers(params)
        caches: Dict[str, Dict[str, list]] = {
            f"pos{j}": {} for j in range(self._P)}
        for i in range(self._n_sb):
            for j in range(self._P):
                lp = layers[f"pos{j}"][i]
                h = self._norm(lp["pre_mixer_norm"], x)
                if cfg.layer_kind(j) in ATTN_KINDS:
                    o, nc = self._attn(lp, j, h, positions)
                    window = self._window(j)
                    S = nc["k"].shape[1]
                    if window and window < S:
                        # ring-buffer alignment: position p at slot p % window
                        nc = {n: torch.roll(t[:, -window:], S % window, 1)
                              for n, t in nc.items()}
                else:
                    o, hfin, nc = M.mamba_prefill(lp["mamba"], cfg, h,
                                                  self.use_kernels)
                    nc = {"h": hfin, **nc}
                x = self._ffn(lp, x + o)[0]
                for k, t in nc.items():
                    caches[f"pos{j}"].setdefault(k, []).append(t)
        x = self._norm(params["final_norm"], x[:, -1:, :].contiguous())
        logits = self._head(params, x)[:, 0, :]
        cache = {p: {k: torch.stack(ts) for k, ts in leaves.items()}
                 for p, leaves in caches.items()}
        return logits, cache

    def _window(self, j: int) -> int:
        """The attention window of pattern position j (0: none)."""
        return self.cfg.sliding_window if self.cfg.layer_kind(j) == "swa" \
            else 0

    def _attn(self, lp, j: int, h, positions):
        """Causal self-attention over a sequence, windowed for an SWA
        layer: (out, {k, v})."""
        cfg = self.cfg
        B, S = h.shape[:2]
        window = self._window(j)
        q, k, v = L._qkv(lp["attn"], cfg, h, positions)
        if self.use_kernels:
            from repro_torch.kernels import ops
            o = ops.attention(q, k, v, causal=True, window=window)
        else:
            o = L.self_attention(q, k, v, causal=True, window=window)
        o = o.reshape(B, S, cfg.num_heads * cfg.head_dim)
        return o @ lp["attn"]["wo"].to(h.dtype), {"k": k, "v": v}

    # ---------------- decode ----------------
    def _decode_attn(self, lp, j: int, x, k_cache, v_cache, pos: int):
        """x (B, d); k/v_cache (B, S_c, KV, hd), updated in place at pos,
        or at slot ``pos % S_c`` of an SWA layer's ring."""
        cfg = self.cfg
        B = x.shape[0]
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        S_c = k_cache.shape[1]
        ring = bool(self._window(j))
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q, k_new, v_new = L._qkv(lp["attn"], cfg, x[:, None, :], posv)
        slot = pos % S_c if ring else pos
        k_cache[:, slot] = k_new[:, 0]
        v_cache[:, slot] = v_new[:, 0]

        qg = q.reshape(B, 1, KV, H // KV, hd)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_cache) / math.sqrt(hd)
        scores = scores.float()
        idx = torch.arange(S_c, device=x.device)
        valid = idx < min(pos + 1, S_c) if ring else idx <= pos
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        o = torch.einsum("bgrqk,bkgd->bqgrd", probs, v_cache)
        return o.reshape(B, H * hd) @ lp["attn"]["wo"].to(x.dtype)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One serving step: tokens (B,) int, pos the write position (it
        bounds only full attention caches: an SSM state has no length and
        an SWA ring no end)."""
        for j in range(self._P):
            if self.cfg.layer_kind(j) == "attn":
                S_c = cache[f"pos{j}"]["k"].shape[2]
                if not 0 <= pos < S_c:
                    raise ValueError(f"decode position {pos} outside the "
                                     f"cache (length {S_c})")
        x = self._embed(params, tokens)                      # (B, d)
        layers = self._layers(params)
        caches = {p: _unstack(c, self._n_sb) for p, c in cache.items()}
        for i in range(self._n_sb):
            for j in range(self._P):
                lp = layers[f"pos{j}"][i]
                lc = caches[f"pos{j}"][i]
                h = self._norm(lp["pre_mixer_norm"], x)
                if self.cfg.layer_kind(j) in ATTN_KINDS:
                    o = self._decode_attn(lp, j, h, lc["k"], lc["v"], pos)
                else:
                    o = M.mamba_decode(lp["mamba"], self.cfg, h, lc,
                                       self.use_kernels)
                x = self._ffn(lp, x + o, dropless=True)[0]   # MoE: no drops
        x = self._norm(params["final_norm"], x)
        return self._head(params, x), cache
