"""Decoder LM: training forward and loss, prefill and decode over a
stacked-layer param tree.

Port of the JAX package's ``models/lm.py`` for every decoder-only
pattern of the zoo: dense attention (qwen1.5, phi3, deepseek),
sliding-window attention (``"swa"``, h2o-danube), pure Mamba (mamba2),
the Mamba/attention hybrid (jamba), MoE FFNs with Qwen3's q/k-norm
(qwen3-moe) and the VLM (qwen2-vl: M-RoPE over positions (3, B, S),
and ``vision_embeds`` (B, P, d) in place of the first P token
embeddings; decode puts the cache index in all three components, as the
reference does).  Param specs keep the reference's paths
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
reference scans; with ``remat`` each super-block (one pass over the
layer pattern: one layer for a pattern of length 1, jamba's 8) is
recomputed in the backward (``torch.utils.checkpoint``), carrying the
MoE aux beside x so the aux's gradient flows, as the reference
rematerialises each super-block.
Inside a ``layers.gathering(gather)`` block (the trainer's and server's
across ranks) the params are a rank's blocks: each call gathers the
top-level leaves (embedding, final norm, an untied head) once and each
layer's params where it reads them -- a training super-block inside its
remat unit, so the backward's recompute gathers again and a layer's
whole copy dies with its super-block; a prefill or decode layer in its
loop.  With ``CAST_PARAMS_ONCE`` the cast comes after the gather.  The
gather also places each MoE block across the ranks
(``layers.expert_shard``): a rank computes its own experts, gathered
over the data axes alone, and sums the partial outputs over the model
ranks (``models/moe.py``); and the dense layers
(``layers.tensor_shard``): where the policy's ``tp`` axes cut them, a
rank computes its own query heads (and key heads, or those its query
heads pair with), ``d_ff`` columns and vocab rows, and each attention
and MLP output is summed over those ranks in f32 (``layers.row_sum``),
its embedding lookup too; its logits are its vocab block, and the loss
reduces over the ranks (``layers._xent_nll``).  A serving rank's cache
then holds its key heads alone.  The Mamba mixer is computed whole.
The collectives run in the layer order on every rank of a block, the
attention's before the MoE's, and a remat's recompute issues them again
in that order.
Encoder-decoder configs (whisper) are ``models.encdec.EncDecLM``;
``models.encdec.build_model`` picks the class from the config.

``use_kernels`` routes training and prefill attention through the
flash-attention kernel (with the window of an SWA layer), their SSD scan
through the SSD-scan kernel, and the block, final and gated norms and
Qwen3's q/k-norm (one row per token and head) through the RMSNorm kernel
(``repro_torch.kernels.ops``, differentiable: kernel forward, oracle
backward); those compute the same functions as the plain layers (the
reference computes the q/k-norm outside any kernel).  Decode attention
reads the whole cache for one query per sequence, and the decode SSM step
is one recurrence step: both stay plain ``torch`` math, as in the
reference; so do the MoE router and experts.

Unlike the reference, ``decode_step`` writes the new K/V, SSM state and
conv tails into the cache in place (no second cache per token) and
returns the same cache object.
"""
from __future__ import annotations

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
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.name} is an encoder-decoder config: "
                             f"build it with models.encdec.build_model")
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

    def param_axes(self) -> PyTree:
        """Logical axes per param (``repro_torch.sharding`` lays them
        over a mesh; the model itself holds no mesh or policy)."""
        return L.axes_tree(self._specs)

    # ---------------- embedding / head ----------------
    def _norm(self, params, x):
        return L.rmsnorm(params, x, self.cfg.norm_eps, self.use_kernels)

    def _embed(self, params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
        return L.embed(params["embed"]["tok"], tokens, L.cut(tp, "vocab"),
                       self.compute_dtype)

    def _embed_batch(self, params, batch, tp=None) -> torch.Tensor:
        """The token embeddings, the first P positions replaced by the
        batch's ``vision_embeds`` (B, P, d) when it has them."""
        x = self._embed(params, batch["tokens"], tp)
        ve = batch.get("vision_embeds")
        if ve is None:
            return x
        P, S = ve.shape[1], x.shape[1]
        if P > S:
            raise ValueError(f"{P} vision embeddings do not fit in a "
                             f"sequence of {S} tokens")
        return torch.cat([ve.to(self.compute_dtype), x[:, P:]], dim=1)

    def _ffn(self, lp, x, dropless: bool = False, ep=None, tp=None):
        """x + the layer's FFN, and the MoE aux (None without MoE); `ep`
        places the MoE block across ranks (``sharding.policy.
        ExpertShard``, from the call's gather), `tp` the MLP
        (``TensorShard``)."""
        if "moe" in lp:
            f, aux = MOE.moe_block(lp["moe"], self.cfg,
                                   self._norm(lp["pre_mlp_norm"], x),
                                   dropless=dropless, ep=ep)
            return x + f, aux
        if "mlp" in lp:
            split = L.cut(tp, "d_ff")
            h = L.column_input(self._norm(lp["pre_mlp_norm"], x), split, 2)
            return x + L.row_sum(L.mlp(lp["mlp"], h), split), None
        return x, None                      # pure-SSM archs: no FFN

    def _layers(self, params) -> Dict[str, List[PyTree]]:
        """pos{j} -> the params of each of its stacked layers."""
        return {f"pos{j}": _unstack(params["blocks"][f"pos{j}"], self._n_sb)
                for j in range(self._P)}

    def _positions(self, batch) -> torch.Tensor:
        """The batch's positions as given, else (B, S) of arange, or
        (3, B, S) of it for M-RoPE."""
        pos = batch.get("positions")
        if pos is not None:
            return pos
        B, S = batch["tokens"].shape
        base = torch.arange(S, dtype=torch.int32,
                            device=batch["tokens"].device).expand(B, S)
        return base.expand(3, B, S) if self.cfg.mrope else base

    # ---------------- forward / loss (training) ----------------
    def _block(self, lp, j: int, x, positions, ep=None, tp=None):
        """One layer: (x, its MoE aux or None)."""
        h = self._norm(lp["pre_mixer_norm"], x)
        if self.cfg.layer_kind(j) in ATTN_KINDS:
            o = self._attn(lp, j, h, positions, expand_gqa=True, tp=tp)[0]
        else:
            o = M.mamba_block(lp["mamba"], self.cfg, h, self.use_kernels)
        return self._ffn(lp, x + o, ep=ep, tp=tp)

    def _superblock(self, lps, x, aux, positions, g=L.no_gather, ep=None,
                    tp=None):
        """One pass over the pattern (layers ``lps``, one per position,
        each gathered by `g` first): (x, aux plus each MoE layer's aux,
        in layer order)."""
        lps = [g(lp, "blocks", f"pos{j}") for j, lp in enumerate(lps)]
        for j, lp in enumerate(lps):
            x, a = self._block(lp, j, x, positions, ep, tp)
            if a is not None:
                aux = aux + a
        return x, aux

    def _top(self, params, g):
        """The top-level leaves (embedding, final norm, an untied head),
        gathered by `g` once a call: the tied embedding's two reads then
        sum their grads on the whole tensor."""
        return {k: g(v, k) for k, v in params.items() if k != "blocks"}

    def _forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, the MoE aux summed over layers, f32).  With remat
        each super-block (one pass over the layer pattern) is recomputed
        in the backward, the reference's ``jax.checkpoint`` unit, and
        gathers its layers again there.  Without remat the backward
        saves every gathered layer: correct, but no memory saved."""
        gather = L.current_gather()
        ep, tp = L.expert_shard(gather), L.tensor_shard(gather)
        if gather is None:
            params, g = (L.maybe_cast_params(params, self.compute_dtype),
                         L.no_gather)
        else:
            def g(tree, *path):
                # gather f32, then cast
                return L.maybe_cast_params(gather(tree, *path),
                                           self.compute_dtype)
        top = self._top(params, g)
        x = self._embed_batch(top, batch, tp)
        positions = self._positions(batch)
        layers = self._layers(params)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self._n_sb):
            lps = [layers[f"pos{j}"][i] for j in range(self._P)]
            if self.remat:
                x, aux = checkpoint(self._superblock, lps, x, aux,
                                    positions, g, ep, tp,
                                    use_reentrant=False)
            else:
                x, aux = self._superblock(lps, x, aux, positions, g, ep, tp)
        x = self._norm(top["final_norm"], x)
        return L.head(top, x, self.cfg, L.cut(tp, "vocab")), aux

    def forward(self, params, batch) -> torch.Tensor:
        """Logits (B, S, padded_vocab) in the compute dtype (a rank's
        vocab block where its gather cuts the vocab)."""
        return self._forward(params, batch)[0]

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The next-token loss (``layers.next_token_loss``) plus
        ``0.01 * aux``, aux the MoE layers' load-balance losses summed (0
        without MoE)."""
        logits, aux = self._forward(params, batch)
        loss, ntok = L.next_token_loss(
            logits, batch, L.cut(L.tensor_shard(L.current_gather()),
                                 "vocab"))
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

    def cache_axes(self) -> PyTree:
        """Logical axes per cache leaf, the structure of ``_cache``."""
        cfg = self.cfg
        out = {}
        for j in range(self._P):
            if cfg.layer_kind(j) in ATTN_KINDS:
                kv = ("layers", "batch", "cache_seq", "kv_heads", None)
                out[f"pos{j}"] = {"k": kv, "v": kv}
            else:
                out[f"pos{j}"] = {k: ("layers",) + v
                                  for k, v in M.MAMBA_CACHE_AXES.items()}
        return out

    # ---------------- prefill (build cache + logits) ----------------
    @torch.no_grad()
    def prefill(self, params, batch) -> Tuple[torch.Tensor, PyTree]:
        """Forward over a prompt, returning last-position logits (B, V)
        and the populated KV/SSM cache (KV length == prompt length; an
        SWA layer keeps its last `window` positions, position p at slot
        ``p % window``)."""
        gather = L.current_gather()
        g, ep = gather or L.no_gather, L.expert_shard(gather)
        tp = L.tensor_shard(gather)
        top = self._top(params, g)
        x = self._embed_batch(top, batch, tp)
        positions = self._positions(batch)
        layers = self._layers(params)
        caches: Dict[str, Dict[str, list]] = {
            f"pos{j}": {} for j in range(self._P)}
        for i in range(self._n_sb):
            for j in range(self._P):
                # the gathered layer lives for this call only
                x, nc = self._prefill_layer(
                    g(layers[f"pos{j}"][i], "blocks", f"pos{j}"), j, x,
                    positions, ep, tp)
                for k, t in nc.items():
                    caches[f"pos{j}"].setdefault(k, []).append(t)
        x = self._norm(top["final_norm"], x[:, -1:, :].contiguous())
        logits = L.head(top, x, self.cfg, L.cut(tp, "vocab"))[:, 0, :]
        cache = {p: {k: torch.stack(ts) for k, ts in leaves.items()}
                 for p, leaves in caches.items()}
        return logits, cache

    def _prefill_layer(self, lp, j: int, x, positions, ep=None, tp=None):
        """One prefill layer: (x, its cache leaves)."""
        h = self._norm(lp["pre_mixer_norm"], x)
        if self.cfg.layer_kind(j) in ATTN_KINDS:
            o, nc = self._attn(lp, j, h, positions, tp=tp)
            window = self._window(j)
            S = nc["k"].shape[1]
            if window and window < S:
                # ring-buffer alignment: position p at slot p % window
                nc = {n: torch.roll(t[:, -window:], S % window, 1)
                      for n, t in nc.items()}
        else:
            o, hfin, nc = M.mamba_prefill(lp["mamba"], self.cfg, h,
                                          self.use_kernels)
            nc = {"h": hfin, **nc}
        return self._ffn(lp, x + o, ep=ep, tp=tp)[0], nc

    def _window(self, j: int) -> int:
        """The attention window of pattern position j (0: none)."""
        return self.cfg.sliding_window if self.cfg.layer_kind(j) == "swa" \
            else 0

    def _attn(self, lp, j: int, h, positions, expand_gqa: bool = False,
              tp=None):
        """Causal self-attention over a sequence, windowed for an SWA
        layer: (out, {k, v}).  `expand_gqa`: the training forward, where
        the reference applies ``GQA_EXPAND``.  Over a heads split (`tp`)
        the rank's heads, its output summed over the ranks."""
        split = L.cut(tp, "heads")
        o, kv = self._attn_partial(lp, j, L.column_input(h, split, 3),
                                   positions, expand_gqa, tp)
        return L.row_sum(o, split), kv

    def _attn_partial(self, lp, j: int, h, positions,
                      expand_gqa: bool = False, tp=None):
        """:meth:`_attn` before the sum over the ranks: the rank's heads
        (all of them without a split) through ``wo``, and its {k, v}.
        `h` is (B, S, d), or the q, k and v views of it that
        ``layers.column_input`` gives.  One process emulating the ranks of
        a split (``sharding.policy.rank_view``) sums these outputs."""
        x = h[0] if isinstance(h, tuple) else h
        q, k, v = L._qkv(lp["attn"], self.cfg, h, positions,
                         use_kernels=self.use_kernels)
        ka, va = L.kv_for_heads(k, v, self.cfg, tp)
        if expand_gqa:
            ka, va = L.maybe_expand_gqa(q, ka, va)
        o = L.attention(q, ka, va, causal=True, window=self._window(j),
                        use_kernels=self.use_kernels)
        o = o.reshape(*x.shape[:2], -1) @ lp["attn"]["wo"].to(x.dtype)
        return o, {"k": k, "v": v}

    # ---------------- decode ----------------
    def _decode_attn(self, lp, j: int, x, k_cache, v_cache, pos: int,
                     tp=None):
        """x (B, d); k/v_cache (B, S_c, KV, hd), updated in place at pos,
        or at slot ``pos % S_c`` of an SWA layer's ring (a rank's key
        heads over a ``kv_heads`` split)."""
        cfg = self.cfg
        B = x.shape[0]
        S_c = k_cache.shape[1]
        ring = bool(self._window(j))
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        if cfg.mrope:        # the cache index in all three components
            posv = posv.expand(3, B, 1)
        q, k_new, v_new = L._qkv(lp["attn"], cfg, x[:, None, :], posv,
                                 use_kernels=self.use_kernels)
        slot = pos % S_c if ring else pos
        k_cache[:, slot] = k_new[:, 0]
        v_cache[:, slot] = v_new[:, 0]

        idx = torch.arange(S_c, device=x.device)
        valid = idx < min(pos + 1, S_c) if ring else idx <= pos
        o = L.decode_attention(q, *L.kv_for_heads(k_cache, v_cache, cfg, tp),
                               valid)
        return L.row_sum(o @ lp["attn"]["wo"].to(x.dtype),
                         L.cut(tp, "heads"))

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
        gather = L.current_gather()
        g, ep = gather or L.no_gather, L.expert_shard(gather)
        tp = L.tensor_shard(gather)
        top = self._top(params, g)
        x = self._embed(top, tokens, tp)                     # (B, d)
        layers = self._layers(params)
        caches = {p: _unstack(c, self._n_sb) for p, c in cache.items()}
        for i in range(self._n_sb):
            for j in range(self._P):
                x = self._decode_layer(
                    g(layers[f"pos{j}"][i], "blocks", f"pos{j}"), j, x,
                    caches[f"pos{j}"][i], pos, ep, tp)
        x = self._norm(top["final_norm"], x)
        return L.head(top, x, self.cfg, L.cut(tp, "vocab")), cache

    def _decode_layer(self, lp, j: int, x, lc, pos: int, ep=None, tp=None):
        """One decode layer against its cache `lc`, written in place."""
        h = self._norm(lp["pre_mixer_norm"], x)
        if self.cfg.layer_kind(j) in ATTN_KINDS:
            o = self._decode_attn(lp, j, h, lc["k"], lc["v"], pos, tp)
        else:
            o = M.mamba_decode(lp["mamba"], self.cfg, h, lc,
                               self.use_kernels)
        return self._ffn(lp, x + o, dropless=True, ep=ep, tp=tp)[0]
