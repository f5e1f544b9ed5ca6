"""Encoder-decoder model (whisper's backbone), in PyTorch.

Port of the JAX package's ``models/encdec.py``.  The audio conv frontend
is a stub, as in the reference: the batch gives post-conv frame
embeddings ``frames`` (B, F, d).  The encoder is non-causal
self-attention; the decoder a causal LM with cross-attention into the
encoder's output.  As in the reference, both self-attentions take RoPE
(the encoder at positions ``arange(F)``), the cross-attention none, and
the MLPs are SwiGLU.

Param paths are the reference's (``embed/tok``,
``enc_blocks/{pre_attn_norm,pre_mlp_norm,attn,mlp}``,
``dec_blocks/{pre_self_norm,pre_cross_norm,pre_mlp_norm,self_attn,
cross_attn,mlp}``, ``enc_final_norm``, ``final_norm``; the head tied to
the embedding unless the config unties it), so numpy params and images
cross between the packages.  The cache is ``{self_k, self_v}`` (L, B,
max_seq, KV, hd) and ``{cross_k, cross_v}`` (L, B, F, KV, hd): the
encoder's K/V per decoder layer, written once by ``prefill`` and only
read by decode.

``use_kernels`` routes the encoder's attention, the decoder's causal
self-attention and its cross-attention at training and prefill through
the flash-attention kernel, and every norm through the RMSNorm kernel
(``repro_torch.kernels.ops``).  Decode attention, the cross-attention
included, stays plain torch, as in the reference.  Like ``LM``,
``decode_step`` writes the new K/V into the cache in place, and inside a
``layers.gathering`` block each call gathers the top-level leaves once
and each encoder or decoder layer where it reads it (in training inside
its remat unit).  Where the gather's ``layers.tensor_shard`` cuts them,
a rank computes its own heads of the encoder's, the decoder's and the
cross-attention, its ``d_ff`` columns and vocab rows, as ``LM`` does:
each block's output is summed over those ranks, and the self and cross
caches hold the rank's key heads.

``build_model`` picks this class or ``LM`` from the config, as the
reference's does.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.devices import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, _unstack

PyTree = Any


def _enc_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "pre_attn_norm": L.rmsnorm_spec(cfg.d_model),
        "pre_mlp_norm": L.rmsnorm_spec(cfg.d_model),
        "attn": L.attention_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "pre_self_norm": L.rmsnorm_spec(cfg.d_model),
        "pre_cross_norm": L.rmsnorm_spec(cfg.d_model),
        "pre_mlp_norm": L.rmsnorm_spec(cfg.d_model),
        "self_attn": L.attention_specs(cfg),
        "cross_attn": L.attention_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def encdec_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "embed": {"tok": L.ParamSpec((cfg.padded_vocab, cfg.d_model),
                                     ("vocab", "d_model"), scale=0.02)},
        "enc_blocks": L.stack_specs(_enc_layer_specs(cfg),
                                    cfg.encoder_layers),
        "dec_blocks": L.stack_specs(_dec_layer_specs(cfg), cfg.num_layers),
        "enc_final_norm": L.rmsnorm_spec(cfg.d_model),
        "final_norm": L.rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.ParamSpec((cfg.d_model, cfg.padded_vocab),
                                       ("d_model", "vocab"))
    return specs


class EncDecLM:
    """The interface of ``LM``; the batch carries ``frames`` beside
    ``tokens`` (and optionally ``loss_mask``)."""

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 param_dtype=torch.float32, remat: bool = True,
                 use_kernels: bool = False, device: DeviceLike = None):
        if cfg.encoder_layers <= 0:
            raise ValueError(f"{cfg.name} has no encoder layers: build it "
                             f"as an LM")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.remat = remat
        self.use_kernels = use_kernels
        self.device = resolve_device(device)
        self._specs = encdec_param_specs(cfg)

    # ---------------- params ----------------
    def init(self, seed: int = 0) -> PyTree:
        return L.init_params(self._specs, seed, self.param_dtype, self.device)

    def init_abstract(self) -> PyTree:
        return L.abstract_params(self._specs, self.param_dtype)

    def param_axes(self) -> PyTree:
        return L.axes_tree(self._specs)

    # ---------------- pieces ----------------
    def _norm(self, params, x):
        return L.rmsnorm(params, x, self.cfg.norm_eps, self.use_kernels)

    def _embed(self, params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
        return L.embed(params["embed"]["tok"], tokens, L.cut(tp, "vocab"),
                       self.compute_dtype)

    def _remat(self, fn, *args):
        """fn(*args), recomputed in the backward with ``remat`` (one
        block each, as the reference's ``jax.checkpoint``)."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    @staticmethod
    def _arange(B: int, S: int, device) -> torch.Tensor:
        return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)

    # ---------------- encoder ----------------
    def _top(self, params, g):
        """The top-level leaves (embedding, both final norms, an untied
        head), gathered by `g` once a call."""
        return {k: g(v, k) for k, v in params.items()
                if k not in ("enc_blocks", "dec_blocks")}

    def _mixed(self, o, wo, tp):
        """The attention output `o` (B, S, heads, hd) through `wo`, summed
        over the ranks of a heads split."""
        o = o.reshape(*o.shape[:2], -1) @ wo.to(o.dtype)
        return L.row_sum(o, L.cut(tp, "heads"))

    def _enc_block(self, lp, x, pos, g=L.no_gather, tp=None):
        lp = g(lp, "enc_blocks")
        cfg = self.cfg
        h = L.column_input(self._norm(lp["pre_attn_norm"], x),
                           L.cut(tp, "heads"), 3)
        q, k, v = L._qkv(lp["attn"], cfg, h, pos)
        o = L.attention(q, *L.kv_for_heads(k, v, cfg, tp), causal=False,
                        use_kernels=self.use_kernels)
        x = x + self._mixed(o, lp["attn"]["wo"], tp)
        return x + self._mlp(lp, x, tp)

    def _mlp(self, lp, x, tp):
        """The block's MLP output, summed over a ``d_ff`` split."""
        split = L.cut(tp, "d_ff")
        h = L.column_input(self._norm(lp["pre_mlp_norm"], x), split, 2)
        return L.row_sum(L.mlp(lp["mlp"], h), split)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, F, d) -> the encoder's output (B, F, d), normed."""
        gather = L.current_gather()
        g = gather or L.no_gather
        return self._encode(params, self._top(params, g), frames, g,
                            L.tensor_shard(gather))

    def _encode(self, params, top, frames, g, tp=None):
        x = frames.to(self.compute_dtype)
        pos = self._arange(x.shape[0], x.shape[1], x.device)
        for lp in _unstack(params["enc_blocks"], self.cfg.encoder_layers):
            x = self._remat(self._enc_block, lp, x, pos, g, tp)
        return self._norm(top["enc_final_norm"], x)

    # ---------------- decoder ----------------
    def _dec_block(self, lp, x, enc_kv, pos, tp=None):
        """x (B,S,d); enc_kv = (k, v) (B,F,KV,hd) -> (x, (self k, self v))."""
        cfg = self.cfg
        B, S, _ = x.shape
        split = L.cut(tp, "heads")
        h = L.column_input(self._norm(lp["pre_self_norm"], x), split, 3)
        q, k, v = L._qkv(lp["self_attn"], cfg, h, pos)
        o = L.attention(q, *L.kv_for_heads(k, v, cfg, tp), causal=True,
                        use_kernels=self.use_kernels)
        x = x + self._mixed(o, lp["self_attn"]["wo"], tp)

        h = L.column_input(self._norm(lp["pre_cross_norm"], x), split)
        q = (h @ lp["cross_attn"]["wq"].to(x.dtype)
             ).reshape(B, S, -1, cfg.head_dim)
        o = L.attention(q, *L.kv_for_heads(*enc_kv, cfg, tp), causal=False,
                        use_kernels=self.use_kernels)
        x = x + self._mixed(o, lp["cross_attn"]["wo"], tp)
        return x + self._mlp(lp, x, tp), (k, v)

    def _cross_kv(self, lp, enc_out, tp=None):
        """The cross-attention's K/V (B, F, KV, hd) of one decoder layer
        (a rank's key heads over a ``kv_heads`` split)."""
        xk, xv = L.column_input(enc_out, L.cut(tp, "heads"), 2)
        B, F, _ = enc_out.shape
        dt = enc_out.dtype
        shape = (B, F, -1, self.cfg.head_dim)
        ek = (xk @ lp["cross_attn"]["wk"].to(dt)).reshape(shape)
        ev = (xv @ lp["cross_attn"]["wv"].to(dt)).reshape(shape)
        return ek, ev

    def _dec_layer(self, lp, x, enc_out, pos, g=L.no_gather, tp=None):
        lp = g(lp, "dec_blocks")
        return self._dec_block(lp, x, self._cross_kv(lp, enc_out, tp), pos,
                               tp)[0]

    def _decoder_input(self, params, top, batch, g, tp=None):
        """(the encoder's output, the token embeddings, their positions)."""
        enc_out = self._encode(params, top, batch["frames"], g, tp)
        tokens = batch["tokens"]
        pos = self._arange(*tokens.shape, tokens.device)
        return enc_out, self._embed(top, tokens, tp), pos

    def forward(self, params, batch) -> torch.Tensor:
        """Logits (B, S, padded_vocab) in the compute dtype (a rank's
        vocab block where its gather cuts the vocab).  Without remat the
        backward saves every gathered layer: correct, but no memory
        saved."""
        gather = L.current_gather()
        g, tp = gather or L.no_gather, L.tensor_shard(gather)
        top = self._top(params, g)
        enc_out, x, pos = self._decoder_input(params, top, batch, g, tp)
        for lp in _unstack(params["dec_blocks"], self.cfg.num_layers):
            x = self._remat(self._dec_layer, lp, x, enc_out, pos, g, tp)
        x = self._norm(top["final_norm"], x)
        return L.head(top, x, self.cfg, L.cut(tp, "vocab"))

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """The next-token loss (``layers.next_token_loss``); no aux loss."""
        loss, ntok = L.next_token_loss(
            self.forward(params, batch), batch,
            L.cut(L.tensor_shard(L.current_gather()), "vocab"))
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"loss": loss, "aux_loss": aux, "ntokens": ntok}

    # ---------------- serving ----------------
    def _cache(self, batch: int, max_seq: int, device) -> PyTree:
        cfg = self.cfg
        Ld, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        F = cfg.num_audio_frames

        def mk(S):
            return torch.zeros((Ld, batch, S, KV, hd),
                               dtype=self.compute_dtype, device=device)
        return {"self_k": mk(max_seq), "self_v": mk(max_seq),
                "cross_k": mk(F), "cross_v": mk(F)}

    def init_cache(self, batch: int, max_seq: int) -> PyTree:
        return self._cache(batch, max_seq, self.device)

    def cache_abstract(self, batch: int, max_seq: int) -> PyTree:
        return self._cache(batch, max_seq, "meta")

    def cache_axes(self) -> PyTree:
        ax = ("layers", "batch", "cache_seq", "kv_heads", None)
        fx = ("layers", "batch", "frames", "kv_heads", None)
        return {"self_k": ax, "self_v": ax, "cross_k": fx, "cross_v": fx}

    @torch.no_grad()
    def prefill(self, params, batch) -> Tuple[torch.Tensor, PyTree]:
        """Encode the frames and run the decoder over the prompt: the
        last position's logits (B, V) and the cache (self K/V of the
        prompt's length, cross K/V of every frame)."""
        gather = L.current_gather()
        g, tp = gather or L.no_gather, L.tensor_shard(gather)
        top = self._top(params, g)
        enc_out, x, pos = self._decoder_input(params, top, batch, g, tp)
        caches: Dict[str, list] = {k: [] for k in (
            "self_k", "self_v", "cross_k", "cross_v")}
        for lp in _unstack(params["dec_blocks"], self.cfg.num_layers):
            # the gathered layer lives for this call only
            x, kv = self._prefill_layer(g(lp, "dec_blocks"), x, enc_out,
                                        pos, tp)
            for name, t in zip(("self_k", "self_v", "cross_k", "cross_v"),
                               kv):
                caches[name].append(t)
        x = self._norm(top["final_norm"], x[:, -1:, :].contiguous())
        logits = L.head(top, x, self.cfg, L.cut(tp, "vocab"))[:, 0, :]
        return logits, {k: torch.stack(ts) for k, ts in caches.items()}

    def _prefill_layer(self, lp, x, enc_out, pos, tp=None):
        """One decoder layer over the prompt: (x, (self k, self v, cross
        k, cross v))."""
        ck, cv = self._cross_kv(lp, enc_out, tp)
        x, (sk, sv) = self._dec_block(lp, x, (ck, cv), pos, tp)
        return x, (sk, sv, ck, cv)

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One serving step: tokens (B,) int, pos the write position of
        the self cache (which bounds it)."""
        cfg = self.cfg
        S_c = cache["self_k"].shape[2]
        if not 0 <= pos < S_c:
            raise ValueError(f"decode position {pos} outside the cache "
                             f"(length {S_c})")
        gather = L.current_gather()
        g, tp = gather or L.no_gather, L.tensor_shard(gather)
        top = self._top(params, g)
        x = self._embed(top, tokens, tp)                     # (B, d)
        posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                          device=x.device)
        valid = torch.arange(S_c, device=x.device) <= pos
        layers = _unstack(params["dec_blocks"], cfg.num_layers)
        for lp, lc in zip(layers, _unstack(cache, cfg.num_layers)):
            x = self._decode_layer(g(lp, "dec_blocks"), lc, x, posv, valid,
                                   pos, tp)
        x = self._norm(top["final_norm"], x)
        return L.head(top, x, self.cfg, L.cut(tp, "vocab")), cache

    def _decode_layer(self, lp, lc, x, posv, valid, pos: int, tp=None):
        """One decoder layer against its cache `lc`, written in place."""
        cfg = self.cfg
        B = x.shape[0]
        h = self._norm(lp["pre_self_norm"], x)
        q, k_new, v_new = L._qkv(lp["self_attn"], cfg, h[:, None, :], posv)
        lc["self_k"][:, pos] = k_new[:, 0]
        lc["self_v"][:, pos] = v_new[:, 0]
        o = L.decode_attention(
            q, *L.kv_for_heads(lc["self_k"], lc["self_v"], cfg, tp), valid)
        x = x + L.row_sum(o @ lp["self_attn"]["wo"].to(x.dtype),
                          L.cut(tp, "heads"))

        h = self._norm(lp["pre_cross_norm"], x)
        q = (h @ lp["cross_attn"]["wq"].to(x.dtype)
             ).reshape(B, 1, -1, cfg.head_dim)
        o = L.self_attention(
            q, *L.kv_for_heads(lc["cross_k"], lc["cross_v"], cfg, tp),
            causal=False)
        x = x + L.row_sum(o.reshape(B, -1) @ lp["cross_attn"]["wo"].to(
            x.dtype), L.cut(tp, "heads"))

        return x + self._mlp(lp, x, tp)


def build_model(cfg: ModelConfig, **kw):
    """``EncDecLM`` for a config with encoder layers, else ``LM``; `kw` as
    either class takes them."""
    if cfg.encoder_layers > 0:
        return EncDecLM(cfg, **kw)
    return LM(cfg, **kw)
