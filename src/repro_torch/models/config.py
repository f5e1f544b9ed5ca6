"""Unified architecture configuration.

One dataclass covers every assigned family: dense/GQA transformers, SWA,
MoE, SSM (Mamba2/SSD), hybrid (Jamba), encoder-decoder (Whisper) and VLM
backbones (Qwen2-VL).  A layer *pattern* (cycled over ``num_layers``)
selects the mixer per layer ("attn" | "swa" | "mamba"), and a MoE period
selects which layers use expert FFNs.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | audio | ssm | moe | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                        # dense-MLP width (0 = no dense MLP)
    vocab_size: int

    # --- attention ---
    layer_pattern: Tuple[str, ...] = ("attn",)   # cycled; "attn"|"swa"|"mamba"
    sliding_window: int = 0          # window size for "swa" layers
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False              # multimodal 3-component RoPE (Qwen2-VL)
    qk_norm: bool = False            # Qwen3-style per-head q/k RMSNorm

    # --- MoE ---
    moe_num_experts: int = 0         # 0 = dense everywhere
    moe_top_k: int = 0
    moe_d_ff: int = 0                # expert FFN width
    moe_layer_period: int = 1        # layer i is MoE iff i % period == period-1
    moe_capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0               # N (state size per head)
    ssm_headdim: int = 64            # P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 128             # SSD chunk length

    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0          # >0 => enc-dec; num_layers = decoder layers
    num_audio_frames: int = 1500     # post-conv frames the stub frontend emits

    # --- VLM stub ---
    vision_stub: bool = False
    num_patches: int = 1024          # patch embeddings the stub frontend emits

    # --- numerics ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256    # pad vocab for TP divisibility + MXU tiles

    # ----------------------------------------------------------------- utils
    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        p = self.moe_layer_period
        return i % p == p - 1

    @property
    def attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if every mixer layer is sub-quadratic in sequence length."""
        return all(k in ("mamba", "swa") for k in self.layer_pattern)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so the TP axis divides it and lm-head matmul
        dims stay 128-aligned (e.g. mamba2 50280 → 50432).  Padded logit
        columns are masked to -inf in the head."""
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # ------------------------------------------------------------- counting
    def layer_kinds(self):
        return [self.layer_kind(i) for i in range(self.num_layers)]

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embedding
        if not self.tie_embeddings:
            total += v * d                 # lm head
        # encoder stack (whisper): attn + dense mlp per layer
        for _ in range(self.encoder_layers):
            total += self._attn_params(cross=False) + self._mlp_params(self.d_ff)
            total += 2 * d                 # norms
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "swa"):
                total += self._attn_params(cross=False)
            else:
                total += self._mamba_params()
            if self.encoder_layers and kind in ("attn", "swa"):
                total += self._attn_params(cross=True) + d
            if self.is_moe_layer(i):
                n_e = self.moe_top_k if active_only else self.moe_num_experts
                total += n_e * self._mlp_params(self.moe_d_ff)
                total += d * self.moe_num_experts   # router
            elif self.d_ff > 0:
                total += self._mlp_params(self.d_ff)
            total += 2 * d                 # pre-norms
        total += d                         # final norm
        return total

    def _attn_params(self, cross: bool) -> int:
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        q = d * h * hd
        k = d * kv * hd
        vproj = d * kv * hd
        o = h * hd * d
        bias = (h * hd + 2 * kv * hd) if self.qkv_bias else 0
        return q + k + vproj + o + bias

    def _mlp_params(self, width: int) -> int:
        # SwiGLU: gate + up + down
        return 3 * self.d_model * width

    def _mamba_params(self) -> int:
        d, di, n, p = self.d_model, self.d_inner, self.ssm_state, self.ssm_headdim
        nh = self.ssm_nheads
        in_proj = d * (2 * di + 2 * n + nh)   # x, z, B, C, dt
        conv = self.ssm_conv_width * (di + 2 * n)
        out_proj = di * d
        extra = nh * 2 + di                    # A_log, D, norm
        return in_proj + conv + out_proj + extra

    def flops_per_token(self, seq_len: int, active_only: bool = True) -> float:
        """~6 * N_active per token for training fwd+bwd, plus attention term."""
        n = self.param_count(active_only=active_only)
        flops = 6.0 * n
        # attention score/value FLOPs: 12 * h * hd * window per token (fwd+bwd)
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                w = seq_len
            elif kind == "swa":
                w = min(seq_len, self.sliding_window)
            else:
                continue
            flops += 12.0 * self.num_heads * self.head_dim * w / 2.0
        return flops


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    pat = cfg.layer_pattern
    small = dict(
        num_layers=max(2, len(pat)) if len(pat) > 1 else 2,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(2, cfg.num_kv_heads) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else cfg.head_dim,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        moe_num_experts=min(4, cfg.moe_num_experts),
        moe_top_k=min(2, cfg.moe_top_k),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        moe_capacity_factor=8.0,   # no-drop capacity => decode == forward

        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=8 if cfg.ssm_state else cfg.ssm_chunk,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_audio_frames=32,
        num_patches=16,
        name=cfg.name + "-smoke",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
