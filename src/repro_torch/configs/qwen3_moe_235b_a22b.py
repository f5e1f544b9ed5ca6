"""qwen3-moe-235b-a22b [moe] — Qwen3 family (same recipe as Qwen3-30B-A3B).

94L d_model=4096 64H (GQA kv=4, head_dim=128, q/k-norm) moe_d_ff=1536
vocab=151936, MoE 128 experts top-8 on every layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    layer_pattern=("attn",),
    qk_norm=True,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    moe_layer_period=1,
    rope_theta=1000000.0,
)
