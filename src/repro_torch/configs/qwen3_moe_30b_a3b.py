"""qwen3-moe-30b-a3b [moe] — hf:Qwen/Qwen3-30B-A3B.

48L d_model=2048 32H (GQA kv=4, head_dim=128, q/k-norm) moe_d_ff=768
vocab=151936, MoE 128 experts top-8 on every layer.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,                    # every layer uses expert FFNs
    vocab_size=151936,
    layer_pattern=("attn",),
    qk_norm=True,
    moe_num_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    moe_layer_period=1,
    rope_theta=1000000.0,
)
