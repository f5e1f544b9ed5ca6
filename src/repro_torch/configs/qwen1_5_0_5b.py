"""qwen1.5-0.5b [dense] — hf:Qwen/Qwen1.5-0.5B.

24L d_model=1024 16H (GQA kv=16, i.e. MHA) d_ff=2816 vocab=151936, QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    layer_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
