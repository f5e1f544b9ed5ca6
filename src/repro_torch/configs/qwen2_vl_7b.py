"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; M-RoPE (3-component
temporal/height/width rotary positions), dynamic resolution.  The vision
frontend (ViT) is a STUB: input_specs() provides precomputed patch embeddings
of shape (batch, num_patches, d_model) plus 3-component position ids.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    layer_pattern=("attn",),
    qkv_bias=True,
    mrope=True,
    vision_stub=True,
    num_patches=1024,
    rope_theta=1000000.0,
)
