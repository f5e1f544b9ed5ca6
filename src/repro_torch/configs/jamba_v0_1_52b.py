"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; Mamba+attention with a
1:7 attn:mamba interleave (attention at position 4 of each 8-layer block) and
MoE (16 experts, top-2) every other layer.

Adaptation note (recorded in DESIGN.md): the Mamba layers use our Mamba2/SSD
block (state=16 as in Jamba v0.1) so the SSD Pallas kernel is shared between
jamba and mamba2 configs.  Sub-quadratic mixers dominate => long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    # 8-layer Jamba block: attention at index 4, Mamba elsewhere (1:7)
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    ssm_state=16,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    rope_theta=10000.0,
)
