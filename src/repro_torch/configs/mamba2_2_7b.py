"""mamba2-2.7b [ssm] — arXiv:2405.21060 (SSD, state-space duality).

64L d_model=2560, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, headdim=64 => 80 SSD heads.  long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # pure SSM blocks, no MLP
    vocab_size=50280,
    layer_pattern=("mamba",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
)
