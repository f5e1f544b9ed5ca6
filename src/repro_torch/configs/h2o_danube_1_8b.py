"""h2o-danube-1.8b [dense] — arXiv:2401.16818 (llama + mistral mix, SWA).

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, sliding-window attention.
Sub-quadratic (SWA) => runs the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    layer_pattern=("swa",),
    sliding_window=4096,
    rope_theta=10000.0,
)
