"""whisper-tiny [audio] — arXiv:2212.04356.

4L enc + 4L dec, d_model=384 6H (MHA) d_ff=1536 vocab=51865.  Encoder-decoder;
the conv audio frontend is a STUB: input_specs() provides post-conv frame
embeddings of shape (batch, 1500, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,              # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    layer_pattern=("attn",),
    num_audio_frames=1500,
    tie_embeddings=True,
    rope_theta=10000.0,        # (whisper uses learned pos-emb; we use RoPE-free
                               # sinusoidal for enc, learned for dec — see model)
)
