"""whisper-medium — encoder-decoder audio model. [arXiv:2212.04356]

Conv frontend is a STUB per assignment: ``input_specs`` provides precomputed
frame embeddings (batch, 1500, d_model); the transformer backbone (24 enc +
24 dec layers) is real. Decoder cross-attends to the encoder states.

Port of ``repro/configs/whisper_medium.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,                # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    layer_pattern=("global",),
    activation="gelu",
    use_rope=False,               # sinusoidal absolute positions
    attn_bias=True,
    mlp_bias=True,
    n_frames=1500,
    tie_embeddings=True,
)
