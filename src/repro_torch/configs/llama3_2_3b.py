"""llama3.2-3b — dense decoder LM, GQA(8), SwiGLU. [hf:meta-llama/Llama-3.2-1B-family]

Port of ``repro/configs/llama3_2_3b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    layer_pattern=("global",),
    activation="silu",
    rope_theta=500000.0,
    tie_embeddings=True,
)
