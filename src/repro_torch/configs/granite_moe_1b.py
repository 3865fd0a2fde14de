"""granite-moe-1b-a400m — MoE LM, 32 experts top-8, per-expert d_ff=512.

[hf:ibm-granite/granite-3.0-1b-a400m-base]

Port of ``repro/configs/granite_moe_1b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    layer_pattern=("global",),
    activation="silu",
    n_experts=32,
    top_k=8,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
