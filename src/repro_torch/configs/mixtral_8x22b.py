"""mixtral-8x22b — MoE LM, 8 experts top-2, sliding-window attention.

[arXiv:2401.04088]

Port of ``repro/configs/mixtral_8x22b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    layer_pattern=("local",),     # SWA everywhere => sub-quadratic cache
    local_window=4096,
    activation="silu",
    n_experts=8,
    top_k=2,
    rope_theta=1_000_000.0,
)
