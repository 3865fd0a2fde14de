"""chameleon-34b — early-fusion VLM; VQ image tokens share the text vocab.

Backbone only (per assignment): the modality frontend is a stub; ``input_specs``
provides token ids drawn from the unified 65536 vocab (VQ codes + text).
QK-norm per the paper. [arXiv:2405.09818]

Port of ``repro/configs/chameleon_34b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    layer_pattern=("global",),
    activation="silu",
    qk_norm=True,
    rope_theta=10_000.0,
)
