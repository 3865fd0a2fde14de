"""minitron-8b — pruned nemotron dense LM, GQA(8). [arXiv:2407.14679]

Port of ``repro/configs/minitron_8b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    layer_pattern=("global",),
    activation="silu",
    rope_theta=500000.0,
)
