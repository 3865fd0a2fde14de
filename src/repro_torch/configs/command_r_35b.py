"""command-r-35b — dense LM, GQA(8), no biases. [hf:CohereForAI/c4ai-command-r-v01]

Port of ``repro/configs/command_r_35b.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    layer_pattern=("global",),
    activation="silu",
    attn_bias=False,
    mlp_bias=False,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
)
