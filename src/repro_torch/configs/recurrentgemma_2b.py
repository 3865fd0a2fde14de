"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427] Griffin architecture: repeating (recurrent, recurrent,
local-attention) blocks, MQA (kv=1), window 2048.

Port of ``repro/configs/recurrentgemma_2b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("recurrent", "recurrent", "local"),
    local_window=2048,
    lru_width=2560,
    activation="gelu",
    rope_theta=10_000.0,
    embed_scale=True,
    tie_embeddings=True,
)
