"""gemma3-27b — dense LM, 5:1 local:global attention, 128k ctx. [hf:google/gemma-3]

head_dim follows the HF release (128) rather than d_model//n_heads=168: the
assigned pool fixes (L, d_model, H, kv, d_ff, vocab) and leaves head_dim free;
128 is MXU-aligned and matches the published checkpoint.

Port of ``repro/configs/gemma3_27b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    layer_pattern=("local",) * 5 + ("global",),
    local_window=1024,
    logit_softcap=0.0,
    rope_theta=1_000_000.0,
    rope_local_theta=10_000.0,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
    qk_norm=True,
)
