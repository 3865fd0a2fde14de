"""Config system of the LM zoo: model architecture + input-shape configs.

Port of ``repro/configs/base.py`` (which imports no JAX; this package keeps
its own copy all the same). Every architecture has one file in this package
exporting ``CONFIG`` (the published config); ``reduce_config`` makes a tiny
same-family config for CPU tests, and ``repro_torch.configs.registry``
resolves ``--arch <id>`` strings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-pattern vocabulary
# ---------------------------------------------------------------------------
# "global"    : full causal self-attention
# "local"     : sliding-window causal self-attention (window = local_window)
# "recurrent" : RG-LRU recurrent block (recurrentgemma)
# "ssm"       : Mamba-2 SSD block
ATTN_KINDS = ("global", "local", "recurrent", "ssm")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering every family in the assigned pool."""

    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm | dlrm
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default: d_model // n_heads

    # --- layer pattern -----------------------------------------------------
    # Repeating pattern of layer kinds, tiled (and truncated) to num_layers.
    # e.g. gemma3: ("local",)*5 + ("global",)  |  recurrentgemma:
    # ("recurrent","recurrent","local")  |  dense archs: ("global",)
    layer_pattern: Tuple[str, ...] = ("global",)
    local_window: int = 4096          # sliding-window size for "local" layers

    # --- attention details ---------------------------------------------------
    qk_norm: bool = False             # chameleon-style query/key RMSNorm
    attn_bias: bool = False
    logit_softcap: float = 0.0        # gemma-style attention logit soft-capping
    rope_theta: float = 500000.0
    rope_local_theta: Optional[float] = None  # distinct theta for local layers
    use_rope: bool = True             # whisper uses sinusoidal abs positions instead

    # --- MLP ------------------------------------------------------------------
    activation: str = "silu"          # silu (SwiGLU) | gelu (plain MLP)
    mlp_bias: bool = False

    # --- MoE ------------------------------------------------------------------
    n_experts: int = 0                # 0 => dense MLP
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba2 / SSD) ---------------------------------------------------
    ssm_state: int = 0                # N (state size per head)
    ssm_headdim: int = 64             # P
    ssm_expand: int = 2               # d_inner = expand * d_model
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256              # SSD chunk length

    # --- RG-LRU (recurrentgemma) ----------------------------------------------
    lru_width: Optional[int] = None

    # --- encoder/decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0           # 0 => decoder-only
    n_frames: int = 1500              # stub frontend: precomputed frame embeddings

    # --- embedding / head -------------------------------------------------------
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False         # gemma-style sqrt(d_model) embedding scaling

    # --- numerics ----------------------------------------------------------------
    # bf16 params + f32-master optimizer (production mixed precision): halves
    # FSDP all-gather and gradient all-reduce bytes vs f32 params. CPU smoke
    # tests override both to float32 via reduce_config.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "dlrm")
        for k in self.layer_pattern:
            assert k in ATTN_KINDS, k

    # ------------------------------------------------------------------------
    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind tuple of length num_layers (pattern tiled + truncated)."""
        pat = self.layer_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer needs a full-length dense-attention KV cache."""
        return "global" not in self.layer_pattern

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # --- parameter counting (analytic; cross-checked against real init) -------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; MoE can count only activated experts."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d                                      # token embedding
        if not self.tie_embeddings:
            total += v * d                                 # lm head
        per_kind = {}
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.activation == "silu":
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        norms = 2 * d
        per_kind["global"] = attn + mlp + norms
        per_kind["local"] = attn + mlp + norms
        lru = self.lru_width or d
        per_kind["recurrent"] = (d * lru * 2 + lru * d + 2 * lru) + mlp + norms
        di, N, G, P = self.d_inner, self.ssm_state, self.ssm_ngroups, self.ssm_headdim
        nh_ssm = self.ssm_nheads
        ssm = (d * (2 * di + 2 * G * N + nh_ssm)          # in_proj
               + (di + 2 * G * N) * self.ssm_conv_width   # conv1d
               + nh_ssm * 2                                # A_log, D
               + di                                        # dt_bias ~ nh; norm
               + di * d)                                   # out_proj
        per_kind["ssm"] = ssm + norms
        if self.n_experts > 0:
            k = self.top_k if active_only else self.n_experts
            moe_mlp = k * (3 * ff * d if self.activation == "silu" else 2 * ff * d)
            per_kind["global"] = attn + moe_mlp + norms + d * self.n_experts
            per_kind["local"] = per_kind["global"]
        for kind in self.layer_kinds:
            total += per_kind[kind]
        if self.encoder_layers:
            total += self.encoder_layers * (per_kind["global"])
            total += self.num_layers * (d * nkv * hd * 2 + d)  # cross-attn kv+norm
        total += d                                          # final norm
        return int(total)


# ---------------------------------------------------------------------------
# Input shapes (assigned; identical set for every LM arch)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# smoke-test shape (CPU, reduced configs)
SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Spec-mandated skip rules; every skip is recorded in DESIGN/EXPERIMENTS."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def reduce_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, len(cfg.layer_pattern) + 1),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        local_window=16,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=16,
        ssm_chunk=16,
        lru_width=64 if cfg.lru_width else None,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        encoder_layers=min(cfg.encoder_layers, 2),
        n_frames=8,
        param_dtype="float32",
        compute_dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
