"""Arch-id → config resolution for ``--arch <id>``: DLRMs and the LM zoo.

Port of ``repro/configs/registry.py``: the ten LM archs, the three DLRMs,
the input shapes and the (arch × shape) cells; and DLRM-DCNv2, which the
reference has not.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    chameleon_34b, command_r_35b, gemma3_27b, granite_moe_1b, llama3_2_3b,
    mamba2_2_7b, minitron_8b, mixtral_8x22b, recurrentgemma_2b,
    whisper_medium,
)
from repro_torch.configs.base import (
    SHAPES, ModelConfig, ShapeConfig, shape_applicable,
)
from repro_torch.configs.dlrm_models import (
    DCN, DLRM_DCNV2, WIDE_DEEP, XDEEPFM, DLRMConfig,
)

ARCHS: Dict[str, ModelConfig] = {
    "llama3.2-3b": llama3_2_3b.CONFIG,
    "minitron-8b": minitron_8b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "command-r-35b": command_r_35b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "mamba2-2.7b": mamba2_2_7b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
}

DLRMS: Dict[str, DLRMConfig] = {
    "wide_deep": WIDE_DEEP,
    "xdeepfm": XDEEPFM,
    "dcn": DCN,
    "dlrm_dcnv2": DLRM_DCNV2,
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; choose from {sorted(SHAPES)}")
    return SHAPES[name]


def get_dlrm(name: str) -> DLRMConfig:
    if name not in DLRMS:
        raise KeyError(f"unknown DLRM {name!r}; choose from {sorted(DLRMS)}")
    return DLRMS[name]


def all_cells():
    """All 40 (arch × shape) dry-run cells with applicability flags."""
    cells = []
    for arch_name, cfg in ARCHS.items():
        for shape_name, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            cells.append((arch_name, shape_name, ok, why))
    return cells
