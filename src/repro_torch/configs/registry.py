"""Arch-id → config resolution for ``--arch <id>``: DLRMs and the LM zoo.

``ARCHS`` holds the decoder LMs this package serves so far (the dense
attention families; see ``models/registry.py``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import llama3_2_3b
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.dlrm_models import DCN, WIDE_DEEP, XDEEPFM, DLRMConfig

DLRMS: Dict[str, DLRMConfig] = {
    "wide_deep": WIDE_DEEP,
    "xdeepfm": XDEEPFM,
    "dcn": DCN,
}

ARCHS: Dict[str, ModelConfig] = {
    "llama3.2-3b": llama3_2_3b.CONFIG,
}


def get_dlrm(name: str) -> DLRMConfig:
    if name not in DLRMS:
        raise KeyError(f"unknown DLRM {name!r}; choose from {sorted(DLRMS)}")
    return DLRMS[name]


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]
