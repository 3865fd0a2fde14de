"""DLRM arch-id → config resolution for ``--arch <id>``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.dlrm_models import DCN, WIDE_DEEP, XDEEPFM, DLRMConfig

DLRMS: Dict[str, DLRMConfig] = {
    "wide_deep": WIDE_DEEP,
    "xdeepfm": XDEEPFM,
    "dcn": DCN,
}


def get_dlrm(name: str) -> DLRMConfig:
    if name not in DLRMS:
        raise KeyError(f"unknown DLRM {name!r}; choose from {sorted(DLRMS)}")
    return DLRMS[name]
