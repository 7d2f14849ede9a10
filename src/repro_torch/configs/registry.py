"""Architecture registry — ``--arch <id>`` resolution."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get(name[: -len("-reduced")]).reduced()
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(list_archs())}"
        )
    mod = importlib.import_module(_MODULES[name])
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {name: get(name) for name in list_archs()}
