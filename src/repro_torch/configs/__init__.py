"""Architecture configs (``--arch <id>``): the JAX package's ten."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = (
    "chameleon_34b",
    "qwen3_0_6b",
    "olmo_1b",
    "deepseek_7b",
    "yi_34b",
    "deepseek_v3_671b",
    "arctic_480b",
    "jamba_1_5_large",
    "mamba2_130m",
    "hubert_xlarge",
)

_ALIASES = {
    "chameleon-34b": "chameleon_34b",
    "qwen3-0.6b": "qwen3_0_6b",
    "olmo-1b": "olmo_1b",
    "deepseek-7b": "deepseek_7b",
    "yi-34b": "yi_34b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "arctic-480b": "arctic_480b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "mamba2-130m": "mamba2_130m",
    "hubert-xlarge": "hubert_xlarge",
}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE_CONFIG
