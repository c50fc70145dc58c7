"""Architecture configs (``--arch <id>``).  Ported so far: qwen3_0_6b, mamba2_130m."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = ("qwen3_0_6b", "mamba2_130m")

_ALIASES = {"qwen3-0.6b": "qwen3_0_6b", "mamba2-130m": "mamba2_130m"}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE_CONFIG
