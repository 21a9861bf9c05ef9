"""Config registry: ``get_config("<arch-id>")`` / ``--arch <id>``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, HybridConfig, InputShape,
                                INPUT_SHAPES, MoEConfig, SSMConfig,
                                TrainConfig)

# arch-id -> module name
ARCHS = {
    "whisper-base": "whisper_base",
    "grok-1-314b": "grok_1_314b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-7b": "qwen2_7b",
    "llama3-405b": "llama3_405b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

#: archs the port runs that the JAX package has no twin of: found by
#: ``get_config``, left out of ``list_archs`` (the JAX package's set)
PORT_ONLY_ARCHS = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def _module(arch: str):
    known = {**ARCHS, **PORT_ONLY_ARCHS}
    if arch not in known:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(known)}")
    return importlib.import_module(f"repro_torch.configs.{known[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke_config()


def list_archs():
    return sorted(ARCHS)


__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "HybridConfig",
           "InputShape", "INPUT_SHAPES", "TrainConfig",
           "get_config", "get_smoke_config", "list_archs", "ARCHS",
           "PORT_ONLY_ARCHS"]
