"""Architecture registry of the port.

``get_config(arch_id)`` returns the exact assigned ModelConfig.  Every
architecture of the JAX package's registry is listed, each with the
port's own copy of its config.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "gemma3-12b": "gemma3_12b",
    "grok-1-314b": "grok_1_314b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llama3-8b": "llama3_8b",
    "mamba2-130m": "mamba2_130m",
    "minicpm-2b": "minicpm_2b",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-1.7b": "qwen3_1_7b",
    "whisper-base": "whisper_base",
}

ARCH_IDS = tuple(_MODULES)

# module-style aliases: "llama3_8b" -> "llama3-8b" etc., so CLI specs can
# use either the registry id or the config module's name
_ALIASES = {mod: arch for arch, mod in _MODULES.items()}


def resolve_arch(name: str) -> str:
    """Canonical registry id for ``name`` — the id itself or a
    module-style alias (``llama3_8b`` for ``llama3-8b``).

    Raises:
      KeyError: unknown name; the message lists every known id and
          alias so CLI flag errors are self-explanatory."""
    if name in _MODULES:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown model {name!r}; known: {sorted(_MODULES)} "
                   f"(aliases: {sorted(_ALIASES)})")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
