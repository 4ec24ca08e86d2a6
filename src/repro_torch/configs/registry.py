"""Architecture registry of the port.

``get_config(arch_id)`` returns the exact assigned ModelConfig.  Only the
architectures the port serves so far are listed; ROADMAP.md names the
rest of the JAX package's registry, which later slices add here.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama3-8b": "llama3_8b",
    "qwen3-1.7b": "qwen3_1_7b",
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
