"""Registry of the architectures the port serves (``get(name)``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchCfg  # noqa: F401

_MODULES = {
    "smollm-135m": "smollm_135m",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "mistral-large-123b": "mistral_large_123b",
    "llava-next-34b": "llava_next_34b",
    "grok-1-314b": "grok_1_314b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "xlstm-1.3b": "xlstm_1_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str) -> ArchCfg:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
