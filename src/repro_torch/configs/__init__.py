"""Assigned-architecture registry: ``get_config(name)`` / ``get_tiny(name)``.

Each module defines ``full()`` (the exact published config, dry-run only)
and ``tiny()`` (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "olmoe_1b_7b",
    "deepseek_v3_671b",
    "internlm2_20b",
    "qwen2_5_32b",
    "stablelm_3b",
    "starcoder2_3b",
    "hymba_1_5b",
    "mamba2_370m",
    "whisper_small",
    "paligemma_3b",
]

# canonical ids as assigned (dash form) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update({a: a for a in ARCHS})
# assignment spellings
ALIASES.update({
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "internlm2-20b": "internlm2_20b",
    "qwen2.5-32b": "qwen2_5_32b",
    "stablelm-3b": "stablelm_3b",
    "starcoder2-3b": "starcoder2_3b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-370m": "mamba2_370m",
    "whisper-small": "whisper_small",
    "paligemma-3b": "paligemma_3b",
})


def _module(name: str):
    mod = ALIASES.get(name)
    if mod is None:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f".{mod}", __name__)


def get_config(name: str):
    return _module(name).full()


def get_tiny(name: str):
    return _module(name).tiny()


def all_arch_ids() -> list[str]:
    return [a.replace("_", "-").replace("qwen2-5", "qwen2.5")
            .replace("hymba-1-5b", "hymba-1.5b") for a in ARCHS]
