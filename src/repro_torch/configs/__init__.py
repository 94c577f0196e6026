"""Arch registry: the 10 assigned architectures + reduced smoke variants.

``get_config(name)`` returns the exact assigned config;
``get_smoke_config(name)`` returns a same-family reduced config that runs
a forward/train step on CPU in seconds.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, validate

ARCHS = [
    "stablelm_1_6b",
    "qwen1_5_0_5b",
    "qwen1_5_110b",
    "granite_20b",
    "whisper_large_v3",
    "mamba2_130m",
    "deepseek_v2_236b",
    "grok_1_314b",
    "pixtral_12b",
    "hymba_1_5b",
]

# CLI ids (dashes) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.CONFIG
    validate(cfg)
    return cfg


def get_smoke_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    cfg = mod.SMOKE
    validate(cfg)
    return cfg


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCHS}


def families() -> dict:
    return {a: get_config(a).family for a in ARCHS}
