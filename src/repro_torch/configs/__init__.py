"""Assigned-architecture configs (exact values from the assignment sheet)
plus the paper-scale LM used by the end-to-end example.

Each ``<id>.py`` exports ``CONFIG``; the registry maps ``--arch <id>``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = [
    "gemma3_12b",
    "olmo_1b",
    "internlm2_1_8b",
    "qwen2_5_14b",
    "llava_next_mistral_7b",
    "deepseek_v3_671b",
    "kimi_k2_1t",
    "whisper_medium",
    "mamba2_780m",
    "zamba2_1_2b",
    "paper_lm",
]

# assignment-sheet id -> module id
ALIASES: Dict[str, str] = {
    "gemma3-12b": "gemma3_12b",
    "olmo-1b": "olmo_1b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen2.5-14b": "qwen2_5_14b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "whisper-medium": "whisper_medium",
    "mamba2-780m": "mamba2_780m",
    "zamba2-1.2b": "zamba2_1_2b",
}


def get_config(arch: str) -> ModelConfig:
    mod_id = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch}'; known: {sorted(ALIASES) + ['paper_lm']}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_id}")
    return mod.CONFIG


def all_arch_ids(include_paper: bool = False) -> List[str]:
    ids = [a for a in ARCH_IDS if a != "paper_lm"]
    return ids + (["paper_lm"] if include_paper else [])
