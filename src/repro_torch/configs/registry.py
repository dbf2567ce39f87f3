"""Architecture registry of the port: ``--arch <id>`` resolution.

Every architecture of the reference registry
(``repro.configs.registry.ALL``) is here; asking for any other name
raises ``KeyError``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.device_models import (BLOOM_1_1B, GPT2,
                                               GPT2_MEDIUM, OLMO_1_2B)
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK_MOE_16B
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.gemma2_9b import CONFIG as GEMMA2_9B
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2_1_3B
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2_3B
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA_1_1B
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B
from repro_torch.models.config import ModelConfig, reduced

PORTED: Dict[str, ModelConfig] = {
    "tinyllama-1.1b": TINYLLAMA_1_1B,
    "qwen2-moe-a2.7b": QWEN2_MOE_A2_7B,
    "deepseek-moe-16b": DEEPSEEK_MOE_16B,
    "deepseek-v3-671b": DEEPSEEK_V3_671B,
    "starcoder2-3b": STARCODER2_3B,
    "gemma2-9b": GEMMA2_9B,
    "gemma2-27b": GEMMA2_27B,
    "paligemma-3b": PALIGEMMA_3B,
    "mamba2-1.3b": MAMBA2_1_3B,
    "zamba2-7b": ZAMBA2_7B,
    "whisper-small": WHISPER_SMALL,
    # the paper's on-device families (configs/device_models.py)
    "gpt2": GPT2,
    "gpt2-medium": GPT2_MEDIUM,
    "olmo-1.2b": OLMO_1_2B,
    "bloom-1.1b": BLOOM_1_1B,
}


def get_config(name: str, *, variant: str = "full") -> ModelConfig:
    """--arch resolution.  variant: full | reduced."""
    if name not in PORTED:
        raise KeyError(
            f"arch '{name}' is not ported yet; ported: {sorted(PORTED)}")
    if variant not in ("full", "reduced"):
        raise ValueError(f"variant must be 'full' or 'reduced', not {variant!r}")
    cfg = PORTED[name]
    if variant == "reduced":
        return reduced(cfg)
    return cfg


def list_archs() -> List[str]:
    return sorted(PORTED)
