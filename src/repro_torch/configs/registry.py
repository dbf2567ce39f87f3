"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the architectures whose model family has been ported are known
here; the reference registry (``repro.configs.registry``) lists the
rest, and asking for one of them raises ``KeyError``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN2_MOE_A2_7B
from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA_1_1B
from repro_torch.models.config import ModelConfig, reduced

PORTED: Dict[str, ModelConfig] = {
    "tinyllama-1.1b": TINYLLAMA_1_1B,
    "qwen2-moe-a2.7b": QWEN2_MOE_A2_7B,
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
