"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed top-4 MoE.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

The paper's case-study-1 global MoE ("Qwen-MoE", 14.3B params, 2.7B
active), copied from ``repro.configs.qwen2_moe_a2_7b``.  The four shared
experts are one MLP of width 4 x 1408 (``models/moe.py::init_moe``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    citation="hf:Qwen/Qwen1.5-MoE-A2.7B",
    n_layers=24,
    d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=5632,              # shared-expert lane width (4 x 1408)
    vocab_size=151936,
    n_experts=60, n_shared_experts=4, top_k=4, moe_d_ff=1408,
    tie_embeddings=False,
).validate()
