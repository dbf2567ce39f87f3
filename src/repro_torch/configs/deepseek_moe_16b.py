"""DeepSeek-MoE-16B-base — the paper's case-study-2 global MoE.
[arXiv:2401.06066; paper §V.A]

Copied from ``repro.configs.deepseek_moe_16b``.  28 layers, 64 routed
(top-6) + 2 shared experts of width 1408, the first layer dense (a gated
MLP of width 10944, ``dense_blocks`` in ``models/model.py``), vocab
102,400 with an untied head.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    citation="arXiv:2401.06066 (paper case study 2)",
    n_layers=28,
    d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
    tie_embeddings=False,
).validate()
