"""StarCoder2-3B — GQA kv=2, RoPE, layernorm + plain GELU MLP.
[arXiv:2402.19173]

Copied from ``repro.configs.starcoder2_3b``: 30 layers of width 3072,
24 query heads over 2 kv heads (12 query rows a kv head), head dim 128,
an ungated tanh-GELU MLP of width 12288, vocab 49,152, tied head.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    citation="arXiv:2402.19173",
    n_layers=30,
    d_model=3072,
    n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    norm_type="layernorm",
    act="gelu",
    mlp_gated=False,
    tie_embeddings=True,
).validate()
