"""Gemma-2 9B — dense, local/global alternating, softcaps. [arXiv:2408.00118]

Copied from ``repro.configs.gemma2_9b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    citation="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    attn_pattern=("local", "full"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    embed_scale=True,
    act="gelu",
    tie_embeddings=True,
).validate()
