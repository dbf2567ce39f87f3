"""Gemma-2 27B — dense, local/global alternating attention, logit
softcaps, GeGLU, post-block norms. [arXiv:2408.00118]

Copied from ``repro.configs.gemma2_27b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    citation="arXiv:2408.00118",
    n_layers=46,
    d_model=4608,
    n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864,
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
