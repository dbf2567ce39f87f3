"""Mamba2-1.3B — attention-free SSD state-space model. [arXiv:2405.21060]

48 SSD blocks, d_model=2048 (d_inner 4096, 64 heads x P=64, N=128),
copied from ``repro.configs.mamba2_1_3b``.  Decode carries an O(1)
recurrent state per slot, so the model has no paged cache leaves.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    citation="arXiv:2405.21060",
    n_layers=48,
    d_model=2048,
    n_heads=0, n_kv_heads=0,
    attn_type="none",
    d_ff=0,
    vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    tie_embeddings=True,
).validate()
