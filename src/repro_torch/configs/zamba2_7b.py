"""Zamba2-7B — hybrid Mamba2 + shared-attention blocks. [arXiv:2411.15242]

81 Mamba-2 blocks, d_model=3584 (d_inner 7168, 112 heads x P=64, N=64);
ONE shared attention (32 heads x 112) + MLP block whose parameters are
reused at the top of every 6-block group and before the 3-block tail
(without the per-use LoRA deltas of the paper), copied from
``repro.configs.zamba2_7b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    citation="arXiv:2411.15242",
    n_layers=81,
    d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    shared_attn_every=6,
    rope_theta=10000.0,
    tie_embeddings=True,
).validate()
