"""The paper's on-device LLM families (§V.A, Figs. 7/8).

Copied from ``repro.configs.device_models``: heterogeneous compact
architectures deployable on edge hardware, GPT-2 / GPT-2-Medium (case
study 1), OLMo-1.2B and BLOOM-1.1B (case study 2; TinyLlama is
``configs/tinyllama_1_1b.py``).  Positional schemes are adapted as in
the reference (GPT-2's learned positions and BLOOM's ALiBi become
sinusoidal).
"""
from repro_torch.models.config import ModelConfig

GPT2 = ModelConfig(
    name="gpt2", citation="Radford et al. 2019 [19]",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=50257, norm_type="layernorm", act="gelu",
    mlp_gated=False, pos_embedding="sinusoidal", tie_embeddings=True,
).validate()

GPT2_MEDIUM = ModelConfig(
    name="gpt2-medium", citation="Radford et al. 2019 [19]",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=50257, norm_type="layernorm", act="gelu",
    mlp_gated=False, pos_embedding="sinusoidal", tie_embeddings=True,
).validate()

OLMO_1_2B = ModelConfig(
    name="olmo-1.2b", citation="arXiv:2402.00838",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab_size=50304, tie_embeddings=True,
).validate()

BLOOM_1_1B = ModelConfig(
    name="bloom-1.1b", citation="arXiv:2211.05100",
    n_layers=24, d_model=1536, n_heads=16, n_kv_heads=16, head_dim=96,
    d_ff=6144, vocab_size=250880, norm_type="layernorm", act="gelu",
    mlp_gated=False, pos_embedding="sinusoidal", tie_embeddings=True,
).validate()
