"""TinyLlama 1.1B — llama2-architecture small model. [arXiv:2401.02385]

Also one of the paper's on-device LLM families (§V.A).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    arch_type="dense",
    citation="arXiv:2401.02385",
    n_layers=22,
    d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    tie_embeddings=False,
).validate()
