"""PaliGemma-3B — SigLIP vision encoder + Gemma decoder. [arXiv:2407.07726]

The SigLIP ViT + projector frontend is a stub, as in the reference:
requests carry (1, 256, d_model) precomputed patch embeddings, which
prefix the prompt; the decoder is gemma-1-style: GQA kv=1, GeGLU, embed
scaling, tied head.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    citation="arXiv:2407.07726",
    n_layers=18,
    d_model=2048,
    n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    act="gelu",
    embed_scale=True,
    frontend="vision",
    frontend_tokens=256,
    tie_embeddings=True,
).validate()
