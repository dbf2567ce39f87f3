"""Whisper-small — encoder-decoder audio transformer. [arXiv:2212.04356]

The mel-spectrogram + conv frontend is a stub, as in the reference:
requests carry (1, 1500, d_model) precomputed frame embeddings, which
the encoder reads bidirectionally; the decoder cross-attends the
encoder's memory and serves its 448-token context like any prompt
(sinusoidal positions, tied head).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="encdec",
    citation="arXiv:2212.04356",
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    norm_type="layernorm",
    act="gelu",
    mlp_gated=False,
    pos_embedding="sinusoidal",
    frontend="audio",
    frontend_tokens=1500,
    tie_embeddings=True,
).validate()
