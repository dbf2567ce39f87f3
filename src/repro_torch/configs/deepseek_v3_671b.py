"""DeepSeek-V3 671B: MLA + 1 shared / 256 routed top-8 MoE + MTP.
[arXiv:2412.19437]

Copied from ``repro.configs.deepseek_v3_671b``.  61 layers (the first 3
dense, a gated MLP of width 18432, ``dense_blocks`` in
``models/model.py``), d_model 7168; multi-head latent attention
(kv_lora 512, rope 64, nope 128, v 128, q_lora 1536): its latent cache
holds 576 values a token and layer; 256 routed experts (width 2048,
top-8) + 1 shared expert; one MTP head.  The router is the reference's
softmax top-k, not the published model's sigmoid router.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    citation="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432,             # dense FFN width of the 3 leading layers
    vocab_size=129280,
    attn_type="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=3,
    n_mtp=1,
    tie_embeddings=False,
).validate()
