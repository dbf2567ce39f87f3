"""Unified model configuration, copied from ``repro.models.config``.

The port keeps its own copy so that it never imports the JAX package.
The fields are those of the reference, so a configuration reads the
same in both packages, with one rename: ``use_pallas`` is
``use_kernels`` here (route attention and the LM loss through the
hand-written CUDA kernels of ``repro_torch.kernels``) and defaults to
True.  Only the
dense family is ported so far; the fields of the other families are
kept so later slices can fill them in.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # ---- identity -------------------------------------------------------
    name: str = "model"
    arch_type: str = "dense"  # dense | moe | ssm | hybrid | encdec | vlm
    citation: str = ""

    # ---- core dims ------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0          # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    # ---- attention ------------------------------------------------------
    attn_type: str = "gqa"     # gqa | mla | none
    rope_theta: float = 10000.0
    sliding_window: int = 0    # 0 = full attention
    # attention pattern across layers; each scan step covers len(pattern)
    # layers.  ("full",) for uniform, ("local", "full") for gemma-2.
    attn_pattern: Tuple[str, ...] = ("full",)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False

    # ---- MLA (DeepSeek-V2/V3 multi-head latent attention) ---------------
    q_lora_rank: int = 0       # 0 -> full-rank q projection
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # ---- MoE ------------------------------------------------------------
    n_experts: int = 0         # routed experts (0 = dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0          # per-expert hidden (0 -> d_ff)
    first_dense_layers: int = 0  # leading layers use dense FFN (deepseek)
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # size expert-parallel buffers to the worst case (t_loc * top_k per
    # expert) so NO token is ever dropped.  Capacity drops are a
    # training-time throughput tradeoff (GShard semantics); the serving
    # engines force this on so sharded decode keeps single-device
    # semantics exactly, at the cost of larger dispatch buffers.
    moe_dropless: bool = False
    # expert-parallel implementation: "dense" (loop, small tests),
    # "a2a" (shard_map all-to-all, production) or "auto"
    moe_impl: str = "auto"
    # EP-A2A overlap (decode): split the decode step into two batch
    # halves whose MoE dispatch/FFN/combine stages are structurally
    # independent, so one half's lax.all_to_all overlaps the other
    # half's attention compute (Megatron-Core-style batch-level
    # overlap).  Contiguous-cache decode on a multi-device mesh only.
    overlap_a2a: bool = False

    # ---- multi-token prediction (DeepSeek-V3) ----------------------------
    n_mtp: int = 0
    # weight of the auxiliary MTP loss in the training objective
    mtp_loss_weight: float = 0.3

    # ---- SSM (Mamba-2 / SSD) ---------------------------------------------
    ssm_state: int = 0         # 0 = no ssm
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # bf16 SSD matmul operands (decay/cumsum/state stay f32) - Perf Z3
    ssm_compute_dtype: str = "float32"
    # recompute attention scores per kv-chunk in backward - Perf Z4
    remat_attn_chunks: bool = False

    # ---- hybrid (Zamba-2): shared attention block every k mamba blocks ---
    shared_attn_every: int = 0

    # ---- encoder-decoder (Whisper) ---------------------------------------
    n_enc_layers: int = 0

    # ---- modality frontend stubs ------------------------------------------
    frontend: str = ""         # "" | "audio" | "vision"
    frontend_tokens: int = 0   # e.g. 1500 audio frames, 256 image patches

    # ---- misc architecture -----------------------------------------------
    act: str = "silu"          # silu | gelu
    norm_type: str = "rmsnorm" # rmsnorm | layernorm
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale
    post_block_norm: bool = False  # gemma-2 post-attention/post-ffn norms
    mlp_gated: bool = True     # SwiGLU/GeGLU vs plain 2-layer MLP
    tie_embeddings: bool = True
    pos_embedding: str = "rope"  # rope | sinusoidal | none

    # ---- numerics / execution --------------------------------------------
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | full
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    loss_chunk: int = 512      # sequence chunking for the CE loss
    # causal-aware chunk skipping in the attention loop (perf opt; see
    # EXPERIMENTS.md §Perf) — skips fully-masked (q-chunk, k-chunk) pairs.
    attn_skip_masked_chunks: bool = False
    use_kernels: bool = True   # hand-written CUDA attention/loss kernels
    # Unroll every lax.scan (incl. chunk loops).  Used by the dry-run's
    # cost calibration: XLA's cost_analysis counts a while-loop body ONCE,
    # so scanned modules under-report FLOPs; the calibration lowers two
    # unrolled reduced-depth variants and extrapolates (launch/dryrun.py).
    scan_unroll: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm_block(self) -> bool:
        return self.ssm_state > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def layers_per_scan(self) -> int:
        return len(self.attn_pattern)

    @property
    def mla_qk_dim(self) -> int:
        return self.nope_head_dim + self.rope_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "ModelConfig":
        if self.arch_type in ("dense", "moe", "vlm"):
            assert self.n_layers % self.layers_per_scan == 0, (
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"attn_pattern length {self.layers_per_scan}"
            )
        if self.is_moe:
            assert self.top_k > 0, f"{self.name}: MoE requires top_k > 0"
        if self.arch_type == "encdec":
            assert self.n_enc_layers > 0
        if self.arch_type == "hybrid":
            assert self.shared_attn_every > 0 and self.ssm_state > 0
        return self


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny CPU-runnable variant of the same architecture family.

    Used by the per-architecture smoke tests: 2 layers, d_model <= 512,
    <= 4 experts, same structural features (pattern, MLA, SSM, ...).
    """
    kw = dict(
        n_layers=2 * cfg.layers_per_scan if cfg.arch_type != "hybrid" else 4,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        remat=False,
        attn_chunk_q=64,
        attn_chunk_k=64,
        loss_chunk=64,
        ssm_chunk=32,
    )
    if cfg.attn_type == "mla":
        kw.update(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32,
                  v_head_dim=32, q_lora_rank=(32 if cfg.q_lora_rank else 0))
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=2, moe_d_ff=128,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.is_ssm_block:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2)
    if cfg.arch_type == "hybrid":
        kw.update(shared_attn_every=2)
    if cfg.arch_type == "encdec":
        kw.update(n_enc_layers=2)
    if cfg.frontend:
        kw.update(frontend_tokens=min(cfg.frontend_tokens, 16) or 16)
    if cfg.n_mtp:
        kw.update(n_mtp=1, mtp_loss_weight=cfg.mtp_loss_weight)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    kw.update(overrides)
    return cfg.replace(name=cfg.name + "-reduced", **kw).validate()
