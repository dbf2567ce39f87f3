"""Model assembly of the port: init / loss / prefill / decode, dense,
MoE, VLM (PaliGemma), ssm (Mamba-2), hybrid (Zamba-2) and
encoder-decoder (Whisper) families.

Counterpart of ``repro.models.model``.  The parameter layout is the
reference's: nested dicts with the same keys, layer parameters stacked
along a leading group axis (``blocks/sub{i}/...`` of shape
``(n_groups, ...)``, ``n_groups = n_layers / len(attn_pattern)``), and
``(in, out)`` weight matrices.  Where the reference scans over the group
axis, the port loops over it in Python over views of the stacked
tensors; training rematerialises each group (and each loss chunk) in
the backward when ``cfg.remat``, as the reference's ``jax.checkpoint``.

MoE sub-layers (``arch_type="moe"``) hold ``moe`` in place of ``mlp``
(``models/moe.py``) and add their load-balance loss to the training
loss.  The MoE family trains, prefills and decodes; decode takes the
reference's serving ``live`` mask (B,), which zeroes dead slots'
routing weights.  DeepSeek's leading dense layers
(``first_dense_layers``) are a second stack, ``dense_blocks/sub0/...``
of shape (first_dense_layers, ...), with a dense MLP of width ``d_ff``;
they run before ``blocks`` in every forward and decode, and carry their
own cache entry.

DeepSeek-V3's multi-head latent attention (``attn_type="mla"``) takes
the attention's place in every sub-layer (``layers.mla_full`` /
``layers.mla_decode``); its cache entry is the latent ``{"ckv", "kr"}``
(B, S, kv_lora_rank) and (B, S, rope_head_dim) in place of ``{"k",
"v"}``.  The multi-token prediction head (``n_mtp``, dense, MoE and
VLM families) is ``params["mtp"]``: ``proj`` (2D, D), one dense
sub-layer ``block`` and ``norm``; ``loss_fn`` adds ``mtp_loss_weight``
times its loss (``_mtp_loss``, predicting token t+2),
``mtp_chain_loss`` chains it to any depth, and ``generate(speculate=k)``
drafts with it (``_generate_spec``: k drafts, one k+1-row verify chunk,
the rejected drafts' cache rows scrubbed).

The VLM family (``arch_type="vlm"``) is the dense family behind a stub
vision frontend: ``batch["patches"]`` (B, frontend_tokens, D),
precomputed patch embeddings, prefix the embedded text, so every
forward, prefill and cache covers ``[patches | text]``, decode starts
at ``decode_pos0 = frontend_tokens + P``, and the loss drops the patch
positions.

The ssm family (``arch_type="ssm"``, Mamba2) stacks ``{"ln", "mixer"}``
over its ``n_layers`` (``models/ssm.py``): prefill through the SSD scan,
decode through the O(1) recurrence, training through the scan's
autograd (each block rematerialised when ``cfg.remat``).  The hybrid
family (``arch_type="hybrid"``, Zamba2) stacks the same blocks as
``mamba_groups`` (n_groups, period, ...) and, when ``n_layers % period``,
``mamba_tail`` (tail, ...), with ONE ``shared_attn`` block (attention +
MLP) run at the top of every group and once more before the tail; its
gradient is the sum over those applications.  ``prefill_chunked``
feeds a prompt through the decode body in fixed chunks (bucketed
admission): C > 1 in ``_chunk_hidden``, the Mamba-2 blocks through
``ssm_prefill_chunk`` with a carried state.

The encoder-decoder family (``arch_type="encdec"``, Whisper) stacks
``enc_blocks`` (n_enc_layers, ...) of plain blocks, ``enc_norm``, and
``dec_blocks`` (n_layers, ...) of plain blocks with ``ln_x`` and a
cross-attention ``xattn``.  ``batch["frames"]`` (B, frontend_tokens, D),
the stub audio frontend's frame embeddings, go through the encoder
bidirectionally (flash attention with ``causal=False`` on the kernel
path); each decoder layer attends causally over the tokens, then over
the encoder's memory through the plain ``chunked_attention`` (decode:
``decode_attention`` over the cached cross K/V), as the reference does.
Positions are sinusoidal.  No cache row holds a frame
(``decode_offset`` 0).  ``remat_policy="dots"`` (``_maybe_remat``)
keeps the outputs of the products without batch dims for the backward
and recomputes the rest; the decoder's layers are rematerialised whole
whatever the policy, as the reference's plain ``jax.checkpoint``.

Caches follow the reference's layout too.  Contiguous decode cache:
``blocks/sub{i}/{k,v}`` of shape (n_groups, B, S, KH, Dh); for the ssm
family ``blocks/{state,conv}`` of shape (n_layers, B, H, P, N) in f32
and (n_layers, B, K-1, conv_dim); for the hybrid family ``mamba`` of
shape (n_groups, period, B, ...), ``attn`` ``{"k", "v"}`` with one entry
per shared-attention application (n_groups, plus one with a tail) and
``tail`` (tail, B, ...); MLA's ``{"ckv", "kr"}`` of shape (n_groups, B,
S, r) and (n_groups, B, S, pr); the encoder-decoder family's ``self``
{"k", "v"} (n_layers, B, S, KH, Dh), ``cross`` {"k", "v"} (n_layers, B,
frontend_tokens, KH, Dh) and ``memory`` (B, frontend_tokens, D).  Paged
cache: the sequence-carrying leaves as block pools (n_groups, n_blocks,
block_len, KH, Dh), where block id b is row b of every pool and block 0
is the trash block; leaves without a sequence axis (the ssm state and
conv tail, the encoder-decoder ``cross`` and ``memory``) keep one row
per slot.  Under a quantized ``quant.CachePolicy`` (int8 or fp8) the
attention leaves are stored at the policy's dtype beside f32
``k_scale``/``v_scale`` (MLA: ``ckv_scale``/``kr_scale``) siblings
without the trailing feature axis; the ssm state and conv tail,
``cross`` and ``memory`` opt out, as in the reference.  Decode writes
these tensors in place (the reference returns new ones); the functions
still return the cache so call sites read the same.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.models import layers, moe, quant, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules
from repro_torch.utils.rng import Stream

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def shard_act(x, mesh):
    """The reference's layout constraint on an activation's batch dim.
    The identity here: on a mesh the port keeps every dense weight,
    activation and cache whole on every rank, and only the MoE's experts
    are split (``models/moe.py``).  The dense layout (batch over the data
    axes, heads over "model") comes with the tensor-parallel slice."""
    return x


def _window_for(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def _layer(tree, g: int):
    """Group ``g`` of a stacked tree: views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


def _n_groups(cfg: ModelConfig) -> int:
    """Groups of ``blocks``: the layers after the leading dense ones."""
    return (cfg.n_layers - cfg.first_dense_layers) // cfg.layers_per_scan


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type in ("dense", "moe"):
        ok = cfg.attn_type in ("gqa", "mla")
    elif cfg.arch_type == "vlm":
        ok = cfg.attn_type == "gqa"
    elif cfg.arch_type in ("hybrid", "encdec"):
        ok = cfg.attn_type == "gqa" and not cfg.n_mtp
    else:
        ok = cfg.arch_type == "ssm"
    if not ok:
        raise NotImplementedError(
            f"{cfg.name} is not ported yet: only the dense and MoE families "
            "(GQA or MLA), the VLM family (GQA), each with or without MTP, "
            "the hybrid and encoder-decoder GQA families without MTP and "
            "the ssm family are")


def frontend_key(cfg: ModelConfig):
    """The batch key of a family's stub frontend input (B, frontend_tokens,
    d_model): ``"patches"`` (VLM), ``"frames"`` (encoder-decoder), else
    None."""
    return {"vlm": "patches", "encdec": "frames"}.get(cfg.arch_type)


def _hybrid_layout(cfg: ModelConfig):
    """(period, n_groups, tail) of the hybrid family's Mamba-2 blocks."""
    period = cfg.shared_attn_every
    return (period, *divmod(cfg.n_layers, period))


# ---------------------------------------------------------------------------
# transformer block
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, dtype, lead, *, use_moe: bool):
    dev = layers._source(generator)[1]
    init_attn = (layers.init_mla if cfg.attn_type == "mla"
                 else layers.init_attention)
    p: Dict[str, Any] = {
        "ln1": layers.init_norm(cfg, cfg.d_model, dtype, dev, lead),
        "ln2": layers.init_norm(cfg, cfg.d_model, dtype, dev, lead),
        "attn": init_attn(generator, cfg, dtype, lead),
    }
    if use_moe:
        p["moe"] = moe.init_moe(generator, cfg, dtype, lead)
    else:
        p["mlp"] = layers.init_mlp(generator, cfg, cfg.d_model, cfg.d_ff,
                                   dtype, lead)
    if cfg.post_block_norm:
        p["ln1_post"] = layers.init_norm(cfg, cfg.d_model, dtype, dev, lead)
        p["ln2_post"] = layers.init_norm(cfg, cfg.d_model, dtype, dev, lead)
    return p


def _block_full(p, cfg: ModelConfig, x, positions, *, kind: str,
                causal: bool = True, mesh=None):
    """Full-sequence sub-layer.  Returns (x, aux, cache_entry): ``aux``
    is the MoE load-balance loss (0 for a dense sub-layer), the entry
    ``{"k", "v"}`` (MLA: ``{"ckv", "kr"}``)."""
    window = _window_for(cfg, kind)
    h = layers.apply_norm(p["ln1"], x)
    if cfg.attn_type == "mla":
        attn_out, (ckv, kr) = layers.mla_full(p["attn"], cfg, h, positions)
        kv = {"ckv": ckv, "kr": kr}
    else:
        attn_out, (k, v) = layers.attention_full(
            p["attn"], cfg, h, positions, window=window, causal=causal)
        kv = {"k": k, "v": v}
    if cfg.post_block_norm:
        attn_out = layers.apply_norm(p["ln1_post"], attn_out)
    x = x + attn_out
    h = layers.apply_norm(p["ln2"], x)
    if "moe" in p:
        ffn_out, aux = moe.apply_moe(p["moe"], cfg, h, mesh)
    else:
        ffn_out = layers.apply_mlp(p["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_block_norm:
        ffn_out = layers.apply_norm(p["ln2_post"], ffn_out)
    return shard_act(x + ffn_out, mesh), aux, kv


def _block_decode(p, cfg: ModelConfig, x, pos, cache, *, kind: str,
                  block_tables=None, write_tables=None, live=None,
                  mesh=None):
    """Decode / chunk sub-layer.  x: (B, C, D), pos: (B, C) — C=1 is the
    single-token decode step.  ``cache`` is the layer's ``{"k", "v"}``
    (MLA: ``{"ckv", "kr"}``; contiguous rows, or block pools when
    ``block_tables`` is given), updated in place.  ``live`` (B, C) bool
    masks dead serving rows out of MoE routing weights."""
    window = _window_for(cfg, kind)
    h = layers.apply_norm(p["ln1"], x)
    if cfg.attn_type == "mla":
        attn_out, cache = layers.mla_decode(
            p["attn"], cfg, h, pos, cache, block_table=block_tables,
            write_table=write_tables)
    else:
        attn_out, cache = layers.attention_decode(
            p["attn"], cfg, h, pos, cache, window=window,
            block_table=block_tables, write_table=write_tables)
    if cfg.post_block_norm:
        attn_out = layers.apply_norm(p["ln1_post"], attn_out)
    x = x + attn_out
    h = layers.apply_norm(p["ln2"], x)
    if "moe" in p:
        ffn_out, _ = moe.apply_moe(p["moe"], cfg, h, mesh, live=live)
    else:
        ffn_out = layers.apply_mlp(p["mlp"], cfg, h)
    if cfg.post_block_norm:
        ffn_out = layers.apply_norm(p["ln2_post"], ffn_out)
    return shard_act(x + ffn_out, mesh), cache


def _groups(tree, n: int):
    """The ``n`` per-group views of a stacked tree, from one
    ``torch.unbind`` per leaf: its backward stacks the groups' gradients
    in one step, where indexing each group would add a zero-padded
    full-size gradient per group."""
    if isinstance(tree, dict):
        per_key = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(n)]
    return torch.unbind(tree, 0)


# the matrix products without batch dims: a (..., K) @ (K, N) product
# folds its leading dims and dispatches to one of these
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy, the reference's
    ``checkpoint_dots_with_no_batch_dims``: keep the outputs of the matrix
    products without batch dims for the backward, recompute everything
    else (batched products such as ``bmm``, and the kernels' launches)."""
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def _maybe_remat(cfg: ModelConfig, fn, *, policy=None):
    """``fn`` rematerialised in the backward when ``cfg.remat``, as the
    reference's ``jax.checkpoint`` (non-reentrant
    ``torch.utils.checkpoint``: only the inputs are saved), under
    ``policy`` (default ``cfg.remat_policy``): ``"dots"`` also saves the
    outputs of the products without batch dims (``_save_dots``), any
    other policy recomputes all of ``fn``.  Without autograd (serving)
    there is no backward, and ``fn`` runs as is."""
    if not cfg.remat:
        return fn
    policy = cfg.remat_policy if policy is None else policy
    context_fn = _dots_contexts if policy == "dots" else noop_context_fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)

    return run


def _run_stack(blocks, cfg: ModelConfig, x, positions, *, pattern,
               causal: bool, collect_cache: bool,
               collect_stages: bool = False, mesh=None):
    """Loop over the stacked groups of sub-layers (full sequence), each
    group rematerialised in the backward when ``cfg.remat``.  Returns
    (x, aux, caches, stages): ``aux`` the MoE load-balance losses summed
    per group (through the remat, as the reference's scan carries it),
    the per-layer cache entries stacked on the group axis (an empty dict
    unless ``collect_cache``), and each group's output stacked (n_groups,
    B, S, D) when ``collect_stages``, else None.  The stages are the remat'd
    group function's outputs, which the next group's input keeps anyway,
    so keeping them costs no extra recompute."""
    n = next(iter(blocks["sub0"]["ln1"].values())).shape[0]

    def group_fn(x, gp):
        kvs = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(pattern):
            x, a, kv = _block_full(gp[f"sub{i}"], cfg, x, positions,
                                   kind=kind, causal=causal, mesh=mesh)
            aux = aux + a
            kvs.append(kv)
        return x, aux, (kvs if collect_cache else [])

    group_fn = _maybe_remat(cfg, group_fn)
    per_sub = {f"sub{i}": [] for i in range(len(pattern))}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stages = []
    for gp in _groups(blocks, n):
        x, a, kvs = group_fn(x, gp)
        aux = aux + a
        if collect_stages:
            stages.append(x)
        for i, kv in enumerate(kvs):
            per_sub[f"sub{i}"].append(kv)
    stages = torch.stack(stages) if collect_stages else None
    if not collect_cache:
        return x, aux, {}, stages
    return x, aux, {s: {k: torch.stack([kv[k] for kv in e]) for k in e[0]}
                    for s, e in per_sub.items()}, stages


def _decode_stack(blocks, cfg: ModelConfig, x, pos, cache, *, pattern,
                  block_tables=None, write_tables=None, live=None,
                  mesh=None):
    n = next(iter(blocks["sub0"]["ln1"].values())).shape[0]
    for g in range(n):
        gp, gc = _layer(blocks, g), _layer(cache, g)
        for i, kind in enumerate(pattern):
            x, _ = _block_decode(gp[f"sub{i}"], cfg, x, pos, gc[f"sub{i}"],
                                 kind=kind, block_tables=block_tables,
                                 write_tables=write_tables, live=live,
                                 mesh=mesh)
    return x, cache


# ===========================================================================
# public API
# ===========================================================================

def init_params(cfg: ModelConfig, *, generator):
    """Random parameters in the reference's layout, on the generator's
    device, drawn from ``generator`` (seed it for reproducible weights).
    ``generator="meta"`` gives the shapes and dtypes alone.  The draws
    differ from ``jax.random``: to compare with the reference, convert
    its parameters with ``repro_torch.convert``."""
    cfg.validate()
    _check_ported(cfg)
    dtype = _dtype(cfg)
    dev = layers._source(generator)[1]
    p: Dict[str, Any] = {
        "embed": layers.embed_init(generator, (cfg.vocab_size, cfg.d_model),
                                   dtype),
        "final_norm": layers.init_norm(cfg, cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(generator,
                                         (cfg.d_model, cfg.vocab_size), 0,
                                         dtype)
    lead = (_n_groups(cfg),)

    def mamba_blocks(lead):
        return {"ln": layers.init_norm(cfg, cfg.d_model, dtype, dev, lead),
                "mixer": ssm.init_ssm(generator, cfg, dtype, lead)}

    if cfg.arch_type == "ssm":
        p["blocks"] = mamba_blocks((cfg.n_layers,))
        return p
    if cfg.arch_type == "encdec":
        p["enc_blocks"] = _init_block(generator, cfg, dtype,
                                      (cfg.n_enc_layers,), use_moe=False)
        p["enc_norm"] = layers.init_norm(cfg, cfg.d_model, dtype, dev)
        # each decoder layer: a plain block plus cross-attention over the
        # encoder's memory, behind its own norm
        dec = _init_block(generator, cfg, dtype, (cfg.n_layers,),
                          use_moe=False)
        dec["ln_x"] = layers.init_norm(cfg, cfg.d_model, dtype, dev,
                                       (cfg.n_layers,))
        dec["xattn"] = layers.init_attention(generator, cfg, dtype,
                                             (cfg.n_layers,))
        p["dec_blocks"] = dec
        return p
    if cfg.arch_type == "hybrid":
        period, n_groups, tail = _hybrid_layout(cfg)
        p["mamba_groups"] = mamba_blocks((n_groups, period))
        if tail:
            p["mamba_tail"] = mamba_blocks((tail,))
        # ONE shared attention + MLP block, run at the top of every group
        p["shared_attn"] = _init_block(generator, cfg, dtype, (),
                                       use_moe=False)
        return p
    if cfg.first_dense_layers:
        # DeepSeek's leading layers: a dense MLP of width d_ff, one
        # sub-layer a group
        p["dense_blocks"] = {"sub0": _init_block(
            generator, cfg, dtype, (cfg.first_dense_layers,), use_moe=False)}
    p["blocks"] = {f"sub{i}": _init_block(generator, cfg, dtype, lead,
                                          use_moe=cfg.is_moe)
                   for i in range(cfg.layers_per_scan)}
    if cfg.n_mtp:
        # the multi-token prediction head: one dense sub-layer over the
        # projected [norm(h_t); embed(token t+1)]
        p["mtp"] = {
            "proj": layers.dense_init(generator,
                                      (2 * cfg.d_model, cfg.d_model), 0,
                                      dtype),
            "block": _init_block(generator, cfg, dtype, (), use_moe=False),
            "norm": layers.init_norm(cfg, cfg.d_model, dtype, dev),
        }
    return p


def _embed(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=torch.float32).sqrt().to(
            x.dtype)
    return x


def _head(params, cfg: ModelConfig, h):
    """LM head; logits in f32."""
    if cfg.tie_embeddings:
        logits = layers.mm(h, params["embed"].T)
    else:
        logits = layers.mm(h, params["lm_head"])
    logits = logits.float()
    if cfg.final_logit_softcap:
        logits = layers._softcap(logits, cfg.final_logit_softcap)
    return logits


def _mamba_stack(stack, cfg: ModelConfig, x, n: int, collect_cache: bool,
                 collect_outs: bool = False):
    """x + ssm_forward(ln(x)) through the ``n`` stacked Mamba-2 blocks of
    ``stack``.  Returns (x, cache, outputs): with ``collect_cache`` the
    blocks' decode cache entries stacked on the block axis (else None),
    and with ``collect_outs`` each block's output (else empty).  Without ``collect_cache`` each block is
    rematerialised in the backward when ``cfg.remat``, as the
    reference's per-block ``jax.checkpoint``: a block's chunk
    intermediates live in its own backward only."""

    def block(x, bp):
        return x + ssm.ssm_forward(bp["mixer"], cfg,
                                   layers.apply_norm(bp["ln"], x))

    block = _maybe_remat(cfg, block)
    caches = {"state": [], "conv": []}
    outs = []
    for bp in _groups(stack, n):
        if collect_cache:
            out, c = ssm.ssm_forward(bp["mixer"], cfg,
                                     layers.apply_norm(bp["ln"], x),
                                     return_cache=True)
            x = x + out
            for k in caches:
                caches[k].append(c[k])
        else:
            x = block(x, bp)
        if collect_outs:
            outs.append(x)
    cache = ({k: torch.stack(v) for k, v in caches.items()}
             if collect_cache else None)
    return x, cache, outs


def _ssm_backbone(params, cfg: ModelConfig, x, collect_cache: bool,
                  collect_stages: bool = False):
    """The ssm family's blocks; the per-layer decode cache entries
    stacked on the layer axis when ``collect_cache``, and each layer's
    output stacked (n_layers, B, S, D) when ``collect_stages`` (else
    None)."""
    x, cache, outs = _mamba_stack(params["blocks"], cfg, x, cfg.n_layers,
                                  collect_cache, collect_stages)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stages = torch.stack(outs) if collect_stages else None
    return x, aux, (cache if collect_cache else {}), stages


def _hybrid_backbone(params, cfg: ModelConfig, x, positions,
                     collect_cache: bool, collect_stages: bool = False):
    """The shared attention block at the top of every group of ``period``
    Mamba-2 blocks, then, with a tail, once more before the tail's
    blocks.  Training rematerialises each group (the shared block and its
    Mamba-2 blocks) and, nested in it, each Mamba-2 block, as the
    reference does.  Returns (x, caches, stages): ``caches`` (with
    ``collect_cache``) holds the groups' shared-attention K/V as
    ``attn`` and their Mamba-2 entries as ``mamba``, stacked on the group
    axis, and with a tail ``tail_attn`` and ``tail``; ``stages`` each
    group's output (n_groups, B, S, D) with ``collect_stages``."""
    shared = params["shared_attn"]
    period, n_groups, tail = _hybrid_layout(cfg)

    def group_fn(x, gp):
        x, _, kv = _block_full(shared, cfg, x, positions, kind="full")
        x, mc, _ = _mamba_stack(gp, cfg, x, period, collect_cache)
        return (x, kv, mc) if collect_cache else x

    if not collect_cache:
        group_fn = _maybe_remat(cfg, group_fn)
    kvs, mcs, stages = [], [], []
    for gp in _groups(params["mamba_groups"], n_groups):
        if collect_cache:
            x, kv, mc = group_fn(x, gp)
            kvs.append(kv)
            mcs.append(mc)
        else:
            x = group_fn(x, gp)
        if collect_stages:
            stages.append(x)
    caches: Dict[str, Any] = {}

    def stack(entries):
        return {k: torch.stack([e[k] for e in entries]) for k in entries[0]}

    if collect_cache:
        caches = {"attn": stack(kvs), "mamba": stack(mcs)}
    if tail:
        x, _, kv = _block_full(shared, cfg, x, positions, kind="full")
        x, tc, _ = _mamba_stack(params["mamba_tail"], cfg, x, tail,
                                collect_cache)
        if collect_cache:
            caches["tail_attn"], caches["tail"] = kv, tc
    return x, caches, (torch.stack(stages) if collect_stages else None)


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def _encode(params, cfg: ModelConfig, frames):
    """The encoder over the stub frontend's frames (B, Ta, D), cast to the
    model's dtype: sinusoidal positions added, every block bidirectional
    (flash attention with ``causal=False`` on the kernel path), each
    rematerialised under ``cfg.remat_policy``, then ``enc_norm``.
    Returns (memory (B, Ta, D), its positions (B, Ta))."""
    B, Ta = frames.shape[:2]
    pos = _positions(B, Ta, frames.device)
    x = frames.to(_dtype(cfg))
    if cfg.pos_embedding == "sinusoidal":
        x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)

    def block(x, bp):
        return _block_full(bp, cfg, x, pos, kind="full", causal=False)[0]

    block = _maybe_remat(cfg, block)
    for bp in _groups(params["enc_blocks"], cfg.n_enc_layers):
        x = block(x, bp)
    return layers.apply_norm(params["enc_norm"], x), pos


def _cross_attend(bp, cfg: ModelConfig, x, pos, k, v, kpos, attend):
    """x + the cross-attention of x's queries over the memory's K/V
    (``attend(q, k, v, pos, kpos)``, a plain attention, as in the
    reference), behind ``ln_x``."""
    B, C = x.shape[:2]
    h = layers.apply_norm(bp["ln_x"], x)
    q = layers.attention_qkv(bp["xattn"], cfg, h, pos)[0]
    xa = attend(q, k, v, pos, kpos)
    return x + layers.mm(xa.reshape(B, C, -1), bp["xattn"]["wo"])


def _encdec_backbone(params, cfg: ModelConfig, batch, collect_cache: bool,
                     collect_stages: bool = False):
    """The encoder over ``batch["frames"]``, then the decoder over the
    tokens: per layer causal self-attention (flash attention on the
    kernel path), cross-attention over the memory through the plain
    ``chunked_attention``, the MLP.  Returns (x before the final norm,
    caches, stages): with ``collect_cache`` ``{"self", "cross"}`` (each
    ``{"k", "v"}`` stacked on the layer axis) and ``"memory"``; with
    ``collect_stages`` each decoder layer's output (n_layers, B, S, D).

    The encoder's blocks take ``cfg.remat_policy``; each decoder layer is
    rematerialised whole whatever the policy, as the reference's decoder
    body is a plain ``jax.checkpoint``."""
    memory, mpos = _encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = _positions(B, S, tokens.device)
    x = _embed(params, cfg, tokens)
    if cfg.pos_embedding == "sinusoidal":
        x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)

    def cross(q, k, v, qpos, kpos):
        return layers.chunked_attention(
            q, k, v, qpos, kpos, causal=False, q_chunk=cfg.attn_chunk_q,
            k_chunk=cfg.attn_chunk_k)

    def layer(x, bp, memory):
        h = layers.apply_norm(bp["ln1"], x)
        a, (k, v) = layers.attention_full(bp["attn"], cfg, h, pos, window=0,
                                          causal=True)
        _, mk, mv = layers.attention_qkv(bp["xattn"], cfg, memory, mpos)
        x = _cross_attend(bp, cfg, x + a, pos, mk, mv, mpos, cross)
        x = x + layers.apply_mlp(bp["mlp"], cfg,
                                 layers.apply_norm(bp["ln2"], x))
        if not collect_cache:
            return x
        return x, {"self": {"k": k, "v": v}, "cross": {"k": mk, "v": mv}}

    layer = _maybe_remat(cfg, layer, policy="nothing")
    entries, stages = [], []
    for bp in _groups(params["dec_blocks"], cfg.n_layers):
        if collect_cache:
            x, c = layer(x, bp, memory)
            entries.append(c)
        else:
            x = layer(x, bp, memory)
        if collect_stages:
            stages.append(x)
    caches: Dict[str, Any] = {}
    if collect_cache:
        caches = {n: {k: torch.stack([e[n][k] for e in entries])
                      for k in ("k", "v")} for n in ("self", "cross")}
        caches["memory"] = memory
    return x, caches, (torch.stack(stages) if collect_stages else None)


def _frontend_embed(params, cfg: ModelConfig, batch):
    """The input sequence (B, S, D): the embedded tokens, behind the VLM
    family's precomputed patch rows ``batch["patches"]`` (B, P, D), cast
    to the embeddings' dtype (the stub frontend: ``[patches | text]``)."""
    x = _embed(params, cfg, batch["tokens"])
    if cfg.arch_type == "vlm":
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def backbone(params, cfg: ModelConfig, batch: Dict[str, Any], *,
             collect_cache: bool = False, collect_stages: bool = False,
             mesh=None):
    """Full-sequence forward of every family.  Returns (final-normed
    hidden (B, S, D), aux loss (f32 scalar, 0 but for MoE), caches,
    stages) — ``caches`` is ``{"blocks": ...}`` (the hybrid family:
    ``_hybrid_backbone``'s entries) when ``collect_cache``, else empty;
    ``stages`` the per-group hidden states
    (n_groups, B, S, D) before the final norm, the representation stages
    the VAA distiller reads, when ``collect_stages``, else None.  The VLM
    family runs the dense stack over ``[patches | text]`` (S = P +
    S_txt, positions from 0 over both), so its hidden states keep the
    patch rows; the loss drops them.  The encoder-decoder family:
    ``_encdec_backbone`` (caches ``{"self", "cross", "memory"}``, stages
    the decoder layers').  ``mesh`` (``launch/mesh.py``) reaches the MoE
    sub-layers (``moe.apply_moe``); the other families have none."""
    _check_ported(cfg)
    if cfg.arch_type == "encdec":
        x, caches, stages = _encdec_backbone(params, cfg, batch,
                                             collect_cache, collect_stages)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return (layers.apply_norm(params["final_norm"], x), aux, caches,
                stages)
    x = _frontend_embed(params, cfg, batch)
    B, S = x.shape[:2]
    caches: Dict[str, Any] = {}
    if cfg.arch_type == "ssm":
        x, aux, c, stages = _ssm_backbone(params, cfg, x, collect_cache,
                                          collect_stages)
    elif cfg.arch_type == "hybrid":
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, caches, stages = _hybrid_backbone(params, cfg, x, positions,
                                             collect_cache, collect_stages)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return (layers.apply_norm(params["final_norm"], x), aux, caches,
                stages)
    else:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if "dense_blocks" in params:
            x, aux, dc, _ = _run_stack(params["dense_blocks"], cfg, x,
                                       positions, pattern=("full",),
                                       causal=True,
                                       collect_cache=collect_cache,
                                       mesh=mesh)
            if collect_cache:
                caches["dense_blocks"] = dc
        x, a, c, stages = _run_stack(params["blocks"], cfg, x, positions,
                                     pattern=cfg.attn_pattern, causal=True,
                                     collect_cache=collect_cache,
                                     collect_stages=collect_stages,
                                     mesh=mesh)
        aux = aux + a
    if collect_cache:
        caches["blocks"] = c
    return layers.apply_norm(params["final_norm"], x), aux, caches, stages


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def chunked_ce(params, cfg: ModelConfig, h, labels, mask):
    """Sequence-chunked CE: never materialises (B, S, V) logits at once.
    With ``cfg.use_kernels`` each chunk goes through the fused kd_loss
    kernel (``kd_ops.ce_from_hidden``), else through ``_head`` +
    logsumexp + gather.  Each chunk is rematerialised in the backward
    when ``cfg.remat``, as in the reference.

    Returns (sum_nll, sum_tokens, sum_correct) as f32 scalars.
    """
    B, S, D = h.shape
    C = min(cfg.loss_chunk, S)
    pad = (-S) % C
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    n = h.shape[1] // C

    def body(hh, ll, mm):
        if cfg.use_kernels:
            from repro_torch.kernels.kd_loss import ops as kd_ops
            w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
            nll, correct = kd_ops.ce_from_hidden(
                hh, w, ll, softcap=cfg.final_logit_softcap)
        else:
            logits = _head(params, cfg, hh)
            lse = torch.logsumexp(logits, dim=-1)
            # gather takes int64 indices
            gold = torch.gather(logits, -1, ll.long()[..., None])[..., 0]
            nll = lse - gold
            correct = (torch.argmax(logits, -1) == ll).float()
        mmf = mm.float()
        return (torch.sum(nll * mmf), torch.sum(mmf),
                torch.sum(correct * mmf))

    body = _maybe_remat(cfg, body)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    nll_s, tok_s, cor_s = zero, zero, zero
    for i in range(n):
        sl = slice(i * C, (i + 1) * C)
        a, b, c = body(h[:, sl], labels[:, sl], mask[:, sl])
        nll_s, tok_s, cor_s = nll_s + a, tok_s + b, cor_s + c
    return nll_s, tok_s, cor_s


def loss_fn(params, cfg: ModelConfig, batch, *, mesh=None):
    """Autoregressive LM loss (Eq. 2) plus the MoE load-balance loss and,
    with an MTP head, ``mtp_loss_weight`` times its loss.  Returns
    (loss + aux, metrics) with the reference's keys; ``aux_loss`` is 0
    but for the MoE family, ``mtp_loss`` present with an MTP head.
    ``mesh``: the MoE's expert-parallel paths (``backbone``)."""
    h, aux, _, _ = backbone(params, cfg, batch, mesh=mesh)
    labels = batch["labels"]
    if cfg.arch_type == "vlm":  # drop the patch positions
        h = h[:, -labels.shape[1]:]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll, tok, cor = chunked_ce(params, cfg, h, labels, mask)
    loss = nll / torch.clamp(tok, min=1.0)
    metrics = {"nll": nll, "tokens": tok,
               "accuracy": cor / torch.clamp(tok, min=1.0),
               "aux_loss": aux, "ce_loss": loss}
    if cfg.n_mtp and "mtp" in params:
        mtp_loss = _mtp_loss(params, cfg, h, batch)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + cfg.mtp_loss_weight * mtp_loss
    return loss + aux, metrics


def _mtp_step(params, cfg: ModelConfig, h, tokens, labels, j: int):
    """One MTP depth j: the head over [norm(h); embed(token i+j)] at each
    position i, its CE against label i+j (token i+j+1) through
    ``chunked_ce``.  The rolls wrap, so the last j+1 positions are
    masked out.  Returns (the head's hidden, mean NLL)."""
    B, S = tokens.shape
    mp = params["mtp"]
    emb = _embed(params, cfg, torch.roll(tokens, -j, 1))
    hin = layers.mm(torch.cat([layers.apply_norm(mp["norm"], h),
                               emb.to(h.dtype)], dim=-1), mp["proj"])
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    hout, _, _ = _block_full(mp["block"], cfg, hin, positions, kind="full")
    lab = torch.roll(labels, -j, 1)
    mask = torch.ones(lab.shape, dtype=torch.float32, device=lab.device)
    mask[:, -(j + 1):] = 0.0
    nll, tok, _ = chunked_ce(params, cfg, hout, lab, mask)
    return hout, nll / torch.clamp(tok, min=1.0)


def _mtp_loss(params, cfg: ModelConfig, h, batch):
    """DeepSeek-V3 multi-token prediction head (depth 1): predict t+2
    from the backbone's final-normed hidden at t and token t+1."""
    return _mtp_step(params, cfg, h, batch["tokens"], batch["labels"], 1)[1]


def mtp_chain_loss(params, cfg: ModelConfig, batch, *, depth: int,
                   mesh=None):
    """Teacher-forced chained MTP loss: the head at every depth
    ``1..depth``, fed its own output hidden back in (how the reference's
    ``_mtp_draft`` chains at inference).  Depth j at position i combines
    the depth j-1 hidden with the embedding of token i+j and predicts
    token i+j+1; the last j+1 positions are masked out.  Returns the
    mean NLL averaged over depths (depth 1 is ``_mtp_loss``)."""
    h, _, _, _ = backbone(params, cfg, batch, mesh=mesh)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(1, depth + 1):
        h, nll = _mtp_step(params, cfg, h, batch["tokens"], batch["labels"],
                           j)
        total = total + nll
    return total / depth


# ---------------------------------------------------------------------------
# serving: prefill + decode cache
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch, *, return_hidden=False,
            mesh=None):
    """Runs the full prompt, returns (last_token_logits (B, V) f32,
    cache) with the cache entries of every position.  ``return_hidden``
    packs the last position's final-normed hidden (B, D) beside the
    logits, ``((logits, h_last), cache)``, so a speculative engine can
    seed its first draft chain with it."""
    h, _, caches, _ = backbone(params, cfg, batch, collect_cache=True,
                               mesh=mesh)
    logits = _head(params, cfg, h[:, -1:])[:, 0]
    if return_hidden:
        return (logits, h[:, -1]), caches
    return logits, caches


def _attn_cache_struct(cfg: ModelConfig, lead, B: int, S: int, *, device,
                       policy=None):
    """One stacked attention cache entry: ``{"k", "v"}`` of shape
    (*lead, B, S, KH, Dh) at the policy's storage dtype, plus float32
    ``k_scale``/``v_scale`` of shape (*lead, B, S, KH) under a quantized
    policy (one scale per written row and kv head).  MLA: the latent
    ``{"ckv", "kr"}`` of shape (*lead, B, S, r) and (*lead, B, S, pr),
    with scales of shape (*lead, B, S)."""
    pol = policy or quant.CachePolicy()
    sd = pol.storage_dtype(_dtype(cfg))
    base = tuple(lead) + (B, S)
    if cfg.attn_type == "mla":
        shapes = {"ckv": base + (cfg.kv_lora_rank,),
                  "kr": base + (cfg.rope_head_dim,)}
    else:
        kv = base + (cfg.n_kv_heads, cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv}
    c = {key: torch.zeros(shape, dtype=sd, device=device)
         for key, shape in shapes.items()}
    if pol.quantized:
        for key in list(c):
            c[quant.scale_name(key)] = torch.zeros(
                c[key].shape[:-1], dtype=torch.float32, device=device)
    return c


def init_decode_cache(cfg: ModelConfig, B: int, S: int, *, device,
                      policy=None):
    """Zeroed contiguous cache for ``decode_step`` (capacity S): per
    sub-layer ``{"k", "v"}`` of shape (n_groups, B, S, KH, Dh) (MLA:
    ``{"ckv", "kr"}``, ``_attn_cache_struct``; with their scales under
    a quantized ``policy``), and a
    ``dense_blocks`` entry of the same form stacked over the leading
    dense layers; for the ssm
    family the recurrent ``state`` (n_layers, B, H, P, N) in f32 and the
    ``conv`` tail (n_layers, B, K-1, conv_dim), which have no sequence
    axis and ignore the policy: they are read whole every step, so
    quantizing them buys little and costs accuracy.  The hybrid family:
    ``mamba`` (n_groups, period, B, ...), ``attn`` with one entry per
    shared-attention application (n_groups, plus one with a tail), and
    with a tail ``tail`` (tail, B, ...).  The encoder-decoder family:
    the decoder's ``self`` entry of shape (n_layers, B, S, KH, Dh) under
    the policy, the ``cross`` K/V of the encoder's memory (n_layers, B,
    frontend_tokens, KH, Dh) and the ``memory`` (B, frontend_tokens, D),
    both in the model's dtype whatever the policy and without a
    sequence axis (like the recurrent state, read whole every step)."""
    _check_ported(cfg)

    def mamba(lead):
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {
            "state": torch.zeros(lead + (B, cfg.ssm_heads, cfg.ssm_head_dim,
                                         cfg.ssm_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (B, cfg.ssm_conv - 1, conv_dim),
                                dtype=_dtype(cfg), device=device)}

    if cfg.arch_type == "ssm":
        return {"blocks": mamba((cfg.n_layers,))}
    if cfg.arch_type == "encdec":
        Ta = cfg.frontend_tokens
        return {"self": _attn_cache_struct(cfg, (cfg.n_layers,), B, S,
                                           device=device, policy=policy),
                "cross": _attn_cache_struct(cfg, (cfg.n_layers,), B, Ta,
                                            device=device),
                "memory": torch.zeros((B, Ta, cfg.d_model),
                                      dtype=_dtype(cfg), device=device)}
    if cfg.arch_type == "hybrid":
        period, n_groups, tail = _hybrid_layout(cfg)
        c = {"mamba": mamba((n_groups, period)),
             "attn": _attn_cache_struct(cfg, (n_groups + (1 if tail else 0),),
                                        B, S, device=device, policy=policy)}
        if tail:
            c["tail"] = mamba((tail,))
        return c
    c = {"blocks": {
        f"sub{i}": _attn_cache_struct(cfg, (_n_groups(cfg),), B, S,
                                      device=device, policy=policy)
        for i in range(cfg.layers_per_scan)}}
    if cfg.first_dense_layers:
        c["dense_blocks"] = {"sub0": _attn_cache_struct(
            cfg, (cfg.first_dense_layers,), B, S, device=device,
            policy=policy)}
    return c


def decode_offset(cfg: ModelConfig) -> int:
    """Leading cache positions occupied by a modality frontend: the VLM
    family's ``frontend_tokens`` patch rows, 0 for every other family."""
    return cfg.frontend_tokens if cfg.arch_type == "vlm" else 0


def decode_capacity(cfg: ModelConfig, prompt_len: int, max_new: int) -> int:
    """Exact decode-cache capacity for a prompt + ``max_new`` generated
    tokens (the first of which is sampled from the prefill logits)."""
    return decode_offset(cfg) + prompt_len + max_new


def decode_pos0(cfg: ModelConfig, prompt_len: int) -> int:
    """First decode position after a ``prompt_len``-token prefill."""
    return decode_offset(cfg) + prompt_len


def graft_cache_entry(dst, src):
    """Copy a prefill cache entry into a (same-or-larger) decode entry,
    in place; returns ``dst``.

    Exactly one dim (the sequence axis) may differ between the decode
    and prefill entries; anything else is a caller bug and raises.
    """
    if dst.shape == src.shape:
        dst.copy_(src)
        return dst
    diff = [ax for ax, (a, b) in enumerate(zip(dst.shape, src.shape))
            if a != b]
    if dst.dim() != src.dim() or len(diff) != 1:
        raise ValueError(
            f"graft_cache_entry: decode cache {tuple(dst.shape)} and prefill "
            f"cache {tuple(src.shape)} differ in more than one dim — the "
            f"caches were built for different batch/model shapes")
    ax = diff[0]
    if src.shape[ax] > dst.shape[ax]:
        raise ValueError(
            f"graft_cache_entry: prefill length {src.shape[ax]} exceeds "
            f"decode cache capacity {dst.shape[ax]} (axis {ax})")
    dst.narrow(ax, 0, src.shape[ax]).copy_(src)
    return dst


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def prefill_into_cache(cfg: ModelConfig, decode_cache, prefill_cache):
    """Graft a ``prefill`` cache into a ``decode_step`` cache, in place,
    along the sequence axis of each stacked KV entry (``blocks`` and,
    with leading dense layers, ``dense_blocks``); the ssm family's state
    and conv tail are position-free and adopted whole.  The hybrid
    family adopts its Mamba-2 entries, grafts the groups' shared-attention
    K/V into the first n_groups entries of ``attn``, and folds the
    separately collected ``tail_attn`` into its last entry.  The
    encoder-decoder family grafts its decoder's ``self`` K/V and adopts
    ``cross`` and ``memory`` whole."""
    _check_ported(cfg)
    if cfg.arch_type != "hybrid":
        return _map(graft_cache_entry, decode_cache, prefill_cache)
    _map(graft_cache_entry, decode_cache["mamba"], prefill_cache["mamba"])
    n_groups = _hybrid_layout(cfg)[1]
    for k, dst in decode_cache["attn"].items():
        graft_cache_entry(dst[:n_groups], prefill_cache["attn"][k])
        if "tail" in decode_cache:
            graft_cache_entry(dst[n_groups], prefill_cache["tail_attn"][k])
    if "tail" in decode_cache:
        _map(graft_cache_entry, decode_cache["tail"], prefill_cache["tail"])
    return decode_cache


# ---------------------------------------------------------------------------
# serving: block-paged decode cache
# ---------------------------------------------------------------------------

def _axis_diff(a, b):
    """Tree of the one axis where two cache trees' leaves differ, or -1
    where they agree."""
    def axis(x, y):
        diff = [i for i, (p, q) in enumerate(zip(x.shape, y.shape)) if p != q]
        return diff[0] if diff else -1
    return _map(axis, a, b)


def decode_cache_batch_axes(cfg: ModelConfig, policy=None):
    """Tree of the batch-axis index of every decode-cache leaf,
    discovered by diffing two meta caches that differ only in B.
    ``policy`` must be the cache's: quantized policies add scale
    leaves."""
    return _axis_diff(init_decode_cache(cfg, 2, 8, device="meta",
                                        policy=policy),
                      init_decode_cache(cfg, 3, 8, device="meta",
                                        policy=policy))


def decode_cache_seq_axes(cfg: ModelConfig, policy=None):
    """Tree of the sequence-axis index of every decode-cache leaf, or -1
    for leaves with no growing sequence axis (the ssm state and conv
    tail): exactly the leaves that stay slot-resident when paged."""
    return _axis_diff(init_decode_cache(cfg, 2, 8, device="meta",
                                        policy=policy),
                      init_decode_cache(cfg, 2, 16, device="meta",
                                        policy=policy))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def has_paged_leaves(cfg: ModelConfig) -> bool:
    """False only for families whose whole decode state is per-slot
    recurrent (pure ssm): the paged engine then keeps no block pool."""
    return any(ax >= 0 for ax in _leaves(decode_cache_seq_axes(cfg)))


def init_paged_cache(cfg: ModelConfig, n_slots: int, n_blocks: int,
                     block_len: int, *, device, policy=None):
    """Block-paged decode cache.  Sequence-carrying leaves become pools:
    the contiguous (stacked..., B, S, ...) leaf turns into (stacked...,
    n_blocks, block_len, ...), block id b being row b of every pool (the
    scale leaves of a quantized ``policy`` too).  Leaves with no sequence
    axis (the ssm state and conv tail) keep a batch axis of ``n_slots``.
    Block 0 is the trash block: never allocated, it absorbs the writes of
    finished slots."""
    pool = init_decode_cache(cfg, n_blocks, block_len, device="meta",
                             policy=policy)
    slotted = init_decode_cache(cfg, n_slots, block_len, device="meta",
                                policy=policy)

    def make(p, s, ax):
        t = p if ax >= 0 else s
        return torch.zeros(t.shape, dtype=t.dtype, device=device)

    return _map(make, pool, slotted, decode_cache_seq_axes(cfg, policy))


def match_cache_policy(template, sub):
    """Re-structure a full-precision cache ``sub`` to the (possibly
    quantized) ``template``'s policy: data leaves with a ``_scale``
    sibling in the template are quantized along their trailing feature
    axis (write-time scales); everything else passes through.  Returns
    ``sub`` itself for unquantized templates."""
    pol = quant.policy_of(template)
    if not pol.quantized:
        return sub

    def walk(tmpl, src):
        if not isinstance(tmpl, dict):
            return src
        out = {}
        for key, tval in tmpl.items():
            if quant.is_scale_key(key):
                continue
            if isinstance(tval, dict):
                out[key] = walk(tval, src[key])
            elif quant.scale_name(key) in tmpl:
                q, s = quant.quantize(src[key], pol.kv_dtype)
                out[key] = q
                out[quant.scale_name(key)] = s
            else:
                out[key] = src[key]
        return out

    return walk(template, sub)


def scatter_prefill_paged(cfg: ModelConfig, paged_cache, sub, slot: int,
                          ids, mask, *, block_len: int):
    """Scatter a B=1 contiguous decode cache ``sub`` (already grafted via
    ``prefill_into_cache``, S = len(ids) * block_len) into the paged
    cache, in place: prompt block i lands in pool block ``ids[i]``, and
    slot-resident leaves in batch row ``slot``, overwritten whole.
    ``mask`` is False for blocks whose content is already pooled (prefix
    sharing); their writes go to the trash block 0 instead.

    ``sub`` is always the full-precision graft: under a quantized policy
    its KV leaves are quantized here, once, so a block's bytes are a pure
    function of its tokens, which prefix sharing relies on."""
    _check_ported(cfg)
    pol = quant.policy_of(paged_cache)
    sub = match_cache_policy(paged_cache, sub)
    ids = torch.as_tensor(ids, dtype=torch.long)
    mask = torch.as_tensor(mask, dtype=torch.bool)
    ids_eff = torch.where(mask, ids, torch.zeros_like(ids))

    def put(dst, src, bax, sax):
        if sax < 0:
            dst.select(bax, slot).copy_(src.select(bax, 0))
            return dst
        # the pools' layout: (stacked, n_blocks, block_len, ...)
        assert (bax, sax) == (1, 2), (bax, sax)
        s = src[:, 0]                                  # drop B
        s = s.reshape((s.shape[0], -1, block_len) + tuple(s.shape[2:]))
        dst[:, ids_eff.to(dst.device)] = s.to(dst.dtype)
        return dst

    return _map(put, paged_cache, sub, decode_cache_batch_axes(cfg, pol),
                decode_cache_seq_axes(cfg, pol))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def cache_nbytes(cfg: ModelConfig, B: int, S: int, policy=None) -> int:
    """Bytes of a contiguous (B, S) decode cache, summed per leaf at its
    own itemsize (a quantized cache mixes int8/fp8 KV with f32 scales).
    Allocates nothing."""
    return _nbytes(init_decode_cache(cfg, B, S, device="meta",
                                     policy=policy))


def paged_cache_nbytes(cfg: ModelConfig, n_slots: int, n_blocks: int,
                       block_len: int, policy=None) -> int:
    """Bytes of the paged cache: block pools + slot-resident leaves,
    summed per leaf at its own itemsize.  Allocates nothing."""
    return _nbytes(init_paged_cache(cfg, n_slots, n_blocks, block_len,
                                    device="meta", policy=policy))


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

def _ssm_step(bp, cfg: ModelConfig, x, bc, C: int, n_valid=None):
    """One Mamba-2 block: the O(1) recurrence for C=1, the SSD chunk path
    (state and conv carry, pads frozen by ``n_valid``) for C>1."""
    h = layers.apply_norm(bp["ln"], x)
    if C == 1:
        return ssm.ssm_decode(bp["mixer"], cfg, h, bc)
    return ssm.ssm_prefill_chunk(bp["mixer"], cfg, h, bc, n_valid)


def _mamba_decode(stack, cfg: ModelConfig, x, cache, n: int, n_valid=None):
    """x through the ``n`` stacked Mamba-2 blocks of ``stack``, each
    block's ``{"state", "conv"}`` row of ``cache`` stepped in place."""
    for i in range(n):
        bc = _layer(cache, i)
        out, nc = _ssm_step(_layer(stack, i), cfg, x, bc, x.shape[1],
                            n_valid)
        x = x + out
        for k in bc:
            bc[k].copy_(nc[k])
    return x


def _hybrid_decode(params, cfg: ModelConfig, x, pos, cache, *,
                   block_tables=None, write_tables=None, n_valid=None,
                   live=None):
    """The hybrid family's decode body: the shared block over ``attn``
    entry g at the top of group g, then the group's Mamba-2 blocks; with
    a tail, the shared block over the last ``attn`` entry, then the tail.
    ``n_valid`` reaches every Mamba-2 block of every group and of the
    tail.  The cache is stepped in place."""
    shared = params["shared_attn"]
    period, n_groups, tail = _hybrid_layout(cfg)
    kw = dict(kind="full", block_tables=block_tables,
              write_tables=write_tables, live=live)
    for g in range(n_groups):
        x, _ = _block_decode(shared, cfg, x, pos, _layer(cache["attn"], g),
                             **kw)
        x = _mamba_decode(_layer(params["mamba_groups"], g), cfg, x,
                          _layer(cache["mamba"], g), period, n_valid)
    if tail:
        x, _ = _block_decode(shared, cfg, x, pos,
                             _layer(cache["attn"], n_groups), **kw)
        x = _mamba_decode(params["mamba_tail"], cfg, x, cache["tail"], tail,
                          n_valid)
    return x


def _encdec_decode(params, cfg: ModelConfig, x, pos, cache, *,
                   block_tables=None, write_tables=None):
    """The encoder-decoder family's decode body: sinusoidal positions
    added, then per layer self-attention over ``self`` (written in place;
    the paged kernel on the kernel path with ``block_tables``), the
    cross-attention over the slot's ``cross`` K/V through the plain
    ``decode_attention`` (no causal mask), and the MLP."""
    B = x.shape[0]
    if cfg.pos_embedding == "sinusoidal":
        x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(x.dtype)
    kpos = _positions(B, cfg.frontend_tokens, x.device)

    def cross(q, k, v, qpos, kpos):
        return layers.decode_attention(q, k, v, qpos, kpos, causal=False)

    for i in range(cfg.n_layers):
        bp = _layer(params["dec_blocks"], i)
        h = layers.apply_norm(bp["ln1"], x)
        a, _ = layers.attention_decode(bp["attn"], cfg, h, pos,
                                       _layer(cache["self"], i), window=0,
                                       block_table=block_tables,
                                       write_table=write_tables)
        cc = _layer(cache["cross"], i)
        x = _cross_attend(bp, cfg, x + a, pos, cc["k"], cc["v"], kpos, cross)
        x = x + layers.apply_mlp(bp["mlp"], cfg,
                                 layers.apply_norm(bp["ln2"], x))
    return x


def _encdec_encode(params, cfg: ModelConfig, cache, frames) -> None:
    """Run the encoder over ``frames`` and write every decoder layer's
    cross K/V of its memory, and the memory, into the cache in place:
    the fixed-shape half of the family's chunked prefill, the same
    arithmetic as ``_encdec_backbone``'s."""
    memory, mpos = _encode(params, cfg, frames)
    for i in range(cfg.n_layers):
        _, mk, mv = layers.attention_qkv(
            _layer(params["dec_blocks"], i)["xattn"], cfg, memory, mpos)
        cache["cross"]["k"][i].copy_(mk)
        cache["cross"]["v"][i].copy_(mv)
    cache["memory"].copy_(memory)


def _chunk_hidden(params, cfg: ModelConfig, cache, x, pos, *,
                  block_tables=None, write_tables=None, n_valid=None,
                  live=None, mesh=None):
    """Shared decode / chunked-prefill body: pre-embedded inputs x
    (B, C, D) at positions pos (B, C) int32, written into (and attended
    against) the cache in place.  Returns (final-normed hidden (B, C, D),
    cache).

    C=1 is the decode step.  C>1 is one chunked-prefill chunk: attention
    needs no extra masking (per-query causal masks, and bucket-pad
    writes land past every real query's reach), but the Mamba-2
    recurrence integrates everything it sees, so ``n_valid`` (B,) freezes
    state and conv-tail updates at pad positions.  ``live`` (B, C) bool
    masks dead rows out of MoE routing; when omitted it is derived from
    ``n_valid``, so bucket pads are dead rows too.  Leading dense layers
    decode before ``blocks``.  The ssm family ignores positions and
    tables (its leaves are slot-resident); the hybrid family's shared
    attention reads and writes through them, as the encoder-decoder
    family's self-attention does (its cross K/V are slot-resident)."""
    _check_ported(cfg)
    C = x.shape[1]
    if live is None and n_valid is not None:
        live = (torch.arange(C, device=x.device)[None, :]
                < n_valid.to(x.device)[:, None])
    if cfg.arch_type == "ssm":
        x = _mamba_decode(params["blocks"], cfg, x, cache["blocks"],
                          cfg.n_layers, n_valid)
        return layers.apply_norm(params["final_norm"], x), cache
    if cfg.arch_type == "hybrid":
        x = _hybrid_decode(params, cfg, x, pos, cache,
                           block_tables=block_tables,
                           write_tables=write_tables, n_valid=n_valid,
                           live=live)
        return layers.apply_norm(params["final_norm"], x), cache
    if cfg.arch_type == "encdec":
        x = _encdec_decode(params, cfg, x, pos, cache,
                           block_tables=block_tables,
                           write_tables=write_tables)
        return layers.apply_norm(params["final_norm"], x), cache
    if "dense_blocks" in params:
        x, cache["dense_blocks"] = _decode_stack(
            params["dense_blocks"], cfg, x, pos, cache["dense_blocks"],
            pattern=("full",), block_tables=block_tables,
            write_tables=write_tables, live=live, mesh=mesh)
    x, cache["blocks"] = _decode_stack(
        params["blocks"], cfg, x, pos, cache["blocks"],
        pattern=cfg.attn_pattern, block_tables=block_tables,
        write_tables=write_tables, live=live, mesh=mesh)
    return layers.apply_norm(params["final_norm"], x), cache


def _overlap_ok(cfg: ModelConfig, mesh, B: int, block_tables) -> bool:
    """Gate for the EP-A2A overlapped decode step: contiguous-cache MoE
    decode through the a2a path on a "model" axis of more than one rank,
    and a batch that splits into two equal halves.  Paged caches are
    excluded: both halves would write the same trash block row."""
    if not (cfg.overlap_a2a and cfg.is_moe and block_tables is None):
        return False
    if cfg.moe_impl not in ("auto", "a2a"):
        return False
    if mesh is None or "model" not in rules.as_abstract(mesh).shape:
        return False
    return rules.as_abstract(mesh).shape["model"] > 1 and B >= 2 \
        and B % 2 == 0


def _decode_step_overlapped(params, cfg: ModelConfig, cache, x, pos, *,
                            mesh, live):
    """The decode body on two independent batch halves, each over its own
    rows of the cache (narrowed views: the writes land in place).  Expert
    capacity is computed per half (over B/2 rows), as in the reference,
    so under drops this is not the unsplit step.  The halves run one
    after the other with synchronous collectives: hiding one half's
    all-to-all under the other's attention is speed work for later."""
    B = x.shape[0]
    half = B // 2
    bat = decode_cache_batch_axes(cfg, policy=quant.policy_of(cache))

    def run(lo, hi):
        c = _map(lambda leaf, ax: leaf.narrow(ax, lo, hi - lo), cache, bat)
        lv = None if live is None else live[lo:hi]
        return _chunk_hidden(params, cfg, c, x[lo:hi], pos[lo:hi],
                             mesh=mesh, live=lv)[0]

    return torch.cat([run(0, half), run(half, B)]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *,
                block_tables=None, live=None, mesh=None):
    """One serving step: tokens (B, 1) at positions pos (B,).

    With ``block_tables`` (B, nbt) int32 the cache is the paged layout of
    ``init_paged_cache``, read and written through the tables.  ``live``
    (B,) bool marks rows holding real requests: freed slots are masked
    out of MoE routing (None: every row live).  ``mesh``: the MoE's
    expert-parallel paths; with ``cfg.overlap_a2a`` the step runs as two
    batch halves (``_overlap_ok``).  The cache is updated in place.
    Returns (logits (B, V) f32, cache).
    """
    x = _embed(params, cfg, tokens)
    pos = pos.to(torch.int32)[:, None]
    lv = None if live is None else live[:, None]
    if _overlap_ok(cfg, mesh, x.shape[0], block_tables):
        h, cache = _decode_step_overlapped(params, cfg, cache, x, pos,
                                           mesh=mesh, live=lv)
    else:
        h, cache = _chunk_hidden(params, cfg, cache, x, pos,
                                 block_tables=block_tables, live=lv,
                                 mesh=mesh)
    return _head(params, cfg, h)[:, 0], cache


def _zero_recurrent(cfg: ModelConfig, cache) -> None:
    """Zero the leaves without a sequence axis (the Mamba-2 state and
    conv tail, the encoder-decoder ``cross`` and ``memory``), in place."""
    seq = decode_cache_seq_axes(cfg, policy=quant.policy_of(cache))
    _map(lambda leaf, ax: leaf.zero_() if ax < 0 else leaf, cache, seq)


def prefill_chunked(params, cfg: ModelConfig, cache, batch, prompt_len, *,
                    chunk_len: int, block_tables=None, write_tables=None,
                    mesh=None):
    """Prefill a prompt THROUGH the decode cache in fixed-size chunks.

    ``batch["tokens"]`` (B, T_pad) is padded (any values) so that the
    input sequence, ``decode_offset(cfg) + T_pad``, is a multiple of
    ``chunk_len``; ``prompt_len`` (int or (B,)) is the true token count.
    The VLM family's ``batch["patches"]`` (B, P, D) lead the sequence,
    so the first chunks hold patch rows, and the real rows count them.
    The encoder-decoder family's ``batch["frames"]`` go through the
    encoder once, before the chunks, into the slot's ``cross`` K/V and
    ``memory`` (``_encdec_encode``); its chunks hold tokens alone.
    ``cache`` is a decode cache, updated in place: contiguous, or the
    paged slot view plus pools with ``block_tables`` (B, nbt) wide enough
    for every padded position, written through ``write_tables`` (default
    ``block_tables``).  Each chunk runs the shared ``_chunk_hidden``
    decode body, so prompt processing and decode are one code path; the
    chunks are a Python loop.

    Pad positions continue past the prompt: their attention writes land
    beyond every real query's causal reach (decode overwrites a position
    before attending to it), their contiguous writes past the cache's
    capacity are dropped (``layers.attention_decode``), their paged
    writes go through table rows pointing at the trash block, they are
    dead rows for MoE routing, and the ssm/hybrid recurrence is frozen
    for them (``n_valid``).  Recurrent leaves (no sequence axis) are
    zeroed first, so a reused slot's stale state never leaks into the
    new request.

    Returns (logits of the last real token (B, V) f32, cache).
    """
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, T_pad = tokens.shape
    offset = decode_offset(cfg)
    S_total = offset + T_pad
    C = chunk_len
    if S_total % C:
        raise ValueError(
            f"padded input length {S_total} (offset {offset} + tokens "
            f"{T_pad}) must be a multiple of chunk_len {C}")
    dev = tokens.device
    _zero_recurrent(cfg, cache)
    if cfg.arch_type == "encdec":
        _encdec_encode(params, cfg, cache, batch["frames"])
    x_full = _frontend_embed(params, cfg, batch)
    total_real = offset + torch.as_tensor(
        prompt_len, dtype=torch.int64, device=dev).reshape(-1).expand(B)
    rows = torch.arange(B, device=dev)
    ar = torch.arange(C, device=dev)
    h_last = torch.zeros((B, x_full.shape[-1]), dtype=x_full.dtype,
                         device=dev)
    for start in range(0, S_total, C):
        pos_c = (start + ar).to(torch.int32)[None].expand(B, C)
        n_valid = torch.clamp(total_real - start, 0, C)
        h, cache = _chunk_hidden(params, cfg, cache,
                                 x_full[:, start:start + C], pos_c,
                                 block_tables=block_tables,
                                 write_tables=write_tables, n_valid=n_valid,
                                 mesh=mesh)
        off = total_real - 1 - start
        here = (off >= 0) & (off < C)
        h_sel = h[rows, torch.clamp(off, 0, C - 1)]
        h_last = torch.where(here[:, None], h_sel, h_last)
    return _head(params, cfg, h_last[:, None])[:, 0], cache


def greedy_sample(stream, logits):
    """Default sampler: per-slot argmax (first index on ties); the
    stream is not read."""
    return torch.argmax(logits, -1).to(torch.int32)


def greedy_verify(stream, logits, draft):
    """Verify twin of ``greedy_sample``: emit the argmax of the target
    logits at a drafted position; the draft is accepted iff it matches,
    so the emitted stream is exactly the greedy stream."""
    tgt = torch.argmax(logits, -1).to(torch.int32)
    return tgt, tgt == draft


greedy_sample.verify = greedy_verify


def _verify_for(sampler):
    v = getattr(sampler, "verify", None)
    if v is None:
        raise ValueError(
            "speculative decode needs a sampler with a verify() method "
            "(see repro_torch.serve.sampling)")
    return v


def _mtp_draft(params, cfg: ModelConfig, h, tok, pos):
    """One inference-time MTP draft: the final-normed hidden ``h`` (B, D)
    of the position that emitted ``tok`` (B,) combined with the embedding
    of ``tok`` (``_mtp_step``'s combination), through the depth-1 MTP
    block at the single position ``pos`` (B,) (kernel 1 at S 1 on the
    card for a GQA block).  The head reuses the LM head without
    ``final_norm``, as training feeds the block's output to the CE.
    Returns (draft logits (B, V), the block's hidden for chaining)."""
    mp = params["mtp"]
    emb = _embed(params, cfg, tok[:, None])
    hin = layers.mm(torch.cat([layers.apply_norm(mp["norm"], h[:, None]),
                               emb.to(h.dtype)], dim=-1), mp["proj"])
    hout, _, _ = _block_full(mp["block"], cfg, hin, pos[:, None],
                             kind="full")
    return _head(params, cfg, hout)[:, 0], hout[:, 0]


def _spec_zero_rejected(cfg: ModelConfig, cache, pos, a, *, k: int,
                        block_tables=None) -> None:
    """Scrub, in place, the cache rows a verify chunk wrote for rejected
    drafts: per slot the positions ``pos + a .. pos + k`` (``a`` (B,) the
    kept length, at least 1), on every leaf with a sequence axis (K/V or
    MLA's latents, their scales, ``dense_blocks``), so the cache equals
    what token-by-token decode leaves.

    Contiguous: positions past the row's capacity were never written (the
    chunk's write drops them) and are dropped here too; the scatter
    rewrites kept rows with their own values (positions past capacity
    land on the slot's chunk position 0, which is always kept), so no
    host sync is needed.  Paged: zeros through the block tables, kept
    positions diverted to the trash block 0 (the tables' spare columns
    already point there past a slot's blocks)."""
    B = pos.shape[0]
    dev = pos.device
    jj = torch.arange(k + 1, device=dev)
    tgt = pos.long()[:, None] + jj[None, :]               # (B, k+1)
    rej = jj[None, :] >= a.long()[:, None]
    bidx = torch.arange(B, device=dev)[:, None].expand_as(tgt)
    pol = quant.policy_of(cache)
    if block_tables is not None:
        bl = next(leaf.shape[sax] for leaf, sax in zip(
            _leaves(cache), _leaves(decode_cache_seq_axes(cfg, pol)))
            if sax >= 0)
        blk, off = layers.paged_rows(block_tables.long(), tgt, bl)
        blk = torch.where(rej, blk, torch.zeros_like(blk))

    def zero(leaf, bax, sax):
        if sax < 0:
            return leaf
        # (slot or block, position, ...) view of the leaf
        view = leaf.movedim(bax, 0).movedim(sax if sax > bax else sax + 1, 1)
        if view.dtype.itemsize == 1:
            view = view.view(torch.uint8)   # int8 / fp8 codes: 0 is 0
        if block_tables is not None:
            view[blk, off] = 0
            return leaf
        cap = view.shape[1]
        inside = tgt < cap
        p = torch.clamp(torch.where(inside, tgt, tgt[:, :1]), max=cap - 1)
        rows = view[bidx, p]
        drop = (rej & inside).reshape(rej.shape + (1,) * (rows.dim() - 2))
        view[bidx, p] = torch.where(drop, torch.zeros_like(rows), rows)
        return leaf

    _map(zero, cache, decode_cache_batch_axes(cfg, pol),
         decode_cache_seq_axes(cfg, pol))


def _generate_spec(params, cfg: ModelConfig, cache, tok, pos, rem, done,
                   stream, h, eos: int, *, steps: int, k: int, sampler,
                   block_tables=None, mesh=None):
    """Self-speculative decode, a Python loop as ``generate``'s: each step
    drafts ``k`` tokens greedily with the MTP head (``_mtp_draft``
    chained), verifies all ``C = k+1`` positions in one chunk through the
    shared ``_chunk_hidden`` body (kernel 2 at C rows a slot when
    paged), and advances each slot by its accepted length (at least 1
    emission a live step, at most k+1).  Greedy acceptance is an exact
    argmax-prefix match, so the emitted stream equals token-by-token
    decode; stochastic samplers use residual rejection sampling
    (``sampler.verify``), chunk position j drawing from lane j of the
    step's stream.  ``h`` (B, D) is the final-normed hidden of the
    position that emitted each slot's pending token.  Rejected drafts'
    cache rows are scrubbed after acceptance; dead lanes keep chunk
    position 0, which is the write token-by-token decode repeats at the
    parked frontier, so the whole cache stays equal to it."""
    verify = _verify_for(sampler)
    B = tok.shape[0]
    C = k + 1
    dev = tok.device
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    toks_out, valid_out = [], []
    for i in range(steps):
        live = ~done
        st = stream.advance(i)
        drafts, dh, dt = [], h, tok
        for j in range(k):
            dlogits, dh = _mtp_draft(params, cfg, dh, dt,
                                     torch.clamp(pos - 1 + j, min=0))
            dt = torch.argmax(dlogits, -1).to(torch.int32)
            drafts.append(dt)
        chunk = torch.stack([tok] + drafts, dim=1)        # (B, C)
        cpos = pos[:, None] + ar[None, :]
        hc, cache = _chunk_hidden(params, cfg, cache,
                                  _embed(params, cfg, chunk), cpos,
                                  block_tables=block_tables,
                                  live=live[:, None].expand(B, C),
                                  mesh=mesh)
        logits = _head(params, cfg, hc)                   # (B, C, V)
        # position j's logits verify draft j+1 (j < k) or sample the
        # bonus token (j = k); a rejection emits the verifier's token and
        # ends the chain, so every live step emits at least once
        emit = live
        a = torch.zeros((B,), dtype=torch.int32, device=dev)
        new_tok, new_done = tok, done
        for j in range(C):
            if j < k:
                tj, acc = verify(st.at(j), logits[:, j], drafts[j])
            else:
                tj = sampler(st.at(j), logits[:, j]).to(torch.int32)
                acc = torch.zeros_like(live)
            valid = emit
            rem = rem - valid.to(torch.int32)
            stop = valid & ((tj == eos) | (rem <= 0))
            new_done = new_done | stop
            new_tok = torch.where(valid, tj, new_tok)
            a = a + valid.to(torch.int32)
            toks_out.append(tj)
            valid_out.append(valid)
            emit = emit & acc & ~stop
        new_h = hc[rows, torch.clamp(a - 1, 0, k).long()]
        h = torch.where(live[:, None], new_h, h)
        _spec_zero_rejected(cfg, cache, pos, torch.clamp(a, min=1), k=k,
                            block_tables=block_tables)
        pos = torch.where(live, pos + a, pos)
        tok, done = new_tok, new_done
    return {"tokens": torch.stack(toks_out, 1),
            "valid": torch.stack(valid_out, 1), "next_tok": tok, "pos": pos,
            "remaining": rem, "done": done, "rng": stream.advance(steps),
            "h_spec": h, "cache": cache}


def generate(params, cfg: ModelConfig, cache, first_tok, pos0, *, steps: int,
             sampler=None, rng=None, eos_id=None, remaining=None,
             return_logits: bool = False, block_tables=None,
             speculate: int = 0, spec_h=None, mesh=None):
    """Run ``steps`` decode steps, a Python loop over ``decode_step``.

    ``first_tok`` (B,) or (B, 1) is the token fed at ``pos0`` (B,) —
    normally the sampler applied to the prefill logits, so it is already
    emission #1 of the request; the loop emits ``steps`` more.  Per-slot
    state is carried exactly as the reference's scanned decode carries
    it: ``remaining`` emissions (slots with 0 start done and only
    produce discarded garbage), ``eos_id`` stopping, and finished slots
    stop advancing (their stale writes pin to one in-capacity position).
    ``sampler(stream, logits)`` draws from ``rng``, a
    ``utils.rng.Stream`` (default: keys of seed 0 and each row's
    index), which moves on by one step per decode step whether a slot is
    live or not, so a decode cut into segments samples as one long loop.

    The cache (contiguous, or paged with ``block_tables`` (B, nbt) fixed
    for the whole call) is updated IN PLACE; it is also returned under
    ``"cache"``.  Returns a dict with ``tokens``/``valid`` (B, steps),
    the carried ``next_tok``/``pos``/``remaining``/``done``/``rng`` and,
    when ``return_logits``, the per-step ``logits`` (B, steps, V).

    With ``speculate=k`` (> 0) each step drafts ``k`` tokens with the MTP
    head and verifies ``k+1`` positions in one chunk
    (``_generate_spec``): ``tokens``/``valid`` widen to (B, steps *
    (k+1)) and the result gains the carried ``h_spec`` (pass it back as
    ``spec_h`` to continue; zeros by default: a cold first draft is
    simply rejected).  Needs an MTP head (``cfg.n_mtp`` with
    ``params["mtp"]``: the dense, MoE and VLM families).  A paged table
    must be wide enough for ``pos + k`` (the engine adds spare trash
    columns).  ``mesh``: the MoE's expert-parallel paths (``decode_step``).
    """
    if sampler is None:
        sampler = greedy_sample
    B = first_tok.shape[0]
    dev = first_tok.device
    tok = first_tok.reshape(B).to(torch.int32)
    pos = torch.as_tensor(pos0, device=dev).reshape(B).to(torch.int32)
    if rng is None:
        rng = Stream.default(B, dev)
    if remaining is None:
        remaining = torch.full((B,), steps, dtype=torch.int32, device=dev)
    rem = torch.as_tensor(remaining, device=dev).reshape(B).to(torch.int32)
    done = rem <= 0
    eos = -1 if eos_id is None else int(eos_id)
    if block_tables is not None:
        block_tables = block_tables.to(torch.int32)
    if speculate:
        if return_logits:
            raise ValueError("return_logits is not supported with "
                             "speculative decode")
        if not (cfg.n_mtp and "mtp" in params):
            raise ValueError(
                "speculative decode needs an MTP head (cfg.n_mtp > 0 with "
                "params['mtp'] — dense/moe/vlm families only)")
        h = (torch.zeros((B, cfg.d_model), dtype=_dtype(cfg), device=dev)
             if spec_h is None else
             torch.as_tensor(spec_h, device=dev).to(_dtype(cfg)).reshape(
                 B, cfg.d_model))
        return _generate_spec(params, cfg, cache, tok, pos, rem, done, rng,
                              h, eos, steps=int(steps), k=int(speculate),
                              sampler=sampler, block_tables=block_tables,
                              mesh=mesh)
    toks, valid, all_logits = [], [], []
    for i in range(steps):
        live = ~done
        logits, cache = decode_step(params, cfg, cache, tok[:, None], pos,
                                    block_tables=block_tables, live=live,
                                    mesh=mesh)
        sampled = sampler(rng.advance(i), logits).to(torch.int32)
        rem = rem - live.to(torch.int32)
        done = done | (live & ((sampled == eos) | (rem <= 0)))
        tok = torch.where(live, sampled, tok)
        pos = torch.where(live, pos + 1, pos)
        toks.append(sampled)
        valid.append(live)
        if return_logits:
            all_logits.append(logits)
    res = {"tokens": torch.stack(toks, 1), "valid": torch.stack(valid, 1),
           "next_tok": tok, "pos": pos, "remaining": rem, "done": done,
           "rng": rng.advance(steps), "cache": cache}
    if return_logits:
        res["logits"] = torch.stack(all_logits, 1)
    return res
