"""Model assembly of the port: init / loss / prefill / decode, dense
and MoE families.

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
loss.  The MoE family trains and runs prefill; its decode (which takes
the reference's serving ``live`` mask) is not ported yet and raises, as
do DeepSeek's leading dense layers (``first_dense_layers``) and MTP.

Caches follow the reference's layout too.  Contiguous decode cache:
``blocks/sub{i}/{k,v}`` of shape (n_groups, B, S, KH, Dh).  Paged cache:
the same leaves as block pools (n_groups, n_blocks, block_len, KH, Dh);
block id b is row b of every pool, and block 0 is the trash block.
Decode writes these tensors in place (the reference returns new ones);
the functions still return the cache so call sites read the same.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers, moe
from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _window_for(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def _layer(tree, g: int):
    """Group ``g`` of a stacked tree: views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: _layer(v, g) for k, v in tree.items()}
    return tree[g]


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.layers_per_scan


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "moe") or cfg.attn_type != "gqa" \
            or cfg.n_mtp or cfg.first_dense_layers:
        raise NotImplementedError(
            f"{cfg.name} is not ported yet: only the dense and MoE GQA "
            "families without leading dense layers or MTP are")


def _check_decode(cfg: ModelConfig) -> None:
    _check_ported(cfg)
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE decode (with the serving live mask) is not "
            "ported yet")


# ---------------------------------------------------------------------------
# transformer block
# ---------------------------------------------------------------------------

def _init_block(generator, cfg: ModelConfig, dtype, lead):
    dev = layers._source(generator)[1]
    p: Dict[str, Any] = {
        "ln1": layers.init_norm(cfg, cfg.d_model, dtype, dev, lead),
        "ln2": layers.init_norm(cfg, cfg.d_model, dtype, dev, lead),
        "attn": layers.init_attention(generator, cfg, dtype, lead),
    }
    if cfg.is_moe:
        p["moe"] = moe.init_moe(generator, cfg, dtype, lead)
    else:
        p["mlp"] = layers.init_mlp(generator, cfg, cfg.d_model, cfg.d_ff,
                                   dtype, lead)
    if cfg.post_block_norm:
        p["ln1_post"] = layers.init_norm(cfg, cfg.d_model, dtype, dev, lead)
        p["ln2_post"] = layers.init_norm(cfg, cfg.d_model, dtype, dev, lead)
    return p


def _block_full(p, cfg: ModelConfig, x, positions, *, kind: str,
                causal: bool = True):
    """Full-sequence sub-layer.  Returns (x, aux, cache_entry): ``aux``
    is the MoE load-balance loss (0 for a dense sub-layer)."""
    window = _window_for(cfg, kind)
    h = layers.apply_norm(p["ln1"], x)
    attn_out, (k, v) = layers.attention_full(p["attn"], cfg, h, positions,
                                             window=window, causal=causal)
    if cfg.post_block_norm:
        attn_out = layers.apply_norm(p["ln1_post"], attn_out)
    x = x + attn_out
    h = layers.apply_norm(p["ln2"], x)
    if "moe" in p:
        ffn_out, aux = moe.apply_moe(p["moe"], cfg, h)
    else:
        ffn_out = layers.apply_mlp(p["mlp"], cfg, h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.post_block_norm:
        ffn_out = layers.apply_norm(p["ln2_post"], ffn_out)
    return x + ffn_out, aux, {"k": k, "v": v}


def _block_decode(p, cfg: ModelConfig, x, pos, cache, *, kind: str,
                  block_tables=None, write_tables=None):
    """Decode / chunk sub-layer.  x: (B, C, D), pos: (B, C) — C=1 is the
    single-token decode step.  ``cache`` is the layer's ``{"k", "v"}``
    (contiguous rows, or block pools when ``block_tables`` is given),
    updated in place.  Dense sub-layers only: MoE decode is not ported."""
    if "moe" in p:
        raise NotImplementedError("MoE decode is not ported yet")
    window = _window_for(cfg, kind)
    h = layers.apply_norm(p["ln1"], x)
    attn_out, cache = layers.attention_decode(
        p["attn"], cfg, h, pos, cache, window=window,
        block_table=block_tables, write_table=write_tables)
    if cfg.post_block_norm:
        attn_out = layers.apply_norm(p["ln1_post"], attn_out)
    x = x + attn_out
    h = layers.apply_norm(p["ln2"], x)
    ffn_out = layers.apply_mlp(p["mlp"], cfg, h)
    if cfg.post_block_norm:
        ffn_out = layers.apply_norm(p["ln2_post"], ffn_out)
    return x + ffn_out, cache


def _groups(tree, n: int):
    """The ``n`` per-group views of a stacked tree, from one
    ``torch.unbind`` per leaf: its backward stacks the groups' gradients
    in one step, where indexing each group would add a zero-padded
    full-size gradient per group."""
    if isinstance(tree, dict):
        per_key = {k: _groups(v, n) for k, v in tree.items()}
        return [{k: per_key[k][g] for k in tree} for g in range(n)]
    return torch.unbind(tree, 0)


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` rematerialised in the backward when ``cfg.remat``, as the
    reference's ``jax.checkpoint`` (non-reentrant
    ``torch.utils.checkpoint``: only the inputs are saved).  Without
    autograd (serving) there is no backward, and ``fn`` runs as is."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "dots":
        raise NotImplementedError('remat_policy="dots" is not ported yet')

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return run


def _run_stack(blocks, cfg: ModelConfig, x, positions, *, pattern,
               causal: bool, collect_cache: bool):
    """Loop over the stacked groups of sub-layers (full sequence), each
    group rematerialised in the backward when ``cfg.remat``.  Returns
    (x, aux, caches): ``aux`` the MoE load-balance losses summed per
    group (through the remat, as the reference's scan carries it), and
    the per-layer k/v stacked on the group axis (an empty dict unless
    ``collect_cache``)."""
    n = next(iter(blocks["sub0"]["ln1"].values())).shape[0]

    def group_fn(x, gp):
        kvs = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, kind in enumerate(pattern):
            x, a, kv = _block_full(gp[f"sub{i}"], cfg, x, positions,
                                   kind=kind, causal=causal)
            aux = aux + a
            kvs.append(kv)
        return x, aux, (kvs if collect_cache else [])

    group_fn = _maybe_remat(cfg, group_fn)
    per_sub = {f"sub{i}": {"k": [], "v": []} for i in range(len(pattern))}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp in _groups(blocks, n):
        x, a, kvs = group_fn(x, gp)
        aux = aux + a
        for i, kv in enumerate(kvs):
            per_sub[f"sub{i}"]["k"].append(kv["k"])
            per_sub[f"sub{i}"]["v"].append(kv["v"])
    if not collect_cache:
        return x, aux, {}
    return x, aux, {s: {k: torch.stack(v) for k, v in e.items()}
                    for s, e in per_sub.items()}


def _decode_stack(blocks, cfg: ModelConfig, x, pos, cache, *, pattern,
                  block_tables=None, write_tables=None):
    n = next(iter(blocks["sub0"]["ln1"].values())).shape[0]
    for g in range(n):
        gp, gc = _layer(blocks, g), _layer(cache, g)
        for i, kind in enumerate(pattern):
            x, _ = _block_decode(gp[f"sub{i}"], cfg, x, pos, gc[f"sub{i}"],
                                 kind=kind, block_tables=block_tables,
                                 write_tables=write_tables)
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
    p["blocks"] = {f"sub{i}": _init_block(generator, cfg, dtype, lead)
                   for i in range(cfg.layers_per_scan)}
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
        logits = h @ params["embed"].T
    else:
        logits = h @ params["lm_head"]
    logits = logits.float()
    if cfg.final_logit_softcap:
        logits = layers._softcap(logits, cfg.final_logit_softcap)
    return logits


def backbone(params, cfg: ModelConfig, batch: Dict[str, Any], *,
             collect_cache: bool = False):
    """Full-sequence forward of the dense and MoE families.  Returns
    (final-normed hidden (B, S, D), aux loss (f32 scalar, 0 for dense),
    caches) — ``caches`` is ``{"blocks": ...}`` when ``collect_cache``,
    else empty."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = _embed(params, cfg, tokens)
    x, aux, c = _run_stack(params["blocks"], cfg, x, positions,
                           pattern=cfg.attn_pattern, causal=True,
                           collect_cache=collect_cache)
    caches = {"blocks": c} if collect_cache else {}
    return layers.apply_norm(params["final_norm"], x), aux, caches


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


def loss_fn(params, cfg: ModelConfig, batch):
    """Autoregressive LM loss (Eq. 2) plus the MoE load-balance loss.
    Returns (loss + aux, metrics) with the reference's keys; ``aux_loss``
    is 0 for the dense family."""
    h, aux, _ = backbone(params, cfg, batch)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    nll, tok, cor = chunked_ce(params, cfg, h, labels, mask)
    loss = nll / torch.clamp(tok, min=1.0)
    metrics = {"nll": nll, "tokens": tok,
               "accuracy": cor / torch.clamp(tok, min=1.0),
               "aux_loss": aux, "ce_loss": loss}
    return loss + aux, metrics


# ---------------------------------------------------------------------------
# serving: prefill + decode cache
# ---------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, batch):
    """Runs the full prompt, returns (last_token_logits (B, V) f32,
    cache) with the cache entries of every position."""
    h, _, caches = backbone(params, cfg, batch, collect_cache=True)
    return _head(params, cfg, h[:, -1:])[:, 0], caches


def init_decode_cache(cfg: ModelConfig, B: int, S: int, *, device):
    """Zeroed contiguous cache for ``decode_step`` (capacity S): per
    sub-layer ``{"k", "v"}`` of shape (n_groups, B, S, KH, Dh)."""
    _check_decode(cfg)
    shape = (_n_groups(cfg), B, S, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"blocks": {
        f"sub{i}": {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
                    "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}
        for i in range(cfg.layers_per_scan)}}


def decode_offset(cfg: ModelConfig) -> int:
    """Leading cache positions occupied by a modality frontend (VLM
    patches); 0 for every ported family."""
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


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def prefill_into_cache(cfg: ModelConfig, decode_cache, prefill_cache):
    """Graft a ``prefill`` cache into a ``decode_step`` cache along the
    sequence axis of each stacked KV entry (dense family)."""
    _check_decode(cfg)
    return {"blocks": _map2(graft_cache_entry, decode_cache["blocks"],
                            prefill_cache["blocks"])}


# ---------------------------------------------------------------------------
# serving: block-paged decode cache
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_len: int, *,
                     device):
    """Block-paged decode cache: every leaf of the dense family carries
    a sequence axis, so each becomes a pool (n_groups, n_blocks,
    block_len, KH, Dh); the reference's slot-resident leaves (recurrent
    state, cross KV) belong to families not ported yet.  Block 0 is the
    trash block: never allocated, it absorbs the writes of finished
    slots."""
    return init_decode_cache(cfg, n_blocks, block_len, device=device)


def scatter_prefill_paged(cfg: ModelConfig, paged_cache, sub, ids, mask, *,
                          block_len: int):
    """Scatter a B=1 contiguous decode cache ``sub`` (already grafted via
    ``prefill_into_cache``, S = len(ids) * block_len) into the pools, in
    place: prompt block i lands in pool block ``ids[i]``.  ``mask`` is
    False for blocks whose content is already pooled (prefix sharing);
    their writes go to the trash block 0 instead."""
    _check_decode(cfg)
    ids = torch.as_tensor(ids, dtype=torch.long)
    mask = torch.as_tensor(mask, dtype=torch.bool)
    ids_eff = torch.where(mask, ids, torch.zeros_like(ids))

    def put(dst, src):
        s = src[:, 0]                                  # drop B
        s = s.reshape((s.shape[0], -1, block_len) + tuple(s.shape[2:]))
        dst[:, ids_eff.to(dst.device)] = s.to(dst.dtype)
        return dst

    return {"blocks": _map2(put, paged_cache["blocks"], sub["blocks"])}


# ---------------------------------------------------------------------------
# serving: decode
# ---------------------------------------------------------------------------

def _chunk_hidden(params, cfg: ModelConfig, cache, x, pos, *,
                  block_tables=None, write_tables=None):
    """Shared decode body: pre-embedded inputs x (B, C, D) at positions
    pos (B, C) int32, written into (and attended against) the cache in
    place.  Returns (final-normed hidden (B, C, D), cache)."""
    _check_decode(cfg)
    x, cache["blocks"] = _decode_stack(
        params["blocks"], cfg, x, pos, cache["blocks"],
        pattern=cfg.attn_pattern, block_tables=block_tables,
        write_tables=write_tables)
    return layers.apply_norm(params["final_norm"], x), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *,
                block_tables=None):
    """One serving step: tokens (B, 1) at positions pos (B,).

    With ``block_tables`` (B, nbt) int32 the cache is the paged layout of
    ``init_paged_cache``, read and written through the tables.  The cache
    is updated in place.  Returns (logits (B, V) f32, cache).
    """
    x = _embed(params, cfg, tokens)
    h, cache = _chunk_hidden(params, cfg, cache, x,
                             pos.to(torch.int32)[:, None],
                             block_tables=block_tables)
    return _head(params, cfg, h)[:, 0], cache


def greedy_sample(logits):
    """Default sampler: per-slot argmax (first index on ties)."""
    return torch.argmax(logits, -1).to(torch.int32)


def generate(params, cfg: ModelConfig, cache, first_tok, pos0, *, steps: int,
             sampler=None, eos_id=None, remaining=None,
             return_logits: bool = False, block_tables=None):
    """Run ``steps`` decode steps, a Python loop over ``decode_step``.

    ``first_tok`` (B,) or (B, 1) is the token fed at ``pos0`` (B,) —
    normally the sampler applied to the prefill logits, so it is already
    emission #1 of the request; the loop emits ``steps`` more.  Per-slot
    state is carried exactly as the reference's scanned decode carries
    it: ``remaining`` emissions (slots with 0 start done and only
    produce discarded garbage), ``eos_id`` stopping, and finished slots
    stop advancing (their stale writes pin to one in-capacity position).

    The cache (contiguous, or paged with ``block_tables`` (B, nbt) fixed
    for the whole call) is updated IN PLACE; it is also returned under
    ``"cache"``.  Returns a dict with ``tokens``/``valid`` (B, steps),
    the carried ``next_tok``/``pos``/``remaining``/``done`` and, when
    ``return_logits``, the per-step ``logits`` (B, steps, V).
    """
    if sampler is None:
        sampler = greedy_sample
    B = first_tok.shape[0]
    dev = first_tok.device
    tok = first_tok.reshape(B).to(torch.int32)
    pos = torch.as_tensor(pos0, device=dev).reshape(B).to(torch.int32)
    if remaining is None:
        remaining = torch.full((B,), steps, dtype=torch.int32, device=dev)
    rem = torch.as_tensor(remaining, device=dev).reshape(B).to(torch.int32)
    done = rem <= 0
    eos = -1 if eos_id is None else int(eos_id)
    if block_tables is not None:
        block_tables = block_tables.to(torch.int32)
    toks, valid, all_logits = [], [], []
    for _ in range(steps):
        live = ~done
        logits, cache = decode_step(params, cfg, cache, tok[:, None], pos,
                                    block_tables=block_tables)
        sampled = sampler(logits).to(torch.int32)
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
           "cache": cache}
    if return_logits:
        res["logits"] = torch.stack(all_logits, 1)
    return res
