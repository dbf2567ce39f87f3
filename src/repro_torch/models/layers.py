"""Core neural layers of the port: norms, RoPE and sinusoidal positions,
GQA and MLA attention, MLPs.

Counterpart of ``repro.models.layers`` (GQA with the quantized KV cache,
and DeepSeek-V3's multi-head latent attention with its quantized latent
cache).  Pure functions over explicit parameter dicts with the
reference's keys and ``(in, out)`` weight matrices, used as ``x @ W``.
GQA attention has two execution paths:

* plain PyTorch: ``chunked_attention`` (online softmax over chunks) for
  full sequences and ``decode_attention`` (dense scores over a cache
  view) for decode;
* the hand-written CUDA kernels of ``repro_torch.kernels``, selected
  with ``cfg.use_kernels``: flash attention for full sequences, paged
  attention for the block-paged decode cache.

MLA takes the plain path whatever ``cfg.use_kernels`` says, as the
reference does: ``mla_full`` attends through ``chunked_attention``
(query/key width nope + rope differs from the value width), and
``mla_decode`` attends in the latent space with the absorbed matrices
over the contiguous cache or a block-table gather of the pools.

Where the reference returns an updated cache, the port writes the
cache tensors in place and returns the same objects.  Matrix products go
through ``mm``, which promotes mixed dtypes as JAX does: a ``bf16`` or
``fp32`` cache policy other than the model's dtype hands attention
outputs in the cache's dtype to the output projection, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import quant
from repro_torch.models.config import ModelConfig

NEG_INF = -1.0e30


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def _source(generator):
    """(torch.Generator or None, device) of an init call: ``generator`` is
    a seeded ``torch.Generator`` (tensors land on its device), or the
    meta device, which gives shapes and dtypes without drawing."""
    if isinstance(generator, torch.Generator):
        return generator, generator.device
    dev = torch.device(generator)
    if dev.type != "meta":
        raise ValueError(f"init needs a torch.Generator, got {generator!r}")
    return None, dev


def dense_init(generator, shape: Tuple[int, ...], in_axis: int = 0,
               dtype=torch.float32, lead=()):
    """Truncated-normal fan-in init (LeCun-style), stored in model dtype.
    ``lead`` prepends stacked group axes that do not count as fan-in."""
    gen, dev = _source(generator)
    std = 1.0 / math.sqrt(max(shape[in_axis], 1))
    t = torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32,
                    device=dev)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
    # scaled in place: the f32 draw is the init's largest transient
    return t.mul_(std).to(dtype)


def embed_init(generator, shape, dtype=torch.float32):
    gen, dev = _source(generator)
    t = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=dev)
    return (t * 0.02).to(dtype)


def mm(a, b):
    """``a @ b``, both operands first promoted to their common dtype
    (torch refuses mixed dtypes where JAX promotes)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, dtype, device, lead=()):
    shape = tuple(lead) + (d,)
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def apply_norm(p, x, eps: float = 1e-6):
    """RMSNorm or LayerNorm, computed in f32 and cast back to x's dtype."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# position embeddings: rotary and sinusoidal
# ---------------------------------------------------------------------------

def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Computed in f32 and cast back to x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions.float()[..., None] * freqs   # (..., S, half)
    cos = torch.cos(angles)[..., None, :]           # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d: int):
    """Sinusoidal position embeddings (..., d) in f32: ``[sin | cos]`` of
    ``positions`` (...) times ``d // 2`` geometric frequencies."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                      * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# masking helpers
# ---------------------------------------------------------------------------

def _mask_bias(q_pos, k_pos, *, causal: bool, window: int):
    """Additive bias (..., Sq, Sk) from absolute positions. k_pos < 0 = pad."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _softcap(s, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(s / cap) * cap
    return s


# ---------------------------------------------------------------------------
# plain attention
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      scale: Optional[float] = None, q_chunk: int = 1024,
                      k_chunk: int = 1024, skip_masked_chunks: bool = False):
    """q: (B,Sq,H,Dq)  k: (B,Sk,KH,Dq)  v: (B,Sk,KH,Dv)  ->  (B,Sq,H,Dv).

    Never materialises (Sq, Sk); accumulates in f32 with a running
    max/denominator (online softmax).  With ``skip_masked_chunks`` the
    chunk pairs that are fully masked (above the causal diagonal, or
    outside the sliding window) are skipped.
    """
    B, Sq, H, Dq = q.shape
    _, Sk, KH, _ = k.shape
    Dv = v.shape[-1]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(Dq)
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    Sq_p, Sk_p = -(-Sq // qc) * qc, -(-Sk // kc) * kc
    q = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    k = F.pad(k, (0, 0, 0, 0, 0, Sk_p - Sk))
    v = F.pad(v, (0, 0, 0, 0, 0, Sk_p - Sk))
    q_pos = F.pad(q_pos, (0, Sq_p - Sq), value=0)
    k_pos = F.pad(k_pos, (0, Sk_p - Sk), value=-1)
    nq, nk = Sq_p // qc, Sk_p // kc
    qr = q.reshape(B, nq, qc, KH, G, Dq).permute(1, 0, 3, 4, 2, 5).float()
    kr = k.reshape(B, nk, kc, KH, Dq).permute(1, 0, 3, 2, 4).float()
    vr = v.reshape(B, nk, kc, KH, Dv).permute(1, 0, 3, 2, 4).float()
    qp = q_pos.reshape(B, nq, qc).permute(1, 0, 2)
    kp = k_pos.reshape(B, nk, kc).permute(1, 0, 2)

    outs = []
    for qi in range(nq):
        m = torch.full((B, KH, G, qc), NEG_INF, device=q.device)
        l = torch.zeros((B, KH, G, qc), device=q.device)
        o = torch.zeros((B, KH, G, qc, Dv), device=q.device)
        for ki in range(nk):
            if skip_masked_chunks:
                if causal and ki * kc > qi * qc + qc - 1:
                    continue  # entirely above the causal diagonal
                if window and (ki * kc + kc - 1) <= (qi * qc - window):
                    continue  # entirely left of every query's window
            s = torch.einsum("bhgqd,bhkd->bhgqk", qr[qi], kr[ki]) * scale
            s = _softcap(s, softcap)
            bias = _mask_bias(qp[qi], kp[ki], causal=causal, window=window)
            s = s + bias[:, None, None]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                   vr[ki])
            m = m_new
        outs.append(o / l.clamp_min(1e-30)[..., None])
    # (nq, B, KH, G, qc, Dv) -> (B, Sq, H, Dv)
    out = torch.stack(outs, 0).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq_p, H,
                                                                 Dv)
    return out[:, :Sq].to(v.dtype)


def decode_attention(q, k_cache, v_cache, q_pos, k_pos, *, window: int = 0,
                     softcap: float = 0.0, scale: Optional[float] = None,
                     causal: bool = True):
    """Decode/chunk attention.  q: (B,C,H,Dq); caches: (B,S,KH,D*).

    C is 1 for single-token decode; a C-token chunk attends against the
    same cache view with per-query positional masking."""
    B, C, H, Dq = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(Dq)
    qr = q.reshape(B, C, KH, G, Dq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
    s = s + bias[:, None, None]
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.float())
    return o.reshape(B, C, H, v_cache.shape[-1]).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def init_attention(generator, cfg: ModelConfig, dtype, lead=()):
    D, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    Dh = cfg.resolved_head_dim
    p = {
        "wq": dense_init(generator, (D, H * Dh), 0, dtype, lead),
        "wk": dense_init(generator, (D, KH * Dh), 0, dtype, lead),
        "wv": dense_init(generator, (D, KH * Dh), 0, dtype, lead),
        "wo": dense_init(generator, (H * Dh, D), 0, dtype, lead),
    }
    if cfg.qk_norm:
        dev = _source(generator)[1]
        p["q_norm"] = {"scale": torch.ones(tuple(lead) + (Dh,), dtype=dtype,
                                           device=dev)}
        p["k_norm"] = {"scale": torch.ones(tuple(lead) + (Dh,), dtype=dtype,
                                           device=dev)}
    return p


def attention_qkv(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = mm(x, p["wq"]).reshape(B, S, H, Dh)
    k = mm(x, p["wk"]).reshape(B, S, KH, Dh)
    v = mm(x, p["wv"]).reshape(B, S, KH, Dh)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q)
        k = apply_norm(p["k_norm"], k)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_full(p, cfg: ModelConfig, x, positions, *, window: int,
                   causal: bool = True):
    """Full-sequence (prefill) attention.  Returns (out, (k, v))."""
    q, k, v = attention_qkv(p, cfg, x, positions)
    if cfg.use_kernels:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     softcap=cfg.attn_logit_softcap)
    else:
        out = chunked_attention(
            q, k, v, positions, positions, causal=causal, window=window,
            softcap=cfg.attn_logit_softcap, q_chunk=cfg.attn_chunk_q,
            k_chunk=cfg.attn_chunk_k,
            skip_masked_chunks=cfg.attn_skip_masked_chunks)
    B, S = x.shape[:2]
    return mm(out.reshape(B, S, -1), p["wo"]), (k, v)


def paged_rows(block_table, pos, block_len: int):
    """(block ids, offsets), each (B, C), of logical positions ``pos``
    (B, C) under (B, nbt) block tables: where ``paged_insert`` writes."""
    bidx = torch.arange(pos.shape[0], device=pos.device)[:, None]
    blk = block_table[bidx, torch.div(pos, block_len, rounding_mode="floor")]
    return blk, pos % block_len


def paged_insert(pool, block_table, pos, entry):
    """Scatter C tokens' cache entries into a block pool, in place.

    pool: (n_blocks, block_len, ...); entry (B, C, ...) at logical
    positions ``pos`` (B, C): position p lives in pool row
    ``block_table[b, p // block_len]`` at offset ``p % block_len``.  The
    engine keeps the write-frontier blocks of every live slot uniquely
    owned and points dead slots at the trash block 0 (their duplicate
    writes to row (0, 0) are harmless: nothing reads it as live content).
    ``pos // block_len`` must stay inside the table: indexing raises
    there, where the reference's gathers would clamp.  Returns ``pool``.
    """
    blk, off = paged_rows(block_table, pos, pool.shape[1])
    pool[blk, off] = entry.to(pool.dtype)
    return pool


def paged_gather(pool, block_table):
    """Assemble per-slot contiguous views from a block pool.

    (n_blocks, block_len, ...) gathered through (B, nbt) block tables →
    (B, nbt*block_len, ...): gathered index j IS logical position j.
    """
    B = block_table.shape[0]
    return pool[block_table.long()].reshape((B, -1) + tuple(pool.shape[2:]))


def _write_cache(cache, new, pos, write_table=None):
    """Write one call's cache entries ``new`` ({leaf: (B, C, ...)}) at
    logical positions ``pos`` (B, C), in place: contiguous rows
    (``write_table`` None), where a chunked prefill's positions past the
    capacity (bucket pads) are dropped, as the reference's scatter drops
    out-of-range rows (a boolean selection: one host sync a chunk and
    layer); or the block pools through ``write_table``, the pool rows
    found once for every leaf."""
    cap = cache[next(iter(new))].shape[1]
    if write_table is not None:
        rows, cols = paged_rows(write_table, pos, cap)
    else:
        B, C = pos.shape
        rows = torch.arange(B, device=pos.device)[:, None].expand(B, C)
        cols = pos
        if C > 1:
            keep = pos < cap
            rows, cols = rows[keep], pos[keep]
            new = {key: val[keep] for key, val in new.items()}
    for key, val in new.items():
        cache[key][rows, cols] = val.to(cache[key].dtype)


def paged_read_path(cfg: ModelConfig, attn: str = "gqa") -> str:
    """Which paged-attention read path serves a call: ``"kernel"`` (the
    CUDA block-table kernel, any chunk width) or ``"gather"`` (the
    block-table gather and dense scores).  MLA's latent cache always
    attends through the gather (the absorbed-matrix path)."""
    if attn == "mla":
        return "gather"
    return "kernel" if cfg.use_kernels else "gather"


def attention_decode(p, cfg: ModelConfig, x, pos, cache, *, window: int,
                     block_table=None, write_table=None):
    """Decode / chunk attention.  x: (B,C,D), pos: (B,C) int32.

    All C k/v entries are written into the cache first, then the C
    queries attend over the updated view with per-query causal (and
    window) masking.  ``cache`` is the layer's ``{"k", "v"}`` dict, plus
    ``{"k_scale", "v_scale"}`` under a quantized ``CachePolicy``: k/v
    are then quantized at write time (so the same tokens always give the
    same block bytes), the gather path dequantizes the attended view to
    x's dtype, and the kernel takes the scales and dequantizes each row
    in registers.  One-shot prefill never sees the quantized cache; a
    chunked prefill's queries attend over the quantized rows the prompt's
    earlier chunks (and their own) wrote, as in the reference.

    Contiguous (``block_table=None``): caches (B,Smax,KH,Dh), written at
    ``pos``; positions >= Smax (a chunked prefill's bucket pads) are not
    written.  Paged: caches are block pools (n_blocks,block_len,KH,Dh),
    written through ``write_table`` (defaults to ``block_table``) and
    read through ``block_table`` by the kernel or the gather.  The cache
    tensors are updated in place; returns (out, cache).
    """
    B, C = x.shape[:2]
    q, k, v = attention_qkv(p, cfg, x, pos)
    quantized = "k_scale" in cache
    new = {"k": k, "v": v}
    if quantized:
        # k and v in one call (half the launches): the arithmetic is per
        # row, so codes and scales are those of two calls
        codes, scales = quant.quantize(torch.stack([k, v]),
                                       quant.kv_dtype_of_leaf(cache["k"]))
        new = {"k": codes[0], "v": codes[1], "k_scale": scales[0],
               "v_scale": scales[1]}
    if block_table is None:
        _write_cache(cache, new, pos)
        kg, vg = cache["k"], cache["v"]
        if quantized:
            kg = quant.dequantize(kg, cache["k_scale"], x.dtype)
            vg = quant.dequantize(vg, cache["v_scale"], x.dtype)
    else:
        _write_cache(cache, new, pos, block_table if write_table is None
                     else write_table)
        if paged_read_path(cfg) == "kernel":
            # chunk positions are consecutive per slot, so the kernel
            # takes the first query's position and derives the rest
            from repro_torch.kernels.paged_attn import ops as pa_ops
            out = pa_ops.paged_decode_attention(
                q, cache["k"], cache["v"], block_table,
                pos[:, 0].contiguous(), window=window,
                softcap=cfg.attn_logit_softcap,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                out_dtype=x.dtype if quantized else None)
            return mm(out.reshape(B, C, -1), p["wo"]), cache
        kg = paged_gather(cache["k"], block_table)
        vg = paged_gather(cache["v"], block_table)
        if quantized:
            kg = quant.dequantize(
                kg, paged_gather(cache["k_scale"], block_table), x.dtype)
            vg = quant.dequantize(
                vg, paged_gather(cache["v_scale"], block_table), x.dtype)
    Smax = kg.shape[1]
    k_pos = torch.arange(Smax, device=x.device)[None, :].expand(B, Smax)
    out = decode_attention(q, kg, vg, pos, k_pos, window=window,
                           softcap=cfg.attn_logit_softcap)
    return mm(out.reshape(B, C, -1), p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def init_mla(generator, cfg: ModelConfig, dtype, lead=()):
    D, H = cfg.d_model, cfg.n_heads
    r, pr = cfg.kv_lora_rank, cfg.rope_head_dim
    nd, vd = cfg.nope_head_dim, cfg.v_head_dim
    dev = _source(generator)[1]
    p = {
        "wkv_a": dense_init(generator, (D, r + pr), 0, dtype, lead),
        "kv_norm": {"scale": torch.ones(tuple(lead) + (r,), dtype=dtype,
                                        device=dev)},
        "wk_b": dense_init(generator, (H, r, nd), 1, dtype, lead),
        "wv_b": dense_init(generator, (H, r, vd), 1, dtype, lead),
        "wo": dense_init(generator, (H * vd, D), 0, dtype, lead),
    }
    if cfg.q_lora_rank:
        p["wq_a"] = dense_init(generator, (D, cfg.q_lora_rank), 0, dtype,
                               lead)
        p["q_norm"] = {"scale": torch.ones(tuple(lead) + (cfg.q_lora_rank,),
                                           dtype=dtype, device=dev)}
        p["wq_b"] = dense_init(generator, (cfg.q_lora_rank, H * (nd + pr)),
                               0, dtype, lead)
    else:
        p["wq"] = dense_init(generator, (D, H * (nd + pr)), 0, dtype, lead)
    return p


def _mla_queries(p, cfg: ModelConfig, x, positions):
    """(q_nope (B,S,H,nd), q_rope (B,S,H,pr)): RoPE on the last
    ``rope_head_dim`` features of each head only."""
    B, S, _ = x.shape
    H, nd, pr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = mm(apply_norm(p["q_norm"], mm(x, p["wq_a"])), p["wq_b"])
    else:
        q = mm(x, p["wq"])
    q = q.reshape(B, S, H, nd + pr)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_latent(p, cfg: ModelConfig, x, positions):
    """Compressed KV: returns (ckv (B,S,r), k_rope (B,S,pr)).  ``kv_norm``
    normalises the latent before any up-projection; ``k_rope`` is one
    head, shared by every query head."""
    r = cfg.kv_lora_rank
    kv = mm(x, p["wkv_a"])
    ckv = apply_norm(p["kv_norm"], kv[..., :r])
    k_rope = apply_rope(kv[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    return ckv, k_rope


def mla_full(p, cfg: ModelConfig, x, positions):
    """Training / prefill MLA through the plain ``chunked_attention``
    (query/key width nope + rope, value width ``v_head_dim``, scale
    1/sqrt(nope + rope)).  Returns (out, (ckv, k_rope))."""
    B, S, _ = x.shape
    H, nd, pr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    vd = cfg.v_head_dim
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    ckv, k_rope = mla_latent(p, cfg, x, positions)
    k_nope = torch.einsum("bsr,hrn->bshn", ckv, p["wk_b"].to(ckv.dtype))
    v = torch.einsum("bsr,hrv->bshv", ckv, p["wv_b"].to(ckv.dtype))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, H, pr)], dim=-1)
    out = chunked_attention(
        q, k, v, positions, positions, causal=True,
        scale=1.0 / math.sqrt(nd + pr), q_chunk=cfg.attn_chunk_q,
        k_chunk=cfg.attn_chunk_k,
        skip_masked_chunks=cfg.attn_skip_masked_chunks)
    return mm(out.reshape(B, S, H * vd), p["wo"]), (ckv, k_rope)


def _mla_attend(p, cfg: ModelConfig, x, pos, ckv, krope):
    """Absorbed-matrix attention over a (B, S, r)/(B, S, pr) latent view
    whose index along S is the logical position (contiguous cache, or a
    block-table gather of a paged pool).  x: (B,C,D), pos: (B,C); C>1 is
    one chunk, masked causally per query.  ``wk_b`` folds into the
    query, ``wv_b`` applies after the softmax; scores and context in
    f32, as in the reference."""
    B, C = x.shape[:2]
    H, nd, pr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    vd = cfg.v_head_dim
    q_nope, q_rope = _mla_queries(p, cfg, x, pos)
    # absorb W_UK into the query: (B,C,H,nd) x (H,r,nd) -> (B,C,H,r)
    q_lat = torch.einsum("bqhn,hrn->bqhr", q_nope,
                         p["wk_b"].to(q_nope.dtype))
    Smax = ckv.shape[1]
    k_pos = torch.arange(Smax, device=x.device)[None, :].expand(B, Smax)
    s = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ckv.float())
         + torch.einsum("bqhp,bsp->bhqs", q_rope.float(), krope.float()))
    s = s / math.sqrt(nd + pr)
    s = s + _mask_bias(pos, k_pos, causal=True, window=0)[:, None]
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, ckv.float())
    v = torch.einsum("bqhr,hrv->bqhv", ctx, p["wv_b"].float())
    return mm(v.reshape(B, C, H * vd).to(x.dtype), p["wo"])


def mla_decode(p, cfg: ModelConfig, x, pos, cache, *, block_table=None,
               write_table=None):
    """Absorbed-matrix MLA decode / chunk: attends in the latent space.

    ``cache`` is the layer's ``{"ckv", "kr"}`` dict (576 values a token
    at DeepSeek-V3's ranks), plus ``{"ckv_scale", "kr_scale"}`` under a
    quantized policy: each latent row and each rope-key row quantized at
    write time with one scale over its feature axis.  The C latents of
    x (B,C,D) at pos (B,C) are written first, then the C queries attend
    over the updated view.  Contiguous (``block_table=None``): caches
    (B,Smax,r) and (B,Smax,pr); positions >= Smax (a chunked prefill's
    bucket pads) are not written.  Paged: block pools, written through
    ``write_table`` (defaults to ``block_table``) and read through a
    block-table gather (never the paged kernel).  The cache tensors are
    updated in place; returns (out, cache)."""
    ckv_t, kr_t = mla_latent(p, cfg, x, pos)
    quantized = "ckv_scale" in cache
    new = {"ckv": ckv_t, "kr": kr_t}
    if quantized:
        kv_dtype = quant.kv_dtype_of_leaf(cache["ckv"])
        for key in ("ckv", "kr"):
            new[key], new[quant.scale_name(key)] = quant.quantize(new[key],
                                                                 kv_dtype)
    if block_table is None:
        _write_cache(cache, new, pos)
    else:
        _write_cache(cache, new, pos, block_table if write_table is None
                     else write_table)

    def view(key):
        leaf = cache[key]
        return leaf if block_table is None else paged_gather(leaf,
                                                             block_table)

    ckv_g, kr_g = view("ckv"), view("kr")
    if quantized:
        ckv_g = quant.dequantize(ckv_g, view("ckv_scale"), x.dtype)
        kr_g = quant.dequantize(kr_g, view("kr_scale"), x.dtype)
    return _mla_attend(p, cfg, x, pos, ckv_g, kr_g), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(generator, cfg: ModelConfig, d_in: int, d_hidden: int, dtype,
             lead=()):
    if cfg.mlp_gated:
        return {
            "wi_gate": dense_init(generator, (d_in, d_hidden), 0, dtype, lead),
            "wi_up": dense_init(generator, (d_in, d_hidden), 0, dtype, lead),
            "wo": dense_init(generator, (d_hidden, d_in), 0, dtype, lead),
        }
    return {
        "wi": dense_init(generator, (d_in, d_hidden), 0, dtype, lead),
        "wo": dense_init(generator, (d_hidden, d_in), 0, dtype, lead),
    }


def _act(cfg: ModelConfig, x):
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def apply_mlp(p, cfg: ModelConfig, x):
    if "wi_gate" in p:
        h = _act(cfg, mm(x, p["wi_gate"])) * mm(x, p["wi_up"])
    else:
        h = _act(cfg, mm(x, p["wi"]))
    return mm(h, p["wo"])
