"""Plain PyTorch version of paged attention (gather + dense scores).

Copies ``repro.kernels.paged_attn.ref.paged_attention_ref``, quantized
scales included.  Layout contract (shared with the kernel and
``layers.attention_decode``): logical position ``j`` of slot ``b`` lives
in pool row ``block_table[b, j // block_len]`` at offset
``j % block_len``, so the gathered-and-flattened view indexes by logical
position directly.  ``pos`` is the FIRST query's position; the C chunk
queries sit at ``pos .. pos+C-1`` with per-query causal/window masks.
f32 matrix products here stay full f32 (TF32 off).
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEG_INF = -1.0e30


def _gather(pool, bt):
    """(n_blocks, block_len, ...) rows through the (B, nbt) table ->
    (B, nbt * block_len, ...)."""
    return pool[bt].reshape((bt.shape[0], -1) + tuple(pool.shape[2:]))


def paged_attention_ref(q, k_pool, v_pool, block_table, pos, *,
                        window: int = 0, softcap: float = 0.0, scale=None,
                        k_scale=None, v_scale=None, out_dtype=None):
    """q: (B, C, H, Dq); pools: (n_blocks, block_len, KH, D*);
    block_table: (B, nbt) int32; pos: (B,) int32 -> (B, C, H, Dv) in
    ``out_dtype`` (default: the pools' dtype).

    ``k_scale``/``v_scale`` (n_blocks, block_len, KH) mark quantized
    pools: the gathered rows are dequantized in f32 (row times its scale)
    before the dense scores, as the kernel dequantizes in registers."""
    B, C, H, Dq = q.shape
    KH = k_pool.shape[2]
    G = H // KH
    if scale is None:
        scale = 1.0 / math.sqrt(Dq)
    if out_dtype is None:
        out_dtype = v_pool.dtype
    bt = block_table.long()
    kg = _gather(k_pool, bt)
    vg = _gather(v_pool, bt)
    if k_scale is not None:
        kg = kg.float() * _gather(k_scale, bt)[..., None].float()
        vg = vg.float() * _gather(v_scale, bt)[..., None].float()
    S = kg.shape[1]
    qr = q.reshape(B, C, KH, G, Dq)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(), kg.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(S, device=q.device)[None, None, :]          # (1,1,S)
    qpos = (pos.long()[:, None, None]
            + torch.arange(C, device=q.device)[None, :, None])      # (B,C,1)
    ok = kpos <= qpos
    if window:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, vg.float())
    return o.reshape(B, C, H, vg.shape[-1]).to(out_dtype)
