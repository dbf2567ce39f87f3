"""Plain PyTorch version of flash attention (dense scores, small shapes).

``attention_ref`` copies ``repro.kernels.flash_attention.ref.attention_ref``;
``flash_attention_ref`` adds the public (B, S, H, D) layout and the GQA
head repeat of ``repro.kernels.flash_attention.ops.flash_attention``.
It is what ``ops.flash_attention`` runs on a CPU tensor, and what the
CUDA kernel is held against on the card.  f32 matrix products here
stay full f32 (TF32 off).
"""
from __future__ import annotations

import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, scale=None):
    """q: (BH, Sq, D), k/v: (BH, Sk, D) -> (BH, Sq, D)."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok[None], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(v.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """q: (B, Sq, H, D), k/v: (B, Sk, KH, D) -> (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    if KH != H:
        k = k.repeat_interleave(H // KH, dim=2)
        v = v.repeat_interleave(H // KH, dim=2)
    qb = q.transpose(1, 2).reshape(B * H, Sq, D)
    kb = k.transpose(1, 2).reshape(B * H, -1, D)
    vb = v.transpose(1, 2).reshape(B * H, -1, D)
    out = attention_ref(qb, kb, vb, causal=causal, window=window,
                        softcap=softcap)
    return out.reshape(B, H, Sq, D).transpose(1, 2)
