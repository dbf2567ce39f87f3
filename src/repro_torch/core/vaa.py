"""View-Aligned Attention (VAA) — the paper's core module (§IV.C, Fig. 5).

Counterpart of ``repro.core.vaa``.  The student (MoE base model) and
teacher (proxy of on-device LLMs) have different architectures and
*predictive perspectives*.  VAA lets the student blend its own
multi-stage features through self-attention into a perspective
comparable with the teacher's, after which plain feature matching (MSE)
works.

Three steps (paper numbering):
 1. patchify each student stage j into P_q/J patches (a non-overlapping
    strided conv on a token sequence: mean-pool S into buckets) and
    project to a common dim d via C_j (Eq. 7);
 2. multi-head self-attention over the concatenated (B, P_q, d) features
    (Eq. 8);
 3. split back into J stages and project each to the teacher's width;
    feature-matching loss against the (pooled) teacher stages (Eq. 9).

The module is small (P_q queries, d of a few hundred): plain tensor code,
as in the reference, where no Pallas kernel covers it.  Its parameters
are f32 beside a bf16 student, and the student's stages go up to f32
before they are pooled.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

from repro_torch.models import layers


def patchify(x, n_patches: int):
    """(B, S, D) -> (B, n_patches, D) by mean-pooling S into buckets.

    Always returns exactly ``n_patches`` patches: S is edge-padded (the
    last position repeated) up to a multiple of n_patches first, so
    short sequences (S < n_patches) still give every stage its slice of
    the (B, P_q, d) query block and L_FM shapes always match."""
    B, S, D = x.shape
    P = n_patches
    pad = (-S) % P
    if pad:
        x = torch.cat([x, x[:, -1:].expand(B, pad, D)], dim=1)
    return x.reshape(B, P, -1, D).mean(dim=2)


def init_vaa(generator, *, n_stages: int, d_student: int, d_teacher: int,
             d: int = 256, p_q: int = 64, dtype=torch.float32):
    """Parameters of the VAA module, drawn from ``generator`` (a seeded
    ``torch.Generator``; the draws differ from ``jax.random``: convert
    the reference's with ``convert.vaa_from_jax`` to compare).  p_q =
    total queries over all stages.  The reference also takes the head
    count, which no shape depends on."""
    if p_q % n_stages:
        raise ValueError(f"P_q {p_q} must divide into {n_stages} stages")
    return {
        "stage_proj": layers.dense_init(generator, (n_stages, d_student, d),
                                        1, dtype),
        "wq": layers.dense_init(generator, (d, d), 0, dtype),
        "wk": layers.dense_init(generator, (d, d), 0, dtype),
        "wv": layers.dense_init(generator, (d, d), 0, dtype),
        "wo": layers.dense_init(generator, (d, d), 0, dtype),
        "out_proj": layers.dense_init(generator, (n_stages, d, d_teacher),
                                      1, dtype),
    }


def vaa_apply(p, student_stages: Sequence[torch.Tensor], *, n_heads: int,
              p_q: int) -> List[torch.Tensor]:
    """student_stages: J tensors (B, S, d_S) -> J tensors (B, P_q/J, d_T),
    f32."""
    J = len(student_stages)
    P = p_q // J
    d = p["wq"].shape[0]

    # step 1: patchify + project each stage (Eq. 7)
    feats = [patchify(f.float(), P) @ p["stage_proj"][j].float()
             for j, f in enumerate(student_stages)]
    fs = torch.cat(feats, dim=1)                            # (B, P_q, d)

    # step 2: multi-head self-attention (Eq. 8)
    B = fs.shape[0]
    hd = d // n_heads
    q = (fs @ p["wq"]).reshape(B, -1, n_heads, hd)
    k = (fs @ p["wk"]).reshape(B, -1, n_heads, hd)
    v = (fs @ p["wv"]).reshape(B, -1, n_heads, hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, -1, d)
    fs2 = o @ p["wo"]

    # step 3: split stages + project to teacher widths
    return [fs2[:, j * P:(j + 1) * P] @ p["out_proj"][j].float()
            for j in range(J)]


def _unit_rows(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)


def feature_matching_loss(p, student_stages, teacher_stages, *, n_heads: int,
                          p_q: int):
    """L_FM (Eq. 9): MSE between the VAA-blended student and the pooled
    teacher, each patch scaled to unit length (+ 1e-6) first."""
    J = len(student_stages)
    P = p_q // J
    blended = vaa_apply(p, student_stages, n_heads=n_heads, p_q=p_q)
    loss = torch.zeros((), dtype=torch.float32,
                       device=blended[0].device)
    for j in range(J):
        t = _unit_rows(patchify(teacher_stages[j].float(), P))
        s = _unit_rows(blended[j])
        loss = loss + torch.mean(torch.square(s - t))
    return loss / J
