"""Plain PyTorch version of the fused KD loss (dense logits, small shapes).

Copies ``repro.kernels.kd_loss.ref``: f32 logits ``h @ w`` with a tanh
softcap per side, CE against the labels, argmax-correct (first index on
ties), and in KD mode the temperature-τ KL(teacher ‖ student) times τ².
It is what ``ops.py`` runs forward on a CPU tensor, and what the CUDA
kernel is held against on the card.  f32 products stay full f32.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def _softcap(z, cap):
    if cap:
        return torch.tanh(z / cap) * cap
    return z


def ce_ref(hs, ws, labels, *, softcap: float = 0.0):
    """hs (T, D), ws (D, V), labels (T,) -> (ce (T,), correct (T,))."""
    z = _softcap(hs.float() @ ws.float(), softcap)
    lse = torch.logsumexp(z, dim=-1)
    # gather takes int64 indices
    gold = torch.gather(z, -1, labels.long()[:, None])[:, 0]
    correct = (torch.argmax(z, -1) == labels).float()
    return lse - gold, correct


def ce_kl_ref(hs, ws, ht, wt, labels, *, tau: float = 1.0,
              softcap_s: float = 0.0, softcap_t: float = 0.0):
    """Returns (ce (T,), kl (T,), correct (T,))."""
    zs = _softcap(hs.float() @ ws.float(), softcap_s)
    zt = _softcap(ht.float() @ wt.float(), softcap_t)
    ce, correct = ce_ref(hs, ws, labels, softcap=softcap_s)
    logp_s = torch.log_softmax(zs / tau, dim=-1)
    logp_t = torch.log_softmax(zt / tau, dim=-1)
    p_t = torch.exp(logp_t)
    kl = torch.sum(p_t * (logp_t - logp_s), dim=-1) * tau ** 2
    return ce, kl, correct
