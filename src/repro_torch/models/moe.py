"""Mixture-of-Experts FFN layer (routed + shared experts).

Counterpart of ``repro.models.moe`` for one device (``mesh=None``), with
the reference's parameter layout: ``router`` (D, E) in f32, the routed
experts stacked as ``wi_gate`` / ``wi_up`` (E, D, F) and ``wo``
(E, F, D), and the shared experts as one gated MLP of width
F · n_shared under ``shared``.

``moe_dense`` has the reference's two paths:

* ``cfg.use_kernels``: ``kernels/moe_gemm/ops.py::moe_ffn``: dispatch
  into fixed-capacity buffers, the grouped FFN and the weighted combine
  through the hand-written CUDA kernels (their plain versions on CPU
  tensors).  The capacity can drop assignments, as the reference's
  ``use_pallas=True`` path does.
* otherwise the dropless all-experts einsum of the reference's
  ``use_pallas=False`` path.

The serving ``live`` mask (B, S) zeroes dead rows' routing weights,
so a freed slot's garbage lane combines with weight 0 (its routed
output is exactly 0).  As in the reference's one-device path, dead rows
still take capacity ranks in ``moe_ffn``: with at most 8 decode slots
the capacity (at least 8) holds every assignment, so nothing can drop.
A chunked prefill's bucket pads are dead rows at the chunk's tail: they
rank after every live row, so they never crowd one out.

Not ported yet, and refused with ``NotImplementedError``: the
expert-parallel paths (``moe_impl`` "a2a" and "replicated_ep", and any
mesh).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_moe(generator, cfg: ModelConfig, dtype, lead=()):
    """Router, routed experts and shared experts of one MoE sub-layer
    (``lead`` prepends stacked group axes)."""
    D = cfg.d_model
    Fh = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    p = {
        "router": layers.dense_init(generator, (D, E), 0, torch.float32,
                                    lead),
        "wi_gate": layers.dense_init(generator, (E, D, Fh), 1, dtype, lead),
        "wi_up": layers.dense_init(generator, (E, D, Fh), 1, dtype, lead),
        "wo": layers.dense_init(generator, (E, Fh, D), 1, dtype, lead),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(generator, cfg, D,
                                      Fh * cfg.n_shared_experts, dtype, lead)
    return p


def route(p, cfg: ModelConfig, x, live=None):
    """Returns (weights (T, k) f32, expert ids (T, k), aux loss scalar).

    x: (T, D) flat tokens.  Softmax, then top-k, then renormalise, with
    the load-balance auxiliary loss E · Σ_e f_e · p_e (GShard / Switch).
    ``live`` (T,) bool zeroes dead rows' weights after the
    renormalisation (the aux loss still sees every row, as in the
    reference).
    """
    logits = x.float() @ p["router"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    if live is not None:
        w = torch.where(live[:, None], w, torch.zeros_like(w))
    return w, idx, load_balance_loss(cfg, probs, idx)


def load_balance_loss(cfg: ModelConfig, probs, idx):
    """E · Σ_e f_e · p_e · coef: p_e the mean router probability of
    expert e, f_e the share of assignments routed to it."""
    E = cfg.n_experts
    me = probs.mean(0)                                    # mean prob
    one_hot = F.one_hot(idx, E).float()                   # (T, k, E)
    fe = one_hot.sum(1).mean(0)                           # routed share
    return E * torch.sum(me * fe) * cfg.router_aux_coef


def moe_dense(p, cfg: ModelConfig, x, live=None):
    """x: (B, S, D) -> (out (B, S, D), aux).  Routed experts through
    ``moe_ffn`` (``cfg.use_kernels``) or every expert on every token,
    plus the shared experts.  ``live`` (B, S) bool zeroes dead rows'
    routing weights."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    w, idx, aux = route(p, cfg, xt,
                        None if live is None else live.reshape(-1))
    if cfg.use_kernels:
        out = moe_ops.moe_ffn(xt, w, idx, p["wi_gate"], p["wi_up"], p["wo"],
                              act=cfg.act)
    else:
        h = torch.einsum("td,edf->etf", xt, p["wi_gate"])
        h = layers._act(cfg, h) * torch.einsum("td,edf->etf", xt, p["wi_up"])
        y_all = torch.einsum("etf,efd->etd", h, p["wo"])  # (E, T, D)
        one_hot = F.one_hot(idx, cfg.n_experts).to(xt.dtype)  # (T, k, E)
        comb = torch.einsum("tk,tke->te", w.to(xt.dtype), one_hot)
        out = torch.einsum("te,etd->td", comb, y_all)
    out = out.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + layers.apply_mlp(p["shared"], cfg, x)
    return out, aux


def apply_moe(p, cfg: ModelConfig, x, mesh=None, live=None):
    """The MoE path of one sub-layer: ``moe_dense`` on one device.
    ``live`` (B, S) bool is the serving mask (None: every row live)."""
    if cfg.moe_impl in ("a2a", "replicated_ep") or mesh is not None:
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r} (expert parallelism over a mesh) is "
            "not ported yet")
    return moe_dense(p, cfg, x, live)
