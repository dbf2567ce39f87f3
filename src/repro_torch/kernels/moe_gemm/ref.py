"""Plain PyTorch versions of the grouped expert GEMMs
(``csrc/moe_gemm.cu``), counterparts of ``repro.kernels.moe_gemm.ref``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch.ops import (capacity_positions,
                                                  token_combine,
                                                  token_dispatch)


def gated_act(act: str, g, u):
    """act(g) * u with the TPU kernel's activations (tanh-GELU or SiLU)."""
    a = F.gelu(g, approximate="tanh") if act == "gelu" else F.silu(g)
    return a * u


def grouped_matmul_ref(a, b, out_dtype=None):
    """a (E, M, K) @ b (E, K, N) -> (E, M, N), f32 products, output in
    ``out_dtype`` (default ``a.dtype``)."""
    out = torch.bmm(a.float(), b.float())
    return out.to(out_dtype or a.dtype)


def grouped_ffn_ref(x, wg, wu, wo, *, act: str = "silu"):
    """x: (E, C, D); wg/wu: (E, D, F); wo: (E, F, D) -> (E, C, D), f32
    inside, output in x's dtype."""
    xf = x.float()
    h = gated_act(act, torch.bmm(xf, wg.float()), torch.bmm(xf, wu.float()))
    return torch.bmm(h, wo.float()).to(x.dtype)


def grouped_ffn_bwd_ref(x, wg, wu, wo, dy, *, act: str = "silu"):
    """Explicit-chain backward of ``grouped_ffn``: (dx, dwg, dwu, dwo) in
    f32, with the activations' derivatives written out (independent of
    autograd), as the reference's ``grouped_ffn_bwd_ref``."""
    xf, wgf, wuf, wof, dyf = (t.float() for t in (x, wg, wu, wo, dy))
    g = torch.bmm(xf, wgf)
    u = torch.bmm(xf, wuf)
    if act == "gelu":
        c = (2.0 / torch.pi) ** 0.5
        t = torch.tanh(c * (g + 0.044715 * g ** 3))
        a = 0.5 * g * (1.0 + t)
        da = 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * c * (
            1.0 + 3 * 0.044715 * g * g)
    else:
        s = torch.sigmoid(g)
        a = g * s
        da = s * (1.0 + g * (1.0 - s))
    h = a * u
    dh = torch.bmm(dyf, wof.transpose(1, 2))
    dg = dh * u * da
    du = dh * a
    dx = (torch.bmm(dg, wgf.transpose(1, 2))
          + torch.bmm(du, wuf.transpose(1, 2)))
    dwg = torch.bmm(xf.transpose(1, 2), dg)
    dwu = torch.bmm(xf.transpose(1, 2), du)
    dwo = torch.bmm(h.transpose(1, 2), dyf)
    return dx, dwg, dwu, dwo


def moe_ffn_ref(xt, w, idx, wg, wu, wo, *, act: str = "silu"):
    """Token-level routed MoE (every expert on every token, combined with
    the routing weights): xt (T, D); w, idx (T, k); wg/wu (E, D, F);
    wo (E, F, D).  Dropless."""
    E = wg.shape[0]
    xf = xt.float()
    g = torch.einsum("td,edf->etf", xf, wg.float())
    h = gated_act(act, g, torch.einsum("td,edf->etf", xf, wu.float()))
    y_all = torch.einsum("etf,efd->etd", h, wo.float())
    one_hot = F.one_hot(idx.long(), E).float()
    comb = torch.einsum("tk,tke->te", w.float(), one_hot)
    return torch.einsum("te,etd->td", comb, y_all).to(xt.dtype)


def moe_ffn_capacity_ref(xt, w, idx, wg, wu, wo, *, act: str = "silu"):
    """Plain version of ``ops.moe_ffn``: the same capacity, ranks and
    drops, from plain pieces differentiated by autograd: dispatch and
    combine by ``index_add``, the grouped FFN by ``grouped_ffn_ref``
    (the reference's capacity path with ``use_kernel=False``)."""
    T, D = xt.shape
    k = idx.shape[1]
    E = wg.shape[0]
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device=xt.device) // k
    pos, keep = capacity_positions(flat_e, cap)
    slot = flat_e * cap + pos
    buf = token_dispatch(xt, flat_tok, slot, keep, E * cap, use_kernel=False)
    y = grouped_ffn_ref(buf.reshape(E, cap, D), wg, wu, wo, act=act)
    out = token_combine(y.reshape(E * cap, D), flat_tok, slot, keep,
                        w.reshape(-1), T, use_kernel=False)
    return out.to(xt.dtype)
