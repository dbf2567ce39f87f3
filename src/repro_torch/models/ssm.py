"""Mamba-2 (SSD, state-space duality) block of the port.  [arXiv:2405.21060]

Counterpart of ``repro.models.ssm``.  Full-sequence prefill runs the
chunked SSD scan: within a chunk a masked quadratic form, across chunks
a recurrent (B, H, P, N) state.  With ``cfg.use_kernels`` the scan is
the hand-written CUDA kernel of ``repro_torch.kernels.ssd_scan`` (its
plain version on CPU tensors); otherwise ``ssd_chunked``, the
reference's XLA path.  Both train: the kernel's wrapper differentiates
its plain version (``ops.ssd_bwd``), as the reference trains through
XLA's autodiff of ``ssd_chunked``.  Decode is the O(1)-per-token
recurrence ``ssm_decode``, plain PyTorch as in the reference.

The causal conv is K shifted multiply-adds, as in the reference, not
``F.conv1d``: cuDNN would run an f32 convolution in TF32 on the card.
Bucketed admission feeds a prompt through ``ssm_prefill_chunk`` in
chunks: the same scan from the carried state (the kernel's
``init_state``), with bucket pads frozen out by ``n_valid``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def init_ssm(generator, cfg: ModelConfig, dtype, lead=()):
    """One Mamba-2 mixer, stacked over ``lead``.  ``A_log``, ``D`` and
    ``dt_bias`` stay f32 in any model dtype, as in the reference."""
    dev = layers._source(generator)[1]
    D, d_inner = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    conv_dim = d_inner + 2 * G * N
    lead = tuple(lead)

    def full(shape, value, dt):
        return torch.full(lead + shape, value, dtype=dt, device=dev)

    return {
        "in_proj": layers.dense_init(
            generator, (D, 2 * d_inner + 2 * G * N + H), 0, dtype, lead),
        "conv_w": layers.dense_init(generator, (cfg.ssm_conv, conv_dim), 0,
                                    dtype, lead),
        "conv_b": full((conv_dim,), 0.0, dtype),
        "A_log": full((H,), 0.0, torch.float32),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "norm": {"scale": full((d_inner,), 1.0, dtype)},
        "out_proj": layers.dense_init(generator, (d_inner, D), 0, dtype,
                                      lead),
    }


def _split_proj(cfg: ModelConfig, proj):
    d_inner = cfg.d_inner
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:d_inner + d_inner + 2 * G * N]
    dt = proj[..., -H:]
    return z, xBC, dt


def _conv_input(cfg: ModelConfig, xBC, conv_cache=None):
    """(B, K-1+S, C): the carried conv tail (zeros without one) before
    xBC, the window the causal conv and the next tail read."""
    if conv_cache is not None:
        return torch.cat([conv_cache.to(xBC.dtype), xBC], dim=1)
    return F.pad(xBC, (0, 0, cfg.ssm_conv - 1, 0))


def _causal_conv(cfg: ModelConfig, xp, conv_w, conv_b):
    """Depthwise causal conv along S over ``_conv_input``'s xp."""
    K = cfg.ssm_conv
    S = xp.shape[1] - (K - 1)
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(K))
    return F.silu(out + conv_b)


def _expand_groups(t, H: int):
    """(B, ..., G, N) -> (B, ..., H, N) by repeating each group; a view
    (no copy) when there is one group."""
    G = t.shape[-2]
    if G == 1:
        return t.expand(*t.shape[:-2], H, t.shape[-1])
    return t.repeat_interleave(H // G, dim=-2)


def ssd_chunked(xh, dt, A, Bh, Ch, *, chunk: int, init_state=None,
                compute_dtype=torch.float32):
    """Chunked SSD scan, the reference's XLA path.

    xh: (B,S,H,P)  dt: (B,S,H)  A: (H,) negative  Bh/Ch: (B,S,H,N)
    Returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32).  The matrix
    operands may run in ``compute_dtype`` (bf16); products accumulate in
    f32, and decays, cumsums and the state stay f32.
    """
    Bsz, S, H, Pd = xh.shape
    N = Bh.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bh = F.pad(Bh, (0, 0, 0, 0, 0, pad))
        Ch = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    nC = (S + pad) // Q
    f32, cd = torch.float32, compute_dtype

    def operand(t):
        # rounded to the compute dtype, then exact in f32: the reference's
        # preferred_element_type=f32 products
        return t.to(cd).float()

    xh = operand(xh).reshape(Bsz, nC, Q, H, Pd)
    dt = dt.float().reshape(Bsz, nC, Q, H)
    Bh = operand(Bh).reshape(Bsz, nC, Q, H, N)
    Ch = operand(Ch).reshape(Bsz, nC, Q, H, N)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    h = (torch.zeros((Bsz, H, Pd, N), dtype=f32, device=xh.device)
         if init_state is None else init_state.float())
    ys = []
    for c in range(nC):
        x_c, dt_c, B_c, C_c = xh[:, c], dt[:, c], Bh[:, c], Ch[:, c]
        dA = dt_c * A[None, None, :]                      # (B,Q,H) <= 0
        cum = torch.cumsum(dA, dim=1)
        lq = cum[:, :, None, :] - cum[:, None, :, :]      # (B,Q,S,H)
        # masked before the exponent: above the diagonal lq > 0
        Lmat = lq.masked_fill(~causal[None, :, :, None], float("-inf")).exp()
        CB = torch.einsum("bqhn,bshn->bqsh", C_c, B_c)
        y_intra = torch.einsum("bqsh,bshp->bqhp", operand(CB * Lmat),
                               operand(x_c * dt_c[..., None]))
        y_inter = torch.einsum("bqhn,bhpn->bqhp",
                               C_c * torch.exp(cum)[..., None], h)
        decay_to_end = torch.exp(cum[:, -1:, :] - cum)    # (B,Q,H)
        s_c = torch.einsum("bshn,bshp->bhpn",
                           B_c * (decay_to_end * dt_c)[..., None], x_c)
        h = h * torch.exp(cum[:, -1])[:, :, None, None] + s_c
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(Bsz, nC * Q, H, Pd)[:, :S]
    return y, h


def skip(y, xs, D):
    """y + D * x per head (xs (..., H, P), D (H,) f32): the skip term in
    f32, as the reference adds it."""
    return y + xs.float() * D[:, None]


def ssm_forward(p, cfg: ModelConfig, x, *, conv_cache=None, init_state=None,
                return_cache: bool = False, n_valid=None):
    """Full-sequence Mamba-2 block.  x: (B, S, D) -> (B, S, D); with
    ``return_cache`` also the decode cache entry ``{"state", "conv"}``.
    The scan starts from ``init_state`` (kernel 7's ``init_state`` on the
    kernel path) and the conv from the carried ``conv_cache``.

    ``n_valid`` (B,) masks bucket padding at the tail of a chunked
    prefill's chunk: positions ``>= n_valid`` contribute nothing to the
    carried state (their softplus'd dt is zeroed, so the decay is
    exp(0) = 1 and the update term vanishes), and each row's carried
    conv tail is the K-1 inputs ending at its own ``n_valid``, gathered
    per row.
    """
    B, S, D = x.shape
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner, G, K = cfg.d_inner, cfg.ssm_groups, cfg.ssm_conv
    proj = x @ p["in_proj"]
    z, xBC, dt = _split_proj(cfg, proj)
    xp = _conv_input(cfg, xBC, conv_cache)
    xBC_conv = _causal_conv(cfg, xp, p["conv_w"], p["conv_b"])
    # views of the conv output: the kernel reads them through strides
    xs = xBC_conv[..., :d_inner].reshape(B, S, H, Pd)
    Bs = xBC_conv[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cs = xBC_conv[..., d_inner + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if n_valid is not None:
        n_valid = torch.clamp(n_valid.to(x.device).long(), 0, S)
        valid = torch.arange(S, device=x.device)[None, :] < n_valid[:, None]
        dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"])
    if init_state is not None:
        init_state = init_state.float().contiguous()

    if cfg.use_kernels:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        # B/C once per group; the kernel maps each head to its group
        y, h_final = ssd_ops.ssd(xs, dt, A, Bs, Cs, chunk=cfg.ssm_chunk,
                                 init_state=init_state)
    else:
        y, h_final = ssd_chunked(xs, dt, A, _expand_groups(Bs, H),
                                 _expand_groups(Cs, H), chunk=cfg.ssm_chunk,
                                 init_state=init_state,
                                 compute_dtype=getattr(
                                     torch, cfg.ssm_compute_dtype))
    y = skip(y, xs, p["D"]).reshape(B, S, d_inner).to(x.dtype)
    y = layers.apply_norm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"]
    if not return_cache:
        return out
    # the tail: the K-1 inputs of xp (the carried tail, or zeros, before
    # xBC) ending at S, or at each row's n_valid
    if n_valid is None:
        tail = xp[:, -(K - 1):]
    else:
        idx = n_valid[:, None] + torch.arange(K - 1, device=x.device)[None]
        tail = torch.gather(xp, 1, idx[..., None].expand(B, K - 1,
                                                          xp.shape[2]))
    return out, {"state": h_final, "conv": tail}


def ssm_prefill_chunk(p, cfg: ModelConfig, x, cache, n_valid=None):
    """One chunked-prefill chunk through a Mamba-2 block: ``ssm_forward``
    over C tokens from the carried state and conv tail, with bucket pads
    masked by ``n_valid``.  x: (B, C, D); cache as in ``ssm_decode``
    (read, not written).  Returns (out (B, C, D), new cache entry)."""
    return ssm_forward(p, cfg, x, conv_cache=cache["conv"],
                       init_state=cache["state"], return_cache=True,
                       n_valid=n_valid)


def ssm_decode(p, cfg: ModelConfig, x, cache):
    """Single-token recurrent step.  x: (B, 1, D); cache ``{"state"
    (B, H, P, N) f32, "conv" (B, K-1, conv_dim)}``.  Returns (out
    (B, 1, D), new cache entry)."""
    B = x.shape[0]
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    d_inner, G, K = cfg.d_inner, cfg.ssm_groups, cfg.ssm_conv
    proj = x @ p["in_proj"]
    z, xBC, dt = _split_proj(cfg, proj)
    # conv over (cache ++ this step)
    conv_in = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)
    L = conv_in.shape[1]
    out_c = sum(conv_in[:, i + L - K] * p["conv_w"][i] for i in range(K))
    xBC_conv = F.silu(out_c + p["conv_b"])[:, None]       # (B,1,C)
    xs = xBC_conv[..., :d_inner].reshape(B, H, Pd)
    Bs = _expand_groups(
        xBC_conv[..., d_inner:d_inner + G * N].reshape(B, G, N), H)
    Cs = _expand_groups(xBC_conv[..., d_inner + G * N:].reshape(B, G, N), H)
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"])    # (B,H)
    A = -torch.exp(p["A_log"])
    h = cache["state"].float()                            # (B,H,P,N)
    dec = torch.exp(dt1 * A[None, :])                     # (B,H)
    h_new = (h * dec[:, :, None, None]
             + torch.einsum("bh,bhn,bhp->bhpn", dt1, Bs.float(), xs.float()))
    y = torch.einsum("bhn,bhpn->bhp", Cs.float(), h_new)
    y = skip(y, xs, p["D"]).reshape(B, 1, d_inner).to(x.dtype)
    y = layers.apply_norm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"]
    return out, {"state": h_new, "conv": conv_in[:, -(K - 1):]}
