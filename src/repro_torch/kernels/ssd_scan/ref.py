"""Plain PyTorch version of the SSD chunked-scan kernel.

Computes what ``repro.kernels.ssd_scan.kernel._ssd_kernel`` computes,
vectorised over chunks with the state carried by a loop over them.  Per
chunk of Q rows (Q = min(chunk, S); a ragged tail behaves as rows with
dt = 0, so the final state is the state at row S - 1):

  cum   = cumsum(dt * A)
  y     = (C·Bᵀ ∘ L)·(x ∘ dt) + (C ∘ exp(cum))·hᵀ,
          L[q, s] = exp(cum[q] - cum[s]) for s <= q, else 0
  h    <- exp(cum[-1]) h + xᵀ·(B ∘ exp(cum[-1] - cum) dt)

Everything is f32 (f64 for f64 inputs, a more exact oracle); ``y`` is
rounded once to x's dtype, as the kernel writes it.  B/C may hold one
row per head (B, S, H, N) or per group (B, S, G, N), head h reading
group h // (H / G).  f32 matrix products here stay full f32 (TF32 off).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def expand_groups(t, H: int):
    """(B, S, G, N) -> (B, S, H, N), each group repeated H / G times."""
    G = t.shape[2]
    if G == H:
        return t
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    return t.repeat_interleave(H // G, dim=2)


def _pieces(xh, dt, A, Bh, Ch, chunk, init_state):
    """Per-chunk f32 (or f64) operands: x, dt, B, C as (B, nC, Q, H, ·), the
    in-chunk cumsum of dt·A, and the state entering each chunk
    (B, nC, H, P, N).  Returns them with the final state."""
    Bsz, S, H, P = xh.shape
    Bh, Ch = expand_groups(Bh, H), expand_groups(Ch, H)
    N = Bh.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    nC = (S + pad) // Q
    ct = torch.float64 if xh.dtype == torch.float64 else torch.float32
    x, b, c = (t.to(ct) for t in (xh, Bh, Ch))
    d = dt.to(ct)
    if pad:
        x, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, b, c))
        d = F.pad(d, (0, 0, 0, pad))           # dt = 0: decay 1, no update
    x = x.reshape(Bsz, nC, Q, H, P)
    b = b.reshape(Bsz, nC, Q, H, N)
    c = c.reshape(Bsz, nC, Q, H, N)
    d = d.reshape(Bsz, nC, Q, H)
    cum = torch.cumsum(d * A.to(ct), dim=2)                  # (B,nC,Q,H)
    w = torch.exp(cum[:, :, -1:] - cum) * d                  # decay to end
    upd = torch.einsum("bcshn,bcshp->bchpn", b * w[..., None], x)
    h = (torch.zeros((Bsz, H, P, N), dtype=ct, device=xh.device)
         if init_state is None else init_state.to(ct))
    h_in = []
    for k in range(nC):
        h_in.append(h)
        h = h * torch.exp(cum[:, k, -1])[:, :, None, None] + upd[:, k]
    return x, d, b, c, cum, torch.stack(h_in, 1), h


def _intra_weights(b, c, cum):
    """(C·Bᵀ ∘ L) per chunk, (B, nC, Q, Q, H) over (q, s), with L masked
    before the exponent (above the diagonal cum[q] - cum[s] > 0)."""
    Q = cum.shape[2]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=cum.device).tril()
    lq = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = lq.masked_fill(~causal[None, None, :, :, None], float("-inf")).exp()
    return torch.einsum("bcqhn,bcshn->bcqsh", c, b) * L


def ssd_scan_ref(xh, dt, A, Bh, Ch, *, chunk: int, init_state=None):
    """xh (B, S, H, P); dt (B, S, H) f32; A (H,) f32; Bh/Ch (B, S, H, N)
    or (B, S, G, N); init_state (B, H, P, N) f32 or None ->
    (y (B, S, H, P) in xh's dtype, final state (B, H, P, N) f32; f64
    throughout for f64 inputs)."""
    Bsz, S, H, P = xh.shape
    x, d, b, c, cum, h_in, h = _pieces(xh, dt, A, Bh, Ch, chunk, init_state)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", _intra_weights(b, c, cum),
                           x * d[..., None])
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", c * cum.exp()[..., None],
                           h_in)
    y = (y_intra + y_inter).reshape(Bsz, -1, H, P)[:, :S]
    return y.to(xh.dtype), h


def ssd_terms(xh, dt, A, Bh, Ch, *, chunk: int, init_state=None,
              far: int = 64):
    """The three f32 terms of y, each (B, S, H, P): the intra-chunk term
    from pairs at most ``far`` rows apart, from pairs further apart, and
    the carried-state term.  Their sum is ``ssd_scan_ref``'s y before
    rounding.  Used to show which terms a check can see."""
    Bsz, S, H, P = xh.shape
    x, d, b, c, cum, h_in, _ = _pieces(xh, dt, A, Bh, Ch, chunk, init_state)
    W = _intra_weights(b, c, cum)
    Q = cum.shape[2]
    i = torch.arange(Q, device=cum.device)
    is_far = ((i[:, None] - i[None, :]) > far)[None, None, :, :, None]
    xd = x * d[..., None]
    near_t = torch.einsum("bcqsh,bcshp->bcqhp", W.masked_fill(is_far, 0), xd)
    far_t = torch.einsum("bcqsh,bcshp->bcqhp", W.masked_fill(~is_far, 0), xd)
    inter = torch.einsum("bcqhn,bchpn->bcqhp", c * cum.exp()[..., None], h_in)
    return tuple(t.reshape(Bsz, -1, H, P)[:, :S]
                 for t in (near_t, far_t, inter))
