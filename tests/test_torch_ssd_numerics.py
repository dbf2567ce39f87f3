"""The arithmetic of the SSD scan's tensor-core instance, pinned on the CPU.

``csrc/ssd_scan.cu``'s ``tc`` instance computes the bf16 scan on tensor
cores: bf16 x bf16 products, exact in f32, summed in f32, and three f32
operands carried as two bf16 terms each, ``hi = bf16(v)`` and
``lo = bf16(v - hi)``:

- W = (C·Bᵀ) ∘ L ∘ dt[s], the masked, decayed intra-chunk weights, times
  the exact bf16 x, key tile by key tile (64 keys), lo then hi;
- h_in, the state entering a chunk, as the state pass writes it, times C,
  scaled by exp(cum[q]) and added first into the same f32 sum;
- B ∘ w, w[s] = exp(cum[Q-1] - cum[s]) dt[s], in the chunk-state
  product xᵀ·(B ∘ w), whose f32 sums the state pass carries on.

This file emulates that arithmetic in plain torch and holds it to the
reference's Pallas kernel ``ssd_scan_bh`` (interpreted, f32 inside, y
rounded once to bf16): y within ``chip_smoke.py``'s per-element rule (two
bf16 ulps of each element + 1e-4) and the final state within 2e-5 of its
largest value.  Each planted fault must break it: each of the three
operands rounded once to bf16, dt folded into x and rounded to bf16, the
far pairs dropped, the carried state dropped.  The faults are planted on
slow-decay cases, where ``test_torch_ssd.term_shares`` shows that the far
pairs and the carried state each carry at least 10% of their part of y.

Inputs are numpy draws from a seed, x, B and C rounded to bf16, at the
ssm prefill's P 64, N 128 and chunk 256 with 2-4 heads.  L is taken here
by ``torch.exp`` where the kernel takes the SFU's 2^x: that moves W by
under 2^-19 of itself, far below the 2^-17 its two terms keep.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_bh
from repro_torch.kernels.ssd_scan.ref import expand_groups
from test_torch_kernels_gpu import bf16_err_over_limit
from test_torch_ssd import term_shares

STATE_REL = 2e-5
TILE = 64          # keys a tile, as the kernel's TT
FAR = 64           # "far" pairs: more than a quarter chunk apart

# name: (B, S, H, P, N, G, chunk, with h0, slow decay)
CASES = {
    "path_fast": (1, 1024, 4, 64, 128, 1, 256, False, False),
    "path_slow": (1, 1024, 4, 64, 128, 1, 256, False, True),
    "ragged_fast": (1, 777, 4, 64, 128, 1, 256, False, False),
    "ragged_slow": (1, 777, 4, 64, 128, 1, 256, False, True),
    "groups_h0_fast": (2, 777, 2, 64, 128, 2, 256, True, False),
    "groups_h0_slow": (2, 1024, 4, 64, 128, 2, 256, True, True),
}
SLOW = [k for k, v in CASES.items() if v[-1]]
FAULTS = ["w_one_term", "hin_one_term", "bw_one_term", "dt_in_x",
          "no_far_pairs", "no_carried"]


@functools.lru_cache(maxsize=None)
def _inputs(case):
    B, S, H, P, N, G, Q, with_h0, slow = CASES[case]
    rng = np.random.default_rng(7)
    f = np.float32

    def bf16(a):
        return torch.from_numpy(a.astype(f)).bfloat16()
    x = bf16(rng.standard_normal((B, S, H, P)))
    if slow:   # dt * |A| <= 0.01: a 256-row chunk decays by >= e^-2.56
        dt = rng.uniform(0.02, 0.1, (B, S, H)).astype(f)
        A = -rng.uniform(0.02, 0.1, (H,)).astype(f)
    else:      # the reference's init: dt ~ softplus(N(0,1)), A = -1
        dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f)
        A = -np.ones(H, f)
    b = bf16(0.3 * rng.standard_normal((B, S, G, N)))
    c = bf16(0.3 * rng.standard_normal((B, S, G, N)))
    h0 = (torch.from_numpy((0.5 * rng.standard_normal((B, H, P, N))).astype(f))
          if with_h0 else None)
    return x, torch.from_numpy(dt), torch.from_numpy(A), b, c, h0, Q


@functools.lru_cache(maxsize=None)
def _reference(case):
    """y (bf16) and the final state of the interpreted Pallas kernel."""
    x, dt, A, b, c, h0, Q = _inputs(case)
    Bsz, S, H, P = x.shape
    N = b.shape[-1]

    def bh(t):  # (B, S, H, ...) -> (B*H, S, ...), as jnp
        t = t.float() if t.dtype == torch.bfloat16 else t
        a = np.moveaxis(t.numpy(), 2, 1)
        a = a.reshape((Bsz * H, S) + a.shape[3:])
        return jnp.asarray(a)
    b16 = lambda t: bh(t).astype(jnp.bfloat16)
    hh = (jnp.zeros((Bsz * H, P, N), jnp.float32) if h0 is None
          else jnp.asarray(h0.numpy().reshape(Bsz * H, P, N)))
    y, h = ssd_scan_bh(b16(x), bh(dt), jnp.tile(jnp.asarray(A.numpy()), Bsz),
                       b16(expand_groups(b, H)), b16(expand_groups(c, H)),
                       hh, chunk=Q, interpret=True)
    y = np.asarray(y.astype(jnp.float32)).reshape(Bsz, H, S, P)
    y = torch.from_numpy(np.moveaxis(y, 1, 2).copy()).bfloat16()
    return y, torch.from_numpy(np.array(h).reshape(Bsz, H, P, N))


def _hi(v):
    return v.bfloat16().float()


def _two(v):
    """(lo, hi): the two bf16 terms of an f32 tensor, as f32."""
    hi = _hi(v)
    return _hi(v - hi), hi


def emulate(x, dt, A, b, c, h0, Q, fault=None):
    """The tc instance's arithmetic: y (B, S, H, P) bf16 and the final
    state (B, H, P, N) f32, with ``fault`` planted."""
    Bsz, S, H, P = x.shape
    b, c = expand_groups(b, H), expand_groups(c, H)
    N = b.shape[-1]
    nC = -(-S // Q)
    pad = nC * Q - S

    def chunks(t):  # (B, S, H, ...) -> (B, nC, Q, H, ...), rows past S zero
        t = t.float()
        t = torch.cat([t, t.new_zeros((Bsz, pad) + t.shape[2:])], 1)
        return t.reshape((Bsz, nC, Q) + t.shape[2:])
    xf, bf, cf, d = chunks(x), chunks(b), chunks(c), chunks(dt)
    cum = torch.cumsum(d * A, dim=2)                          # (B,nC,Q,H)
    # chunk states: upd = xᵀ (B ∘ w), B ∘ w as lo + hi
    w = torch.exp(cum[:, :, -1:] - cum) * d
    bw = bf * w[..., None]
    terms = [_hi(bw)] if fault == "bw_one_term" else list(_two(bw))
    upd = sum(torch.einsum("bcshp,bcshn->bchpn", xf, t) for t in terms)
    # the state pass, in f32; h_in as the planes it writes
    h = (torch.zeros(Bsz, H, P, N) if h0 is None else h0.clone())
    h_in = []
    for k in range(nC):
        h_in.append(h)
        h = h * torch.exp(cum[:, k, -1])[:, :, None, None] + upd[:, k]
    h_in = torch.stack(h_in, 1)                               # (B,nC,H,P,N)
    # carried term first: exp(cum[q]) (C h_loᵀ + C h_hiᵀ)
    terms = [_hi(h_in)] if fault == "hin_one_term" else list(_two(h_in))
    acc = sum(torch.einsum("bcqhn,bchpn->bcqhp", cf, t) for t in terms)
    acc = acc * torch.exp(cum)[..., None]
    if fault == "no_carried":
        acc = torch.zeros_like(acc)
    # W = (C Bᵀ) ∘ L ∘ dt[s], masked before the exponent
    i = torch.arange(Q)
    keep = i[None, :] <= i[:, None]                           # s <= q
    if fault == "no_far_pairs":
        keep = keep & (i[:, None] - i[None, :] <= FAR)
    lq = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,nC,q,s,H)
    L = lq.masked_fill(~keep[None, None, :, :, None], float("-inf")).exp()
    G = torch.einsum("bcqhn,bcshn->bcqsh", cf, bf)
    if fault == "dt_in_x":
        W, xs = G * L, _hi(xf * d[..., None])
    else:
        W, xs = G * L * d[:, :, None, :, :], xf
    for s0 in range(0, Q, TILE):          # key tiles in order, lo then hi
        Wt, xt = W[:, :, :, s0:s0 + TILE], xs[:, :, s0:s0 + TILE]
        terms = [_hi(Wt)] if fault == "w_one_term" else list(_two(Wt))
        for t in terms:
            acc = acc + torch.einsum("bcqsh,bcshp->bcqhp", t, xt)
    y = acc.reshape(Bsz, nC * Q, H, P)[:, :S]
    return y.bfloat16(), h


def _readings(case, fault=None):
    """(y's largest error over the per-element limit, the state's largest
    error over 2e-5 of its largest value)."""
    y, h = emulate(*_inputs(case), fault=fault)
    wy, wh = _reference(case)
    state = ((h - wh).abs().max() / (STATE_REL * wh.abs().max())).item()
    return bf16_err_over_limit(y, wy), state


@pytest.mark.parametrize("case", list(CASES))
def test_tc_arithmetic_matches_reference_kernel(case):
    y_over, state_over = _readings(case)
    assert y_over <= 1.0 and state_over <= 1.0, (y_over, state_over)


@pytest.mark.parametrize("case", SLOW)
def test_slow_decay_cases_show_every_term(case):
    x, dt, A, b, c, h0, Q = _inputs(case)
    H = x.shape[2]
    far, carried, first = term_shares(
        x.float(), dt, A, expand_groups(b, H).float(),
        expand_groups(c, H).float(), chunk=Q, init_state=h0)
    assert far >= 0.1 and carried >= 0.1, (far, carried)
    if h0 is not None:
        assert first >= 0.1, first


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("case", SLOW)
def test_each_planted_fault_breaks_the_check(case, fault):
    y_over, state_over = _readings(case, fault)
    assert y_over > 1.0 or state_over > 1.0, (y_over, state_over)
