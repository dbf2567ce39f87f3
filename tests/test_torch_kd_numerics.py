"""The arithmetic of the kd_loss kernel's wgmma instance, pinned on the CPU.

``csrc/kd_loss.cu``'s ``kd_wgmma_kernel`` multiplies bf16 operands on the
tensor cores (each product exact in f32, summed 16 deep into f32
accumulators), in tiles of 128 rows by 256 vocab columns (a student and
a teacher tile of 128 columns in KD mode).  Each thread holds two rows'
columns 8j + 2q + {0, 1} of a tile (q its lane in a quad) and folds
them, tile by tile, into its own online statistics: m, l, the gold
logit and the first argmax of the raw logits; in KD mode also l at τ,
the teacher's m and l at τ, U = Σ p·z_t and W = Σ p·z_s with their
rescale e^{(m_old - m_new)/τ}.  At the end of its split the 4 lanes of a
quad combine (ties to the lower index), and the splits
(``ops.vocab_splits`` for an H100's 132 SMs) merge in vocab order, each
rescaled by e^{m_i - m}, the argmax by a strict >.

This file emulates that arithmetic in plain torch and holds it to the
reference's interpreted Pallas kernel (``kd_loss_fwd``) under the rule
``chip_smoke.py`` holds the kernel to: ce and kl within 1e-4, correct
exact except on rows whose top two logits are within 1e-5.  On the same
inputs a merge without the rescale, U/W folded without theirs, and an
argmax that takes the later index each break that rule.

Inputs are made with numpy from a seed: hidden states ~N(0, 1) and heads
~N(0, 1/D), rounded to bf16; the tie cases put integer-valued heads
behind an identity, so every logit is exact in any order, and plant
each row's maximum at two columns across a vocab-tile boundary, a split
boundary, or far apart.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kd_loss import kernel as jkd
from repro_torch.kernels.kd_loss import ops

NEG_INF = -1.0e30
N_SM = 132             # an H100 SXM's SMs: the split the card would run
F32_TOL = 1e-4         # chip_smoke.py: f32 outputs
ARGMAX_MARGIN = 1e-5   # chip_smoke.py: near ties may take either index
LANES = 4              # threads of a quad share a row

# name: (T, Ds, Dt, V, tau, softcap_s, softcap_t, ties)
CASES = {
    # ragged T and V; one tile a split
    "ce_ragged": (130, 136, 0, 4104, 1.0, 0.0, 0.0, False),
    # 17 row tiles, 7 splits of 18 tiles, the last ragged
    "ce_splits": (2049, 64, 0, 32008, 1.0, 0.0, 0.0, False),
    "ce_softcap": (200, 40, 0, 2056, 1.0, 2.0, 0.0, False),
    "kd_ragged": (130, 136, 72, 4104, 0.5, 0.0, 20.0, False),
    # KD tiles of 128 columns: 7 splits of 36 tiles
    "kd_splits": (2049, 64, 48, 32008, 2.0, 3.0, 0.0, False),
    # 2 row tiles, 63 splits of 2 tiles: ties across each boundary
    "ce_ties": (256, 256, 0, 32000, 1.0, 0.0, 0.0, True),
    "kd_ties": (256, 256, 64, 16000, 2.0, 0.0, 0.0, True),
}
FAULTS = {
    # a fault: the cases that must show it (more than one split, more
    # than one tile a split with a teacher, planted ties)
    "merge_no_rescale": ["ce_ragged", "ce_splits", "kd_splits"],
    "uw_no_rescale": ["kd_splits"],
    "later_argmax": ["ce_ties", "kd_ties"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the emulation's many small products: one thread a test process, so
    # that parallel test workers do not oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float()


def tie_columns(T, V, teacher):
    """Two columns per row that straddle, in turn, a vocab-tile boundary
    inside a split, a split boundary, or lie far apart."""
    _, tile_v = ops.tile_shape("wgmma", teacher)
    ns, tps = ops.vocab_splits(T, V, N_SM, "wgmma", teacher)
    lo, hi = np.zeros(T, np.int64), np.zeros(T, np.int64)
    for r in range(T):
        s = 1 + (r // 6) % (ns - 2)   # neither the first split nor the last
        kind = (r // 2) % 3
        if kind == 0:       # inside split s: its first tile and second
            hi[r] = s * tps * tile_v + tile_v
        elif kind == 1:     # split s - 1's last column, split s's first
            hi[r] = s * tps * tile_v
        else:
            hi[r] = V // 2 + r * 29 % (V // 2)
        lo[r] = hi[r] - 1 if kind < 2 else r * 17 % (V // 2)
    return lo, hi


def make_inputs(T, Ds, Dt, V, ties, seed=0):
    """bf16-valued f32 tensors hs, ws, ht, wt (None without a teacher) and
    int32 labels.  With ``ties`` row r's logits are ws[r] (hs is the
    identity), integers in [-3, 3] with a 9 at two columns; even rows
    are labelled with the lower column, odd rows with the higher."""
    rng = np.random.default_rng(seed)
    ht = wt = None
    if ties:
        hs = np.eye(T, Ds, dtype=np.float32)
        ws = rng.integers(-3, 4, (Ds, V)).astype(np.float32)
        lo, hi = tie_columns(T, V, bool(Dt))
        rows = np.arange(T)
        ws[rows, lo] = ws[rows, hi] = 9.0
        labels = np.where(rows % 2 == 0, lo, hi).astype(np.int32)
    else:
        hs = rng.standard_normal((T, Ds))
        ws = rng.standard_normal((Ds, V)) / np.sqrt(Ds)
        labels = rng.integers(0, V, T).astype(np.int32)
    if Dt:
        ht = _bf16(rng.standard_normal((T, Dt)))
        wt = _bf16(rng.standard_normal((Dt, V)) / np.sqrt(Dt))
    return _bf16(hs), _bf16(ws), ht, wt, torch.from_numpy(labels)


def tensor_core_logits(h, w):
    """h @ w as the tensor cores sum it: products of 16-deep K slices,
    each exact in f32 and summed in f32, added slice by slice into f32
    accumulators."""
    acc = torch.zeros(h.shape[0], w.shape[1])
    for k in range(0, h.shape[1], 16):
        acc = acc + h[:, k:k + 16] @ w[k:k + 16]
    return acc


def _softcap(z, cap):
    return torch.tanh(z / cap) * cap if cap else z


def _lanes(z):
    """(R, N) tile -> (R, 4, N / 4): lane q's columns 8j + 2q + e in
    (j, e) order, i.e. its columns in increasing order."""
    R, N = z.shape
    return z.view(R, N // 8, LANES, 2).permute(0, 2, 1, 3).reshape(
        R, LANES, N // LANES)


def _first_max(x, later):
    """Max over the last axis and the index of its first (or last)
    occurrence."""
    mx = x.amax(-1)
    hit = x == mx[..., None]
    idx = torch.arange(x.shape[-1]).expand_as(x)
    if later:
        return mx, torch.where(hit, idx, -1).amax(-1)
    return mx, torch.where(hit, idx, x.shape[-1]).amin(-1)


def emulate(hs, ws, ht, wt, labels, *, tau, cap_s, cap_t, fault=None):
    """The wgmma instance's arithmetic -> (ce, kl, correct), each (T,) f32.
    ``fault``: "merge_no_rescale" merges the splits' l, U, W unscaled;
    "uw_no_rescale" folds U and W into a thread's sums without
    rescaling the old sums to the new teacher maximum; "later_argmax"
    keeps the last index of a maximum at every level."""
    T, V = hs.shape[0], ws.shape[1]
    kd = ht is not None
    later = fault == "later_argmax"
    _, BN = ops.tile_shape("wgmma", kd)
    ns, tps = ops.vocab_splits(T, V, N_SM, "wgmma", kd)
    n_tiles = -(-V // BN)
    inv_tau = 1.0 / tau
    lab = labels.long()
    # lane q's column offsets inside a tile: 8j + 2q + e
    cols = _lanes(torch.arange(BN, dtype=torch.float32)[None]).long()[0]
    parts = []
    for s in range(ns):
        shape = (T, LANES)
        m, mt = torch.full(shape, NEG_INF), torch.full(shape, NEG_INF)
        l, l_st, l_tt, u, w, gold = (torch.zeros(shape) for _ in range(6))
        arg = torch.zeros(shape, dtype=torch.long)
        for tile in range(s * tps, min(n_tiles, (s + 1) * tps)):
            v0 = tile * BN
            vids = v0 + cols                               # (4, BN / 4)
            ok = vids < V
            wb = ws[:, v0:v0 + BN]
            pad = BN - wb.shape[1]                         # TMA zero fill
            z = _lanes(_softcap(tensor_core_logits(
                hs, torch.nn.functional.pad(wb, (0, pad))), cap_s))
            z = torch.where(ok, z, torch.full_like(z, NEG_INF))
            tmx, tk = _first_max(z, later)
            gold = gold + torch.where(vids == lab[:, None, None], z,
                                      torch.zeros_like(z)).sum(-1)
            better = tmx >= m if later else tmx > m
            arg = torch.where(better, v0 + cols[torch.arange(LANES), tk],
                              arg)
            m_new = torch.maximum(m, tmx)
            seen = m_new > NEG_INF
            e = torch.exp(z - m_new[..., None]).sum(-1)
            l = torch.where(seen, l * torch.exp(m - m_new) + e, l)
            if kd:
                wtb = torch.nn.functional.pad(wt[:, v0:v0 + BN], (0, pad))
                zt = _lanes(_softcap(tensor_core_logits(ht, wtb), cap_t))
                zt = torch.where(ok, zt, torch.full_like(zt, NEG_INF))
                mt_new = torch.maximum(mt, zt.amax(-1))
                e_st = torch.exp((z - m_new[..., None]) * inv_tau).sum(-1)
                p = torch.exp((zt - mt_new[..., None]) * inv_tau)
                c = torch.exp((mt - mt_new) * inv_tau)
                cu = torch.ones_like(c) if fault == "uw_no_rescale" else c
                l_st = torch.where(
                    seen, l_st * torch.exp((m - m_new) * inv_tau) + e_st,
                    l_st)
                l_tt = torch.where(seen, l_tt * c + p.sum(-1), l_tt)
                u = torch.where(seen, u * cu + (p * zt).sum(-1), u)
                w = torch.where(seen, w * cu + (p * z).sum(-1), w)
                mt = mt_new
            m = m_new
        # the quad's lanes combine: maxima, rescaled sums, argmax
        mq = m.amax(1)
        sc = torch.exp(m - mq[:, None])
        on_max = m == mq[:, None]
        pick = (torch.where(on_max, arg, -1).amax(1) if later else
                torch.where(on_max, arg, V).amin(1))
        part = dict(m=mq, l=(l * sc).sum(1), gold=gold.sum(1), arg=pick)
        if kd:
            mtq = mt.amax(1)
            ct = torch.exp((mt - mtq[:, None]) * inv_tau)
            part.update(m_st=mq * inv_tau,
                        l_st=(l_st * torch.exp(
                            (m - mq[:, None]) * inv_tau)).sum(1),
                        m_tt=mtq * inv_tau, l_tt=(l_tt * ct).sum(1),
                        u=(u * ct).sum(1) * inv_tau,
                        w=(w * ct).sum(1) * inv_tau)
        parts.append(part)
    return merge(parts, labels, tau, kd, fault)


def merge(parts, labels, tau, kd, fault):
    """kd_merge_kernel: the splits in vocab order."""
    rescale = fault != "merge_no_rescale"

    def lse(km, kl):
        m = torch.stack([p[km] for p in parts]).amax(0)
        l = sum(p[kl] * (torch.exp(p[km] - m) if rescale else 1.0)
                for p in parts)
        return m + torch.log(torch.clamp(l, min=1e-30)), m, l

    gold = sum(p["gold"] for p in parts)
    bmax, barg = parts[0]["m"], parts[0]["arg"]
    for p in parts[1:]:
        better = p["m"] >= bmax if fault == "later_argmax" else p["m"] > bmax
        bmax = torch.where(better, p["m"], bmax)
        barg = torch.where(better, p["arg"], barg)
    ce = lse("m", "l")[0] - gold
    correct = (barg == labels.long()).float()
    if not kd:
        return ce, torch.zeros_like(ce), correct
    lse_st = lse("m_st", "l_st")[0]
    lse_tt, m_t, l_t = lse("m_tt", "l_tt")
    U = sum(p["u"] * (torch.exp(p["m_tt"] - m_t) if rescale else 1.0)
            for p in parts)
    W = sum(p["w"] * (torch.exp(p["m_tt"] - m_t) if rescale else 1.0)
            for p in parts)
    lt = torch.clamp(l_t, min=1e-30)
    kl = tau * tau * ((U / lt - lse_tt) - (W / lt - lse_st))
    return ce, kl, correct


def reference(hs, ws, ht, wt, labels, *, tau, cap_s, cap_t):
    """The reference's Pallas kernel, interpreted, on the same bf16
    values."""
    def j(x):
        return None if x is None else jnp.asarray(x.numpy(), jnp.bfloat16)

    out = jkd.kd_loss_fwd(j(hs), j(ws), j(ht), j(wt),
                          jnp.asarray(labels.numpy()), tau=tau,
                          softcap_s=cap_s, softcap_t=cap_t, interpret=True)
    return [torch.from_numpy(np.array(o, np.float32)) for o in out]


def near_ties(hs, ws, cap):
    z = _softcap(hs @ ws, cap)
    top = z.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) < ARGMAX_MARGIN


def rule(got, want, near, ties):
    """chip_smoke.py's rule -> (ce and kl error over the limit, correct
    rows that differ outside near ties; with planted ties, every row
    that differs: there the lower index must win)."""
    err = max((g - w).abs().max().item() for g, w in zip(got[:2], want[:2]))
    differ = got[2] != want[2]
    wrong = int(differ.sum() if ties else (differ & ~near).sum())
    return err / F32_TOL, wrong


@functools.lru_cache(maxsize=None)
def _case(name):
    T, Ds, Dt, V, tau, cap_s, cap_t, ties = CASES[name]
    x = make_inputs(T, Ds, Dt, V, ties)
    kw = dict(tau=tau, cap_s=cap_s, cap_t=cap_t)
    return x, kw, reference(*x, **kw), near_ties(x[0], x[1], cap_s)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernel_keeps_the_rule(name):
    x, kw, want, near = _case(name)
    ties = CASES[name][-1]
    over, wrong = rule(emulate(*x, **kw), want, near, ties)
    assert over <= 1.0, f"ce/kl error {over:.3g}x the 1e-4 limit"
    assert wrong == 0, f"correct differs on {wrong} rows"
    if ties:    # the reference itself gives every tie to the lower index
        rows = torch.arange(x[0].shape[0])
        assert torch.equal(want[2], (rows % 2 == 0).float())


@pytest.mark.parametrize("fault,name", [(f, n) for f, ns in FAULTS.items()
                                        for n in ns])
def test_fault_breaks_the_rule(fault, name):
    x, kw, want, near = _case(name)
    over, wrong = rule(emulate(*x, **kw, fault=fault), want, near,
                       CASES[name][-1])
    assert over > 1.0 or wrong > 0


def test_ties_straddle_tile_and_split_boundaries():
    """The planted pairs do lie across the boundaries they are meant to."""
    for teacher, (T, V) in ((False, (256, 32000)), (True, (256, 16000))):
        _, BN = ops.tile_shape("wgmma", teacher)
        ns, tps = ops.vocab_splits(T, V, N_SM, "wgmma", teacher)
        assert ns > 2 and tps >= 2
        lo, hi = tie_columns(T, V, teacher)
        tile_lo, tile_hi = lo // BN, hi // BN
        split_lo, split_hi = tile_lo // tps, tile_hi // tps
        kinds = (np.arange(T) // 2) % 3
        assert ((tile_hi == tile_lo + 1) & (split_lo == split_hi))[
            kinds == 0].all()
        assert (split_hi == split_lo + 1)[kinds == 1].all()
        assert (hi < V).all() and (lo < hi).all()
