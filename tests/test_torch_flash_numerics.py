"""The arithmetic of the bf16 flash-attention kernel, pinned on the CPU.

``csrc/flash_attention.cu`` computes bf16 attention on tensor cores:
key tiles of 64 (32 at D = 256), an online softmax in f32, bf16 x bf16
products (exact in f32) summed in f32, and P V with P split into two
bf16 terms, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``.  This file
emulates that arithmetic in plain torch and holds it to the reference's
``attention_ref`` (JAX, f32 inside, one rounding to bf16) under the rule
``chip_smoke.py`` holds the kernel to: each element within two bf16 ulps
of its own value + 1e-4.  On the same inputs P rounded once to bf16
breaks that rule, so the rule sees the split.  The bidirectional case
(the encoder's ``causal=False`` at an S that is no multiple of the key
tile) must also break the rule with a causal mask planted in.

Inputs are N(0, 1) draws made with numpy from a seed and rounded to
bf16, as ``chip_smoke.py`` draws them on the card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref
from test_torch_kernels_gpu import HEAD_DIMS, bf16_err_over_limit


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one thread a test process, so that parallel test workers do not
    # oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NEG_INF = -1.0e30

CASES = {
    # name: (heads, S, causal, window, softcap)
    "causal": (2, 300, True, 0, 0.0),
    "window": (2, 257, True, 40, 0.0),
    "softcap": (2, 200, True, 0, 30.0),
    # the encoder's mode: every key visible, S no multiple of the tile
    "bidir": (2, 300, False, 0, 0.0),
}


def _block_k(D):
    """Keys per tile, as the kernel's Tc<D>::BK."""
    return 32 if D > 128 else 64


def _mask(Sq, k0, n, causal, window):
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(k0, k0 + n)[None, :]
    ok = torch.ones(Sq, n, dtype=torch.bool)
    if causal:
        ok = ok & (kpos <= qpos)
    if window:
        ok = ok & (kpos > qpos - window)
    return ok


def emulate(q, k, v, *, causal, window, softcap, split=True):
    """q, k, v: (BH, S, D) bf16 -> (BH, Sq, D) bf16, by the kernel's
    arithmetic, with P split into two bf16 terms or rounded once."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    bk = _block_k(D)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = q.float(), k.float(), v.float()   # exact bf16 values
    m = torch.full((BH, Sq), NEG_INF)
    l = torch.zeros(BH, Sq)
    acc = torch.zeros(BH, Sq, D)
    for k0 in range(0, Sk, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        s = torch.einsum("bqd,bkd->bqk", qf, kt) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = _mask(Sq, k0, kt.shape[1], causal, window)
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))   # masked: exactly 0
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)               # the unrounded p
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if split:                              # p - hi is exact in f32
            pv = (p - hi).to(torch.bfloat16).float() @ vt + pv
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


def _inputs(heads, S, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(heads, S, D)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3)]


def _reference(q, k, v, **kw):
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (q, k, v)]
    want = attention_ref(*j, **kw).astype(jnp.float32)
    return torch.from_numpy(np.array(want)).to(torch.bfloat16)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_p_keeps_the_rule_and_single_p_breaks_it(name, D):
    heads, S, causal, window, softcap = CASES[name]
    q, k, v = _inputs(heads, S, D, seed=D)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = _reference(q, k, v, **kw)
    split = bf16_err_over_limit(emulate(q, k, v, **kw), want)
    single = bf16_err_over_limit(emulate(q, k, v, split=False, **kw), want)
    assert split <= 1.0, f"split P: {split:.3g}x the limit"
    assert single > 1.0, f"single-rounded P: only {single:.3g}x the limit"



@pytest.mark.parametrize("D", HEAD_DIMS)
def test_bidirectional_emulation_sees_the_keys_above_the_diagonal(D):
    """The bidirectional case with a causal mask planted into the
    emulation breaks the rule: the keys above the diagonal, the ragged
    last tile's included, reach the output the rule holds."""
    heads, S, causal, window, softcap = CASES["bidir"]
    assert not causal and S % _block_k(D)
    q, k, v = _inputs(heads, S, D, seed=D)
    want = _reference(q, k, v, causal=False, window=0, softcap=0.0)
    planted = emulate(q, k, v, causal=True, window=0, softcap=0.0)
    assert bf16_err_over_limit(planted, want) > 1.0
