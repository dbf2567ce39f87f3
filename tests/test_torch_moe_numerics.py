"""The arithmetic of the bf16 grouped-FFN kernel, pinned on the CPU.

``csrc/moe_gemm.cu`` computes the bf16 grouped FFN on tensor cores in
two stages.  Stage A: g = x @ wg and u = x @ wu as bf16 x bf16 products
(exact in f32) summed in f32, 16 deep per ``mma.sync`` step (K chunks of
32 pass as two steps), then h = act(g) * u in f32, stored as two bf16
terms ``hi = bf16(h)`` and ``lo = bf16(h - hi)``.  Stage B: y = lo @ wo
+ hi @ wo into one f32 sum, the smaller term first at each 16-deep step,
rounded once to bf16.  This file emulates that arithmetic in plain
torch and holds it to the reference's ``grouped_ffn`` (JAX, the Pallas
kernel interpreted on the CPU: f32 inside, h never rounded, one
rounding to bf16) under the rule ``chip_smoke.py`` holds the kernel to:
each element within two bf16 ulps of its own value + 1e-4.  On the
same inputs h rounded once to bf16 breaks that rule, so the rule sees
the split.

Inputs are made with numpy from a seed and rounded to bf16, drawn as
``chip_smoke.py::ffn_case`` draws them: x ~ N(0, 1), wg and wu ~
N(0, 1/D), wo ~ N(0, 1/F).  C and F are ragged against the kernel's
128-row and 128-column tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import ops as jgemm
from repro_torch.kernels.moe_gemm.ref import gated_act
from test_torch_kernels_gpu import bf16_err_over_limit

STEP = 16   # the mma depth


def emulate(x, wg, wu, wo, *, act, split=True):
    """x (E, C, D), wg/wu (E, D, F), wo (E, F, D), bf16 -> y (E, C, D)
    bf16, by the kernel's arithmetic, with h carried into stage B as two
    bf16 terms or rounded once."""
    xf, gf, uf, of = (t.float() for t in (x, wg, wu, wo))  # exact values
    E, C, D = x.shape
    Fh = wg.shape[-1]
    g = torch.zeros(E, C, Fh)
    u = torch.zeros(E, C, Fh)
    for k0 in range(0, D, STEP):
        xs = xf[..., k0:k0 + STEP]
        g = g + xs @ gf[:, k0:k0 + STEP]
        u = u + xs @ uf[:, k0:k0 + STEP]
    h = gated_act(act, g, u)                   # f32
    hi = h.to(torch.bfloat16).float()
    lo = (h - hi).to(torch.bfloat16).float()   # h - hi is exact in f32
    y = torch.zeros(E, C, D)
    for k0 in range(0, Fh, STEP):
        ws = of[:, k0:k0 + STEP]
        if split:
            y = y + lo[..., k0:k0 + STEP] @ ws
        y = y + hi[..., k0:k0 + STEP] @ ws
    return y.to(torch.bfloat16)


def _inputs(E, C, D, Fh, seed):
    rng = np.random.default_rng(seed)

    def bf16(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(torch.bfloat16)
    return (bf16((E, C, D), 1.0), bf16((E, D, Fh), D ** -0.5),
            bf16((E, D, Fh), D ** -0.5), bf16((E, Fh, D), Fh ** -0.5))


def _reference(x, wg, wu, wo, *, act):
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (x, wg, wu, wo)]
    want = jgemm.grouped_ffn(*j, act=act).astype(jnp.float32)
    return torch.from_numpy(np.array(want)).to(torch.bfloat16)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,C,D,Fh", [(2, 130, 256, 200), (3, 70, 96, 200),
                                      (2, 548, 512, 384)])
def test_split_h_keeps_the_rule_and_single_h_breaks_it(E, C, D, Fh, act):
    x, wg, wu, wo = _inputs(E, C, D, Fh, seed=C + D)
    want = _reference(x, wg, wu, wo, act=act)
    split = bf16_err_over_limit(emulate(x, wg, wu, wo, act=act), want)
    single = bf16_err_over_limit(
        emulate(x, wg, wu, wo, act=act, split=False), want)
    assert split <= 1.0, f"two terms of h: {split:.3g}x the limit"
    assert single > 1.0, f"h rounded once: only {single:.3g}x the limit"
