"""The arithmetic of the grouped-matmul kernel's tensor-core instances,
pinned on the CPU.

``csrc/moe_gemm.cu``'s ``gmm_wgmma_kernel`` multiplies bf16 tiles on the
tensor cores (each product exact in f32), 16 deep a ``wgmma`` step, into
one f32 accumulator, and rounds once to the output dtype.  An f32
operand v (dg, du or h in the grouped FFN's backward) enters as two bf16
terms, hi = bf16(v) and lo = bf16(v - hi); each step multiplies the other
operand by lo, then by hi.  K is walked in 64-deep chunks that TMA reads
through 3-D maps, so a ragged K reads zeros past the expert's own rows.
dx's two products run in one launch into one sum.

This file emulates that arithmetic in plain torch and holds it to the
reference's ``grouped_matmul`` (JAX, the Pallas kernel interpreted on the
CPU) with f32 operands, as ``_grouped_ffn_bwd`` passes them, under the
rule ``chip_smoke.py::check_close`` holds the kernel to: f32 outputs
within 1e-4, bf16 outputs within two bf16 ulps of their own value +
1e-4.  Each of the backward's five layouts is covered at small sizes
with M, N and K off every tile, K below one tile and E >= 2.  On the
same inputs an f32 operand rounded once to bf16 breaks the rule, and so
does a ragged K chunk that reads the next expert's rows (what a map
flattened to (E * rows, cols) would read).

Inputs are made with numpy from a seed as ``chip_smoke.py::gmm_case``
draws them: A ~ N(0, 1), B ~ N(0, 1/K); bf16 operands rounded to bf16,
f32 operands kept in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import kernel as jgemm
from repro_torch.kernels.moe_gemm import ops
from repro_torch.kernels.moe_gemm.ref import Split, split_f32_ref
from test_torch_kernels_gpu import bf16_err_over_limit

STEP = 16      # the wgmma depth
CHUNK = 64     # K a ring stage: a ragged K is padded to it
F32_TOL = 1e-4  # chip_smoke.py: f32 outputs
bf, f32 = torch.bfloat16, torch.float32

# name: (A transposed, B transposed, f32 operand, two products, out dtype)
# as the grouped FFN's backward forms them
LAYOUTS = {
    "x@wg": (False, False, None, False, f32),
    "dy@wo^T": (False, True, None, False, f32),
    "dg@wg^T+du@wu^T": (False, True, "a", True, bf),
    "x^T@dg": (True, False, "b", False, bf),
    "h^T@dy": (True, False, "a", False, bf),
}
# (E, M, K, N): M and N off the 128-row and 256- (128-) column tiles, K
# ragged against the 64-deep chunks, or below one
SIZES = [(3, 130, 100, 200), (2, 70, 37, 136)]


def _draw(rng, shape, scale, dtype):
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))
    return t.to(dtype)


def _operands(name, E, M, K, N, seed):
    """[(a, b)] (one or two pairs) of the layout, with transposed views
    where the backward passes them."""
    ta, tb, f32_side, two, _ = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(2 if two else 1):
        a = _draw(rng, (E, K, M) if ta else (E, M, K), 1.0,
                  f32 if f32_side == "a" else bf)
        b = _draw(rng, (E, N, K) if tb else (E, K, N), K ** -0.5,
                  f32 if f32_side == "b" else bf)
        pairs.append((a.transpose(1, 2) if ta else a,
                      b.transpose(1, 2) if tb else b))
    return pairs


def _terms(t, n_terms):
    """The bf16 terms a tile of t enters the tensor cores as, smaller
    first: a bf16 operand as itself; an f32 one as lo, hi (or hi alone)."""
    if t.dtype == bf:
        return [t.float()]
    hi = t.to(bf).float()
    lo = (t - hi).to(bf).float()   # t - hi is exact in f32
    return [lo, hi] if n_terms == 2 else [hi]


def _pad_k(t, axis, kp, flat):
    """t's K axis padded to kp: zeros (3-D maps), or the next experts'
    rows, as a map over the flattened (E * K, ...) tensor reads them."""
    E, K = t.shape[0], t.shape[axis]
    if not flat:
        pad = list(t.shape)
        pad[axis] = kp - K
        return torch.cat([t, t.new_zeros(pad)], axis)
    rows = torch.cat([t[e] for e in range(E)], axis - 1)   # (.., E*K, ..)
    pad = list(rows.shape)
    pad[axis - 1] = kp
    rows = torch.cat([rows, rows.new_zeros(pad)], axis - 1)
    return torch.stack([rows.narrow(axis - 1, e * K, kp)
                        for e in range(E)])


def emulate(pairs, out_dtype, *, n_terms=2, flat=False):
    """The kernel's arithmetic: per pair and 64-deep chunk (K zero-padded,
    or read across experts if ``flat``), per 16-deep step, the bf16 terms
    of A times those of B, summed into one f32 accumulator; rounded once
    to ``out_dtype``."""
    E, M = pairs[0][0].shape[:2]
    N = pairs[0][1].shape[2]
    acc = torch.zeros(E, M, N)
    for a, b in pairs:
        kp = -(-a.shape[2] // CHUNK) * CHUNK
        at = _terms(_pad_k(a, 2, kp, flat), n_terms)
        bt = _terms(_pad_k(b, 1, kp, flat), n_terms)
        for k0 in range(0, kp, STEP):
            for x in at:
                for y in bt:
                    acc = acc + x[..., k0:k0 + STEP] @ y[:, k0:k0 + STEP]
    return acc.to(out_dtype)


def _reference(pairs, out_dtype):
    """The reference's grouped_matmul on f32 operands, the pairs summed in
    f32, rounded once to ``out_dtype``."""
    total = 0
    for a, b in pairs:
        ja, jb = (jnp.asarray(t.float().numpy()) for t in (a, b))
        total = total + jgemm.grouped_matmul(ja, jb, interpret=True,
                                             out_dtype=jnp.float32)
    return torch.from_numpy(np.array(total)).to(out_dtype)


def err_over_limit(out, want):
    if want.dtype == f32:
        return ((out - want).abs().max() / F32_TOL).item()
    return bf16_err_over_limit(out, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_emulation_keeps_the_rule(name, size):
    pairs = _operands(name, *size, seed=sum(size) + len(name))
    for out_dtype in {LAYOUTS[name][4], f32}:
        want = _reference(pairs, out_dtype)
        worst = err_over_limit(emulate(pairs, out_dtype), want)
        assert worst <= 1.0, f"{name} out {out_dtype}: {worst:.3g}x"


@pytest.mark.parametrize("out_dtype", [f32, bf], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", [n for n, v in LAYOUTS.items() if v[2]])
def test_one_term_split_breaks_the_rule(name, out_dtype):
    pairs = _operands(name, *SIZES[0], seed=7)
    want = _reference(pairs, out_dtype)
    assert err_over_limit(emulate(pairs, out_dtype), want) <= 1.0
    single = err_over_limit(emulate(pairs, out_dtype, n_terms=1), want)
    assert single > 1.0, f"f32 operand rounded once: only {single:.3g}x"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", ["x^T@dg", "h^T@dy"])
def test_cross_expert_k_tail_breaks_the_rule(name, size):
    """The weight gradients' K is the capacity C, the rows of both
    operands: a flattened map's last chunk reads expert e + 1's rows."""
    pairs = _operands(name, *size, seed=11)
    out_dtype = LAYOUTS[name][4]
    want = _reference(pairs, out_dtype)
    flat = err_over_limit(emulate(pairs, out_dtype, flat=True), want)
    assert flat > 1.0, f"flattened K tail: only {flat:.3g}x the limit"


def test_split_terms_are_exact_in_f32():
    """hi + lo is an f32 value (the general instance adds them on load),
    within 2^-16 of v relative, and lo is what the rounding of v left."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp2(rng.integers(-20, 20, 4096))).astype(
        np.float32))
    s = split_f32_ref(v)
    hi, lo = s.hi.double(), s.lo.double()
    assert torch.equal((hi + lo).float().double(), hi + lo)
    assert ((v.double() - (hi + lo)).abs() <= 2.0 ** -16 * v.double().abs()
            ).all()
    assert torch.equal(s.hi, v.to(bf))


def test_wrapper_on_cpu_is_the_plain_sum():
    """On CPU tensors the wrapper runs the plain version: a pair and a
    Split operand, rounded once."""
    pairs = _operands("dg@wg^T+du@wu^T", 2, 70, 37, 136, seed=5)
    (a, b), (a2, b2) = pairs
    out = ops.grouped_matmul(ops.split_f32(a), b, out_dtype=bf,
                             plus=(ops.split_f32(a2), b2))
    sa, sa2 = split_f32_ref(a), split_f32_ref(a2)
    want = (torch.bmm(sa.float(), b.float())
            + torch.bmm(sa2.float(), b2.float())).to(bf)
    assert torch.equal(out, want)
    assert torch.equal(ops.grouped_matmul(a, b, plus=(a2, b2)),
                       torch.bmm(a, b.float()) + torch.bmm(a2, b2.float()))


def _planes_of(t):
    """A Split of t's shape whose planes lie in one buffer, lo on a
    16-byte boundary, as ``ops.split_f32`` lays them out."""
    n = t.numel()
    gap = -(-n // 8) * 8
    buf = torch.empty(gap + n, dtype=bf)
    return Split(buf[:n].view(t.shape), buf[gap:].view(t.shape))


@pytest.mark.parametrize("name,want", [
    ("x@wg", ("wgmma", 0, 1)),
    ("dy@wo^T", ("wgmma", 0, 0)),
    ("dg@wg^T+du@wu^T", ("wgmma_split", 0, 0)),
    ("x^T@dg", ("wgmma_split", 1, 1)),
    ("h^T@dy", ("wgmma_split", 1, 1))])
def test_path_layouts_take_the_tensor_cores(name, want):
    """The instance and transpose bits of each product of the backward at
    the tune path's widths (C 548, D 2048, F 1408; two experts), chosen
    from dtypes, strides and pointers alone."""
    E, C, D, F = 2, 548, 2048, 1408
    M, K, N = {"x@wg": (C, D, F), "dy@wo^T": (C, D, F),
               "dg@wg^T+du@wu^T": (C, F, D), "x^T@dg": (D, C, F),
               "h^T@dy": (F, C, D)}[name]
    ta, tb = LAYOUTS[name][:2]

    def planes(t, transposed):  # an f32 operand as split_f32 returns it
        if t.dtype != f32:
            return t
        if transposed:
            return _planes_of(t.transpose(1, 2)).transpose(1, 2)
        return _planes_of(t)
    pairs = [(planes(a, ta), planes(b, tb))
             for a, b in _operands(name, E, M, K, N, seed=0)]
    assert ops._plan(pairs) == want
    assert ops.instance(*pairs[0], plus=pairs[1] if len(pairs) > 1
                        else None) == want[0]


def test_instances_of_other_operands():
    """f32 pairs take the f32 instance; an unsplit f32 operand beside a
    bf16 one, a row stride or base TMA cannot take, or two split
    operands take the general one."""
    rng = np.random.default_rng(0)
    a, b = _draw(rng, (2, 70, 64), 1, bf), _draw(rng, (2, 64, 136), 1, bf)
    assert ops.instance(a, b) == "wgmma"
    assert ops.instance(a.float(), b.float()) == "f32"
    assert ops.instance(a.float(), b) == "general"
    odd = _draw(rng, (2, 37, 136), 1, bf)
    assert ops.instance(_draw(rng, (2, 70, 37), 1, bf), odd) == "general"
    off = torch.empty(a.numel() + 1, dtype=bf)[1:].view(a.shape)
    assert ops.instance(off, b) == "general"
    assert ops.instance(a[:, :, ::2], b[:, ::2]) == "general"
    assert ops.instance(_planes_of(a.float()), _planes_of(b.float())) \
        == "general"
    assert ops.instance(a, b, plus=(_planes_of(a.float()), b)) == "general"
