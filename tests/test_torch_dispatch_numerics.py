"""Kernel 6's arithmetic and bookkeeping on the CPU.

``csrc/moe_dispatch.cu`` cannot run here, so this file holds what
surrounds it and an emulation of what it computes:

- ``ops.instance``: which instance a launch takes, from dtypes, row
  lengths and pointers (``vec``: rows of whole 16-byte chunks on 16-byte
  bases; ``general``: the rest);
- the kernel path of ``token_dispatch`` / ``token_combine`` refusing to
  run without the routing's layouts;
- the layouts ``moe_ffn`` builds once a routing (by slot: a stable
  argsort and a searchsorted; by token: the identity with offsets k * t)
  against argsort + searchsorted, exactly, and slot 0's segment holding
  every dropped assignment in row order;
- ``token_dispatch`` / ``token_combine`` with the shared layouts against
  the reference's ``use_kernel=False`` versions, values and gradients,
  with and without drops (the reference's Pallas ``_gsa_kernel`` needs
  ``pl.load``/``pl.store``, which the installed JAX lacks);
- the kernel's walk (each output row's segment in sorted order, f32,
  products and sums rounded separately, one rounding at the end), and
  its split of a long segment (the owner adds the nonzero-scale entries,
  the zero-scale entries only mark inf/NaN columns), against the plain
  version, and a bf16 ``dout`` against an f32 copy then cast;
- ``ops.dscale_in_kernel_order`` (lane partials, the xor-shuffle tree,
  passes in order: what the fused backward computes) against
  ``jax.grad`` of the reference's ``use_kernel=False`` combine;
- planted faults, each of which must break its check: a segment offset
  off by one, the identity layout assumed for an unsorted ``flat_tok``,
  and dscale reading the wrong row.

Tolerances: integers (layouts, ranks, instances) exactly; the walk and
its split against the plain version, and bf16 ``dout`` against the f32
path then cast, bit for bit (the same roundings in the same order; NaN
where NaN); values and gradients against the reference 1e-5 absolute +
1e-4 relative (f32 sums in other orders, as
``test_torch_moe_kernels.py``); dscale within ``DSCALE_REL`` = 1e-5 of
sum |a_i b_i| of the reference's gradient: the kernel's order is a chain
of D/32 + 5 roundings (69 at D 2048, each at most half an f32 ulp,
3.3e-6 of sum |a_i b_i| in all) and XLA's another, so twice that bounds
the difference; read here 6.0e-8 at most (D 64; 1.7e-8 at D 2048).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch import ops as jdis
from repro_torch.kernels.moe_dispatch import ops as dis
from repro_torch.kernels.moe_dispatch.ref import gather_scatter_add_ref

TOL = dict(atol=1e-5, rtol=1e-4)
DSCALE_REL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy


def _routing(seed, T, E, k, bias=0.0):
    """Softmax-top-k routing from random logits, ``bias`` on expert 0, the
    reference's capacity: (w (T*k,), flat_tok, slot, keep, cap) as numpy,
    ranks from the reference."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += bias
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, axis=-1, kind="stable")[:, :k].astype(np.int32)
    w = np.take_along_axis(p, idx, -1)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32).reshape(-1)
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    pos, keep = jdis.capacity_positions(jnp.asarray(flat_e), cap)
    slot = (flat_e * cap + np.asarray(pos)).astype(np.int32)
    flat_tok = (np.arange(T * k) // k).astype(np.int32)
    return w, flat_tok, slot, np.asarray(keep), cap


def _walk(src, scale, src_ids, lay, out_dtype, *, split=False):
    """The vec kernel's arithmetic: output row r sums the entries at
    sorted positions seg[r] .. seg[r+1] (through ``order``) in that order,
    in f32 from +0, each product and sum rounded, one rounding into
    ``out_dtype`` at the end.  ``split``: a segment longer than
    ``dis.LONG`` as the kernel splits it: its nonzero-scale entries
    summed in order by the owner, its zero-scale entries only marking the
    columns where they hold an inf or NaN, which become NaN."""
    R, D = src_ids.shape[0], src.shape[1]
    seg = lay.seg.long()
    order = (torch.arange(R) if lay.order is None else lay.order.long())
    lens = seg[1:] - seg[:-1]
    acc = torch.zeros((lay.n, D), dtype=torch.float32)
    bad = torch.zeros((lay.n, D), dtype=torch.bool)
    s = scale.float()
    for p in range(int(lens.max()) if R else 0):
        rows = torch.nonzero(lens > p).flatten()
        i = order[seg[rows] + p]
        x = src[src_ids[i].long()].float()
        if split:
            apart = (lens[rows] > dis.LONG) & (s[i] == 0)
            bad[rows] |= apart[:, None] & ~torch.isfinite(x)
            add = torch.where(apart[:, None], acc[rows],
                              acc[rows] + s[i, None] * x)
        else:
            add = acc[rows] + s[i, None] * x
        acc[rows] = add
    acc = torch.where(bad, torch.full_like(acc, float("nan")), acc)
    return acc.to(out_dtype)


def _equal_nan(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


# ---------------------------------------------------------------------------
# instances and layouts
# ---------------------------------------------------------------------------

def _view(dtype, rows, D, off=0):
    """A (rows, D) tensor in ``dtype``, ``off`` elements into its storage
    (CPU storage starts 64-byte aligned)."""
    return torch.zeros(rows * D + off, dtype=dtype)[off:].view(rows, D)


@pytest.mark.parametrize("dtype,D,off,dot_off,want", [
    (torch.bfloat16, 2048, 0, None, "vec"),
    (torch.bfloat16, 2100, 0, None, "general"),   # 2100 % 8
    (torch.bfloat16, 2048, 1, None, "general"),   # base off by 2 B
    (torch.bfloat16, 2048, 8, None, "vec"),       # 16 B in: aligned
    (torch.bfloat16, 2056, 0, None, "vec"),       # two passes
    (torch.bfloat16, 8, 0, None, "vec"),          # one chunk
    (torch.float32, 2100, 0, None, "vec"),        # 2100 % 4 == 0
    (torch.float32, 2102, 0, None, "general"),
    (torch.float32, 2048, 1, None, "general"),
    (torch.float32, 2048, 4, None, "vec"),        # 16 B in: aligned
    (torch.bfloat16, 2048, 0, 0, "vec"),
    (torch.bfloat16, 2048, 0, 1, "general"),      # the dot's source
    (torch.float16, 2048, 0, None, "general")])
def test_instance_routing(dtype, D, off, dot_off, want):
    src = _view(dtype, 3, D, off)
    dot = None if dot_off is None else _view(dtype, 5, D, dot_off)
    assert dis.instance(src, dot) == want


@pytest.mark.parametrize("seed,R,n", [(0, 200, 37), (1, 1000, 900),
                                      (2, 64, 1), (3, 500, 2000)])
def test_layout_by_sort_equals_argsort_searchsorted(seed, R, n):
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, n, R))
    lay = dis.RowLayout.by_sort(ids, n)
    order = torch.argsort(ids, stable=True)
    seg = torch.searchsorted(ids[order], torch.arange(n + 1))
    assert lay.ids.dtype == lay.seg.dtype == lay.order.dtype == torch.int32
    assert torch.equal(lay.ids.long(), ids)
    assert torch.equal(lay.order.long(), order)
    assert torch.equal(lay.seg.long(), seg)
    assert torch.equal(lay.sorted_ids.long(), ids[order])


@pytest.mark.parametrize("T,k", [(24, 2), (300, 4), (5, 1)])
def test_layout_by_blocks_is_the_identity(T, k):
    flat_tok = torch.arange(T * k) // k
    lay = dis.RowLayout.by_blocks(flat_tok, T, k)
    ref = dis.RowLayout.by_sort(flat_tok, T)
    assert lay.order is None and lay.sorted_ids is None
    assert torch.equal(ref.order.long(), torch.arange(T * k))
    assert torch.equal(lay.seg, ref.seg)
    assert torch.equal(lay.seg.long(), torch.arange(T + 1) * k)
    with pytest.raises(RuntimeError):   # an unsorted flat_tok is refused
        dis.RowLayout.by_blocks(flat_tok.flip(0), T, k)


@pytest.mark.parametrize("bias", [0.0, 3.0])
def test_slot0_holds_every_drop_in_row_order(bias):
    w, flat_tok, slot, keep, cap = _routing(11, 64, 8, 2, bias)
    by_slot, by_token = dis.routing_layouts(
        _t(flat_tok), _t(slot), _t(keep), 8 * cap, 64, k=2)
    dst = np.where(keep, slot, 0)
    assert torch.equal(by_slot.ids, _t(dst))
    seg0 = by_slot.order[by_slot.seg[0]:by_slot.seg[1]].long()
    assert torch.equal(seg0, _t(np.flatnonzero(dst == 0)))
    assert (len(seg0) > 1) == (bias > 0)
    assert len(seg0) == int((~keep).sum()) + int((slot[keep] == 0).sum())
    assert torch.equal(by_token.seg.long(), torch.arange(65) * 2)


# ---------------------------------------------------------------------------
# the movements against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias,k_given", [(0.0, True), (3.0, True),
                                          (3.0, False)])
def test_token_movements_with_shared_layouts_match_reference(bias, k_given):
    T, E, k, D = 40, 6, 2, 16
    w, flat_tok, slot, keep, cap = _routing(6, T, E, k, bias)
    assert keep.all() == (bias == 0.0)
    rng = np.random.default_rng(7)
    xt = rng.standard_normal((T, D)).astype(np.float32)
    y2d = rng.standard_normal((E * cap, D)).astype(np.float32)
    cb = rng.standard_normal((E * cap, D)).astype(np.float32)
    co = rng.standard_normal((T, D)).astype(np.float32)

    def jfn(xt, y2d, w):
        buf = jdis.token_dispatch(xt, flat_tok, slot, keep, E * cap,
                                  use_kernel=False)
        out = jdis.token_combine(y2d, flat_tok, slot, keep, w, T,
                                 use_kernel=False)
        return jnp.sum(buf * cb) + jnp.sum(out * co), (buf, out)

    (_, (jbuf, jout)), gj = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                               has_aux=True)(
        jnp.asarray(xt), jnp.asarray(y2d), jnp.asarray(w))
    lay = dis.routing_layouts(_t(flat_tok), _t(slot), _t(keep), E * cap, T,
                              k=k if k_given else None)
    txt, ty, tw = (_t(a).requires_grad_(True) for a in (xt, y2d, w))
    tbuf = dis.token_dispatch(txt, _t(flat_tok), _t(slot), _t(keep), E * cap,
                              layouts=lay)
    tout = dis.token_combine(ty, _t(flat_tok), _t(slot), _t(keep), tw, T,
                             layouts=lay)
    np.testing.assert_allclose(tbuf.detach().numpy(), np.asarray(jbuf), **TOL)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    gt = torch.autograd.grad((tbuf * _t(cb)).sum() + (tout * _t(co)).sum(),
                             (txt, ty, tw))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("move", ["dispatch", "combine"])
def test_token_movements_need_layouts_on_the_kernel_path(move):
    """The kernel path takes the routing's layouts from its caller and
    builds none itself; the plain path needs none."""
    T, E, k, D = 16, 4, 2, 8
    w, flat_tok, slot, keep, cap = _routing(8, T, E, k, 3.0)
    x = torch.ones((T if move == "dispatch" else E * cap, D))
    args = (_t(flat_tok), _t(slot), _t(keep))
    if move == "dispatch":
        def call(**kw):
            return dis.token_dispatch(x, *args, E * cap, **kw)
    else:
        def call(**kw):
            return dis.token_combine(x, *args, _t(w), T, **kw)
    with pytest.raises(ValueError, match="layouts"):
        call()
    lay = dis.routing_layouts(*args, E * cap, T, k=k)
    assert torch.equal(call(layouts=lay), call(use_kernel=False))


def _combine_case(seed, T, E, k, D, bias, dtype=torch.float32):
    w, flat_tok, slot, keep, cap = _routing(seed, T, E, k, bias)
    rng = np.random.default_rng(seed + 1)
    y2d = torch.as_tensor(rng.standard_normal((E * cap, D)),
                          dtype=torch.float32).to(dtype)
    dout = torch.as_tensor(rng.standard_normal((T, D)),
                           dtype=torch.float32).to(dtype)
    lay = dis.routing_layouts(_t(flat_tok), _t(slot), _t(keep), E * cap, T,
                              k=k)
    return w, flat_tok, slot, keep, cap, y2d, dout, lay


def _jax_dw(w, flat_tok, slot, keep, y2d, dout, T):
    """jax.grad of the reference's use_kernel=False combine, w.r.t. the
    routing weights, on the f32 values of y2d and dout."""
    y, d = (jnp.asarray(t.float().numpy()) for t in (y2d, dout))
    return np.asarray(jax.grad(lambda w: jnp.sum(jdis.token_combine(
        y, flat_tok, slot, keep, w, T, use_kernel=False) * d))(
            jnp.asarray(w)))


@pytest.mark.parametrize("D,dtype", [(64, torch.float32),
                                     (520, torch.float32),
                                     (2048, torch.float32),    # two passes
                                     (2056, torch.float32),    # three
                                     (2048, torch.bfloat16),
                                     (2104, torch.bfloat16)])  # two
def test_dscale_in_kernel_order_matches_jax_grad(D, dtype):
    T, E, k = 48, 8, 2
    w, flat_tok, slot, keep, cap, y2d, dout, lay = _combine_case(
        21, T, E, k, D, 3.0, dtype)
    by_slot, by_token = lay
    a, b = y2d[by_slot.ids.long()], dout[by_token.ids.long()]
    got = dis.dscale_in_kernel_order(a, b)
    want = _jax_dw(w, flat_tok, slot, keep, y2d, dout, T)
    scale = (a.float() * b.float()).abs().sum(-1)
    err = ((got - _t(want)).abs() / scale)[_t(keep)]
    assert err.max() <= DSCALE_REL, err.max()
    # the fused backward's dscale is this order's, and the weights'
    # gradient is it where kept, 0 where dropped
    tw = _t(w).requires_grad_(True)
    out = dis.token_combine(y2d, _t(flat_tok), _t(slot), _t(keep), tw, T,
                            layouts=lay)
    (gw,) = torch.autograd.grad(out, tw, dout)
    np.testing.assert_allclose(gw.numpy(), want, **TOL)
    assert (gw[_t(~keep)] == 0).all()


@pytest.mark.parametrize("move", ["dispatch", "combine"])
@pytest.mark.parametrize("D", [2048, 200])
def test_emulated_backward_bf16_equals_f32_then_cast(move, D):
    """dsrc as the kernel forms it from a bf16 dout (f32 sums, one
    rounding into bf16) equals the parent's path (an f32 copy of dout,
    summed, then cast) bit for bit, and the plain version's."""
    w, flat_tok, slot, keep, cap, y2d, dout, lay = _combine_case(
        31, 64, 8, 2, D, 3.0, torch.bfloat16)
    by_slot, by_token = lay
    keep_t = _t(keep)
    if move == "dispatch":   # dxt: rows of dbuf by slot into tokens
        src, scale, src_ids, dst = y2d, keep_t.float(), by_slot.ids, by_token
    else:                    # dy2d: rows of dout by token into slots
        src, scale, src_ids, dst = (dout, torch.where(keep_t, _t(w), 0.0),
                                    by_token.ids, by_slot)
    bf = _walk(src, scale, src_ids, dst, torch.bfloat16)
    f32 = _walk(src.float(), scale, src_ids, dst, torch.float32)
    assert torch.equal(bf, f32.to(torch.bfloat16))
    assert torch.equal(bf, gather_scatter_add_ref(src, src_ids, dst.ids,
                                                  scale, dst.n))
    assert torch.equal(bf, dis.move(src, scale, dis.RowLayout(
        src_ids, src.shape[0], None, None, None), dst)[0])


@pytest.mark.parametrize("poison", [None, "inf", "-inf", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_long_segment_split_equals_the_in_order_walk(poison, dtype):
    """Slot 0's long segment as the kernel splits it (nonzero-scale
    entries in order, zero-scale entries only marking inf/NaN columns)
    equals the in-order walk, NaN where NaN."""
    T, E, k, D = 256, 8, 2, 96
    w, flat_tok, slot, keep, cap = _routing(41, T, E, k, 3.0)
    by_slot, by_token = dis.routing_layouts(_t(flat_tok), _t(slot),
                                            _t(keep), E * cap, T, k=k)
    assert int(by_slot.seg[1]) > dis.LONG
    rng = np.random.default_rng(42)
    xt = torch.as_tensor(rng.standard_normal((T, D)),
                         dtype=torch.float32).to(dtype)
    scale = _t(keep).float()
    if poison:
        dropped = np.flatnonzero(~keep)
        xt[flat_tok[dropped[5]], 7] = float(poison)
        xt[flat_tok[dropped[-1]], 40:48] = float(poison)
    want = _walk(xt, scale, by_token.ids, by_slot, dtype)
    got = _walk(xt, scale, by_token.ids, by_slot, dtype, split=True)
    assert _equal_nan(got, want)
    assert _equal_nan(want, gather_scatter_add_ref(xt, by_token.ids,
                                                   by_slot.ids, scale,
                                                   by_slot.n))
    if poison:
        assert torch.isnan(got[0, 7]) and torch.isnan(got[0, 40:48]).all()


# ---------------------------------------------------------------------------
# planted faults: each must break its check
# ---------------------------------------------------------------------------

def test_planted_segment_offset_off_by_one_breaks_the_walk():
    w, flat_tok, slot, keep, cap, y2d, dout, lay = _combine_case(
        51, 64, 8, 2, 32, 3.0)
    by_slot, by_token = lay
    scale = _t(keep).float()
    want = gather_scatter_add_ref(dout, by_token.ids, by_slot.ids, scale,
                                  by_slot.n)
    assert torch.equal(_walk(dout, scale, by_token.ids, by_slot,
                             torch.float32), want)
    r = int(torch.nonzero(by_slot.seg[1:] - by_slot.seg[:-1]).flatten()[3])
    seg = by_slot.seg.clone()
    seg[r + 1] += 1   # row r takes its neighbour's first entry
    bad = dis.RowLayout(by_slot.ids, by_slot.n, seg, by_slot.order,
                        by_slot.sorted_ids)
    assert not torch.equal(_walk(dout, scale, by_token.ids, bad,
                                 torch.float32), want)


def test_planted_identity_layout_for_unsorted_tokens_breaks_the_walk():
    """A token layout taken as the identity (offsets k * t, no order)
    while flat_tok is not sorted: the combine lands on the wrong tokens.
    The builder refuses such a flat_tok (above); a layout made by hand
    must fail the comparison."""
    T, E, k, D = 64, 8, 2, 32
    w, flat_tok, slot, keep, cap, y2d, dout, lay = _combine_case(
        61, T, E, k, D, 3.0)
    perm = np.random.default_rng(62).permutation(T)
    tok = perm[flat_tok]                 # tokens shuffled: unsorted
    scale = torch.where(_t(keep), _t(w), 0.0)
    by_slot = lay[0]
    want = gather_scatter_add_ref(y2d, by_slot.ids, _t(tok), scale, T)
    good = dis.RowLayout.by_sort(_t(tok), T)
    assert torch.equal(_walk(y2d, scale, by_slot.ids, good, torch.float32),
                       want)
    ident = dis.RowLayout(_t(tok).int(), T, torch.arange(
        T + 1, dtype=torch.int32) * k, None, None)
    assert not torch.equal(_walk(y2d, scale, by_slot.ids, ident,
                                 torch.float32), want)


def test_planted_dscale_on_the_wrong_row_breaks_its_limit():
    T, E, k, D = 48, 8, 2, 256
    w, flat_tok, slot, keep, cap, y2d, dout, lay = _combine_case(
        71, T, E, k, D, 3.0)
    by_slot, by_token = lay
    want = _t(_jax_dw(w, flat_tok, slot, keep, y2d, dout, T))
    a = y2d[by_slot.ids.long()]
    b = dout[by_token.ids.long()]
    scale = (a * b).abs().sum(-1)
    kept = _t(keep)
    right = dis.dscale_in_kernel_order(a, b)
    assert (((right - want).abs() / scale)[kept] <= DSCALE_REL).all()
    wrong = dis.dscale_in_kernel_order(
        y2d[(by_slot.ids.long() + 1) % by_slot.n], b)
    assert (((wrong - want).abs() / scale)[kept] > DSCALE_REL).any()
