"""The port's MoE kernels' plain versions against the JAX reference, on
the CPU.

``grouped_ffn`` and ``grouped_matmul`` (kernels 4 and 5) go against the
reference's Pallas kernels run in interpret mode, and the grouped FFN's
gradient also against the explicit-chain ``grouped_ffn_bwd_ref``.
``gather_scatter_add`` (kernel 6) goes against the reference's
``moe_dispatch/ref.py`` (the Pallas ``_gsa_kernel`` needs
``pl.load``/``pl.store``, which the installed JAX lacks), and
``token_dispatch`` / ``token_combine`` against the reference's
``use_kernel=False`` versions.  ``moe_ffn`` is held to ``moe_ffn_ref``
where nothing drops, and, with a router biased onto one expert so that
assignments drop, to the reference's capacity path composed from its
JAX-only pieces.  Inputs from numpy with a seed, f32 on both sides.

Tolerances: values and gradients 1e-5 absolute + 1e-4 relative (f32
sums in other orders over at most a few hundred terms; observed ~1e-6);
integer ranks and keep masks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_dispatch import ops as jdis
from repro.kernels.moe_dispatch.ref import gather_scatter_add_ref as j_gsa_ref
from repro.kernels.moe_gemm import kernel as jkernel
from repro.kernels.moe_gemm import ops as jgemm
from repro.kernels.moe_gemm import ref as jref
from repro_torch.kernels.moe_dispatch import ops as dis
from repro_torch.kernels.moe_gemm import ops as gemm
from repro_torch.kernels.moe_gemm import ref as tref

TOL = dict(atol=1e-5, rtol=1e-4)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))  # a writable copy


def _ffn_inputs(seed, E, C, D, F):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (E, C, D)), _rand(rng, (E, D, F), D ** -0.5),
            _rand(rng, (E, D, F), D ** -0.5), _rand(rng, (E, F, D), F ** -0.5),
            _rand(rng, (E, C, D)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", [(3, 20, 24, 40), (2, 16, 32, 16)])
def test_grouped_ffn_matches_reference(E, C, D, F, act):
    x, wg, wu, wo, _ = _ffn_inputs(0, E, C, D, F)
    want = jgemm.grouped_ffn(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu),
                             jnp.asarray(wo), act=act, block_c=16, block_f=16)
    got = gemm.grouped_ffn(_t(x), _t(wg), _t(wu), _t(wo), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tref.grouped_ffn_ref(_t(x), _t(wg), _t(wu), _t(wo), act=act).numpy(),
        np.asarray(jref.grouped_ffn_ref(x, wg, wu, wo, act=act)), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_ffn_grads_match_reference(act):
    x, wg, wu, wo, dy = _ffn_inputs(1, 3, 20, 24, 40)
    jargs = [jnp.asarray(a) for a in (x, wg, wu, wo)]
    gj = jax.grad(lambda *a: jnp.sum(jgemm.grouped_ffn(
        *a, act=act, block_c=16, block_f=16) * dy), argnums=(0, 1, 2, 3))(
        *jargs)
    gb = jref.grouped_ffn_bwd_ref(x, wg, wu, wo, dy, act=act)
    targs = [_t(a).requires_grad_(True) for a in (x, wg, wu, wo)]
    y = gemm.grouped_ffn(*targs, act=act)
    gt = torch.autograd.grad((y * _t(dy)).sum(), targs)
    gr = tref.grouped_ffn_bwd_ref(_t(x), _t(wg), _t(wu), _t(wo), _t(dy),
                                  act=act)
    for name, a, b, c, d in zip(("dx", "dwg", "dwu", "dwo"), gt, gj, gb, gr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL,
                                   err_msg=name)
        np.testing.assert_allclose(d.numpy(), np.asarray(c), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_grouped_matmul_matches_reference(ta, tb):
    """Transposed operands are views in the port (strides), swapaxes
    copies in the reference."""
    rng = np.random.default_rng(2)
    E, M, K, N = 2, 20, 33, 17
    a = _rand(rng, (E, K, M) if ta else (E, M, K))
    b = _rand(rng, (E, N, K) if tb else (E, K, N))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta_, tb_ = _t(a), _t(b)
    if ta:
        ja, ta_ = jnp.swapaxes(ja, 1, 2), ta_.transpose(1, 2)
    if tb:
        jb, tb_ = jnp.swapaxes(jb, 1, 2), tb_.transpose(1, 2)
    want = jkernel.grouped_matmul(ja, jb, block_m=16, block_n=16, block_k=16,
                                  interpret=True)
    got = gemm.grouped_matmul(ta_, tb_)
    assert got.dtype == torch.float32 and got.shape == (E, M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _movement(seed, Ns, R, n_out, D):
    rng = np.random.default_rng(seed)
    src = _rand(rng, (Ns, D))
    src_rows = rng.integers(0, Ns, R).astype(np.int32)
    dst_rows = rng.integers(0, n_out, R).astype(np.int32)  # repeats
    scale = _rand(rng, (R,))
    scale[::5] = 0.0                      # dropped assignments
    return src, src_rows, dst_rows, scale


def test_gather_scatter_add_matches_reference_and_grads():
    src, sr, dr, sc = _movement(3, 13, 40, 9, 16)
    want = j_gsa_ref(jnp.asarray(src), jnp.asarray(sr), jnp.asarray(dr),
                     jnp.asarray(sc), 9)
    ts, tsc = _t(src).requires_grad_(True), _t(sc).requires_grad_(True)
    got = dis.gather_scatter_add(ts, tsc, _t(sr), _t(dr), 9)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    dout = _rand(np.random.default_rng(4), (9, 16))
    gj = jax.grad(lambda s, c: jnp.sum(j_gsa_ref(s, sr, dr, c, 9) * dout),
                  argnums=(0, 1))(jnp.asarray(src), jnp.asarray(sc))
    gt = torch.autograd.grad((got * _t(dout)).sum(), (ts, tsc))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_gather_scatter_add_adds_rows_in_order():
    """The plain version adds each destination's rows in row order in
    f32, as the TPU kernel walks them: three rows whose sum depends on
    the order (1 + 2^-24 - 1 rounds differently from 1 - 1 + 2^-24)."""
    src = torch.tensor([[1.0], [2.0 ** -24], [-1.0]])
    out = dis.gather_scatter_add_rows(
        src, torch.tensor([0, 1, 2]), torch.tensor([0, 0, 0]),
        torch.ones(3), 1)
    assert out.item() == 0.0  # (1 + 2^-24) rounds to 1, then 1 - 1
    out = dis.gather_scatter_add_rows(
        src, torch.tensor([0, 2, 1]), torch.tensor([0, 0, 0]),
        torch.ones(3), 1)
    assert out.item() == 2.0 ** -24


@pytest.mark.parametrize("with_valid", [False, True])
def test_capacity_positions_equal_integers(with_valid):
    rng = np.random.default_rng(5)
    flat_e = rng.integers(0, 5, 64).astype(np.int32)
    valid = rng.random(64) < 0.7 if with_valid else None
    pj, kj = jdis.capacity_positions(
        jnp.asarray(flat_e), 6,
        valid=None if valid is None else jnp.asarray(valid))
    pt, kt = dis.capacity_positions(
        _t(flat_e).long(), 6, valid=None if valid is None else _t(valid))
    assert pt.dtype == torch.int32
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert (~kt).any()


def _routing(seed, T, E, k, bias=0.0):
    """Softmax-top-k routing from random logits, ``bias`` added to
    expert 0's logit (a router biased onto one expert)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits[:, 0] += bias
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    idx = np.argsort(-p, axis=-1, kind="stable")[:, :k].astype(np.int32)
    w = np.take_along_axis(p, idx, -1)
    return (w / w.sum(-1, keepdims=True)).astype(np.float32), idx


@pytest.mark.parametrize("use_kernel", [True, False])
def test_token_dispatch_combine_match_reference_and_grads(use_kernel):
    T, E, k, D = 24, 6, 2, 8
    w, idx = _routing(6, T, E, k, bias=2.0)
    cap = 6
    rng = np.random.default_rng(7)
    xt = _rand(rng, (T, D))
    y2d = _rand(rng, (E * cap, D))
    flat_e = idx.reshape(-1)
    flat_tok = (np.arange(T * k) // k).astype(np.int32)
    pj, kj = jdis.capacity_positions(jnp.asarray(flat_e), cap)
    slot = np.asarray(flat_e) * cap + np.asarray(pj)
    keep = np.asarray(kj)
    assert not keep.all()

    def jfn(xt, y2d, w):
        buf = jdis.token_dispatch(xt, flat_tok, slot, keep, E * cap,
                                  use_kernel=False)
        out = jdis.token_combine(y2d, flat_tok, slot, keep, w.reshape(-1), T,
                                 use_kernel=False)
        return buf, out

    jbuf, jout = jfn(jnp.asarray(xt), jnp.asarray(y2d), jnp.asarray(w))
    txt, ty, tw = (_t(a).requires_grad_(True) for a in (xt, y2d, w))
    lay = (dis.routing_layouts(_t(flat_tok), _t(slot), _t(keep), E * cap, T,
                               k=k) if use_kernel else None)
    tbuf = dis.token_dispatch(txt, _t(flat_tok), _t(slot), _t(keep), E * cap,
                              use_kernel=use_kernel, layouts=lay)
    tout = dis.token_combine(ty, _t(flat_tok), _t(slot), _t(keep),
                             tw.reshape(-1), T, use_kernel=use_kernel,
                             layouts=lay)
    np.testing.assert_allclose(tbuf.detach().numpy(), np.asarray(jbuf), **TOL)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    cb = _rand(rng, (E * cap, D))
    co = _rand(rng, (T, D))
    gj = jax.grad(lambda *a: jnp.sum(jfn(*a)[0] * cb) + jnp.sum(jfn(*a)[1]
                                                               * co),
                  argnums=(0, 1, 2))(jnp.asarray(xt), jnp.asarray(y2d),
                                     jnp.asarray(w))
    gt = torch.autograd.grad((tbuf * _t(cb)).sum() + (tout * _t(co)).sum(),
                             (txt, ty, tw))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _ref_capacity_path(xt, w, idx, wg, wu, wo, act):
    """The reference's ``moe_ffn`` composed from its JAX-only pieces:
    the same capacity, ranks and drops, the grouped FFN in interpret
    mode, the XLA dispatch/combine."""
    T, D = xt.shape
    k = idx.shape[1]
    E = wg.shape[0]
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    flat_tok = jnp.arange(T * k, dtype=jnp.int32) // k
    pos, keep = jdis.capacity_positions(flat_e, cap)
    slot = flat_e * cap + pos
    buf = jdis.token_dispatch(xt, flat_tok, slot, keep, E * cap,
                              use_kernel=False)
    y = jgemm.grouped_ffn(buf.reshape(E, cap, D), wg, wu, wo, act=act,
                          block_c=16, block_f=16)
    out = jdis.token_combine(y.reshape(E * cap, D), flat_tok, slot, keep,
                             w.reshape(-1), T, use_kernel=False)
    return out.astype(xt.dtype), int(jnp.sum(~keep))


@pytest.mark.parametrize("case", ["no_drop", "forced_drop"])
def test_moe_ffn_matches_reference_with_grads(case):
    if case == "no_drop":   # 2k >= E: no expert can overflow cap >= T
        T, E, k, D, F, bias, act = 20, 4, 2, 16, 24, 0.0, "silu"
    else:                   # biased onto expert 0: more than cap arrive
        T, E, k, D, F, bias, act = 40, 6, 2, 16, 24, 3.0, "gelu"
    w, idx = _routing(8, T, E, k, bias=bias)
    rng = np.random.default_rng(9)
    xt = _rand(rng, (T, D))
    wg, wu = _rand(rng, (E, D, F), D ** -0.5), _rand(rng, (E, D, F), D ** -0.5)
    wo = _rand(rng, (E, F, D), F ** -0.5)
    dout = _rand(rng, (T, D))
    jargs = [jnp.asarray(a) for a in (xt, w, wg, wu, wo)]
    if case == "no_drop":
        def jfn(xt, w, wg, wu, wo):
            return jref.moe_ffn_ref(xt, w, jnp.asarray(idx), wg, wu, wo,
                                    act=act)
        dropped = 0
    else:
        def jfn(xt, w, wg, wu, wo):
            return _ref_capacity_path(xt, w, jnp.asarray(idx), wg, wu, wo,
                                      act)[0]
        dropped = _ref_capacity_path(*jargs[:2], jnp.asarray(idx),
                                     *jargs[2:], act)[1]
        assert dropped > 0
    want = jfn(*jargs)
    gj = jax.grad(lambda *a: jnp.sum(jfn(*a) * dout),
                  argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [_t(a).requires_grad_(True) for a in (xt, w, wg, wu, wo)]
    _, keep = dis.capacity_positions(_t(idx).long().reshape(-1),
                                     max(-(-T * k // E) * 2, 8))
    assert int((~keep).sum()) == dropped
    got = gemm.moe_ffn(targs[0], targs[1], _t(idx).long(), *targs[2:],
                       act=act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    gt = torch.autograd.grad((got * _t(dout)).sum(), targs)
    for name, a, b in zip(("xt", "w", "wg", "wu", "wo"), gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)
    # the plain versions: the capacity path from plain pieces (what the
    # card's kernels are held to) and, without drops, the dropless oracle
    plain = [tref.moe_ffn_capacity_ref]
    if case == "no_drop":
        plain.append(tref.moe_ffn_ref)
    for fn in plain:
        pargs = [_t(a).requires_grad_(True) for a in (xt, w, wg, wu, wo)]
        out = fn(pargs[0], pargs[1], _t(idx).long(), *pargs[2:], act=act)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   **TOL)
        gp = torch.autograd.grad((out * _t(dout)).sum(), pargs)
        for name, a, b in zip(("xt", "w", "wg", "wu", "wo"), gp, gj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                       err_msg=f"{fn.__name__} {name}")


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """The plain versions run only for CPU tensors: another device is
    refused, never computed on the side."""
    meta = torch.empty((2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gemm.grouped_matmul(meta, torch.empty((2, 8, 3), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gemm.grouped_ffn_fwd(meta, torch.empty((2, 8, 5), device="meta"),
                             torch.empty((2, 8, 5), device="meta"),
                             torch.empty((2, 5, 8), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        dis.gather_scatter_add_rows(
            torch.empty((4, 8), device="meta"),
            torch.zeros(3, dtype=torch.int32, device="meta"),
            torch.zeros(3, dtype=torch.int32, device="meta"),
            torch.ones(3, device="meta"), 2)
