"""View-Aligned Attention (VAA) of the port against the JAX reference, on
the CPU.

The same VAA parameters (drawn by ``jax.random`` and converted with
``convert.vaa_from_jax``) and the same numpy stage features go through
both packages, f32: ``patchify`` (S below and not a multiple of the
patch count, edge-padded), ``vaa_apply``, and ``feature_matching_loss``
with its gradient against ``jax.grad``, with respect to the VAA
parameters and to the student stages.  Tolerance 1e-5 absolute + 1e-4
relative (f32 sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vaa as jvaa
from repro_torch import convert
from repro_torch.core import vaa

TOL = dict(atol=1e-5, rtol=1e-4)
J, DS, DT, D, HEADS, PQ = 3, 24, 40, 16, 4, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and more oversubscribe a CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jparams(seed=0):
    return jvaa.init_vaa(jax.random.PRNGKey(seed), n_stages=J, d_student=DS,
                         d_teacher=DT, d=D, n_heads=HEADS, p_q=PQ)


def _stages(B, S, dim, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, dim)).astype(np.float32)
            for _ in range(J)]


@pytest.mark.parametrize("S,P", [(3, 8), (10, 4), (13, 5), (16, 4), (1, 3)])
def test_patchify_matches_reference(S, P):
    x = np.random.default_rng(S).standard_normal((2, S, 6)).astype(
        np.float32)
    got = vaa.patchify(torch.as_tensor(x), P)
    want = np.asarray(jvaa.patchify(jnp.asarray(x), P))
    assert got.shape == (2, P, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_init_vaa_shapes_dtypes_and_scale():
    p = vaa.init_vaa(torch.Generator().manual_seed(0), n_stages=J,
                     d_student=256, d_teacher=DT, d=64, p_q=PQ)
    want = jax.tree.map(lambda a: (a.shape, a.dtype), jvaa.init_vaa(
        jax.random.PRNGKey(0), n_stages=J, d_student=256, d_teacher=DT,
        d=64, n_heads=HEADS, p_q=PQ))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in p.items()} == \
        {k: (tuple(s), "torch." + d.name) for k, (s, d) in want.items()}
    # fan-in: axis 1 for stage_proj / out_proj, axis 0 for the rest
    assert abs(p["stage_proj"].std().item() * 256 ** 0.5 - 0.88) < 0.05
    assert abs(p["wq"].std().item() * 64 ** 0.5 - 0.88) < 0.1
    with pytest.raises(ValueError, match="divide"):
        vaa.init_vaa(torch.Generator(), n_stages=5, d_student=8,
                     d_teacher=8, d=8, p_q=12)


def test_vaa_convert_round_trip_and_checks():
    pj = jax.tree.map(np.asarray, _jparams())
    pt = convert.vaa_from_jax(pj)
    back = convert.vaa_to_jax(pt)
    for k in pj:
        assert pt[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k], pj[k])
    missing = {k: v for k, v in pj.items() if k != "wk"}
    with pytest.raises(ValueError, match="VAA leaves"):
        convert.vaa_from_jax(missing)
    bad = dict(pj, wv=pj["wv"][:, :-1])
    with pytest.raises(ValueError, match="wv"):
        convert.vaa_from_jax(bad)
    bad = dict(pj, out_proj=pj["out_proj"][:2])
    with pytest.raises(ValueError, match="out_proj"):
        convert.vaa_from_jax(bad)
    with pytest.raises(TypeError, match="float32"):
        convert.vaa_from_jax(dict(pj, wq=pj["wq"].astype(np.float64)))


@pytest.mark.parametrize("S", [7, 32])
def test_vaa_apply_matches_reference(S):
    pj = _jparams(1)
    pt = convert.vaa_from_jax(jax.tree.map(np.asarray, pj))
    xs = _stages(2, S, DS, S)
    got = vaa.vaa_apply(pt, [torch.as_tensor(x) for x in xs],
                        n_heads=HEADS, p_q=PQ)
    want = jvaa.vaa_apply(pj, [jnp.asarray(x) for x in xs], n_heads=HEADS,
                          p_q=PQ)
    assert len(got) == J
    for g, w in zip(got, want):
        assert g.shape == (2, PQ // J, DT) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("S", [5, 24])
def test_feature_matching_loss_and_grads_match_reference(S):
    """L_FM and its gradient with respect to every VAA leaf and every
    student stage; the teacher stages (another width, another length
    when S is short) carry none."""
    pj = _jparams(2)
    pt = convert.vaa_from_jax(jax.tree.map(np.asarray, pj))
    xs = _stages(2, S, DS, 10 + S)
    ts = _stages(2, S + 3, DT, 20 + S)

    def jloss(p, s):
        return jvaa.feature_matching_loss(
            p, s, [jnp.asarray(t) for t in ts], n_heads=HEADS, p_q=PQ)

    lj, (gpj, gsj) = jax.value_and_grad(jloss, argnums=(0, 1))(
        pj, [jnp.asarray(x) for x in xs])
    leaves = [v.requires_grad_(True) for v in pt.values()]
    st = [torch.as_tensor(x).requires_grad_(True) for x in xs]
    lt = vaa.feature_matching_loss(pt, st, [torch.as_tensor(t) for t in ts],
                                   n_heads=HEADS, p_q=PQ)
    grads = torch.autograd.grad(lt, leaves + st)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for k, g in zip(pt, grads[:len(pt)]):
        np.testing.assert_allclose(g.numpy(), np.asarray(gpj[k]),
                                   err_msg=k, **TOL)
    for j, g in enumerate(grads[len(pt):]):
        np.testing.assert_allclose(g.numpy(), np.asarray(gsj[j]),
                                   err_msg=f"stage {j}", **TOL)
    assert all(g.abs().sum() > 0 for g in grads)


def test_bf16_student_stages_go_up_to_f32():
    """A bf16 student's stages are pooled in f32 beside f32 parameters:
    the same as handing over their f32 copies."""
    pt = convert.vaa_from_jax(jax.tree.map(np.asarray, _jparams(3)))
    xs = [torch.as_tensor(x).to(torch.bfloat16) for x in _stages(1, 9, DS, 3)]
    a = vaa.vaa_apply(pt, xs, n_heads=HEADS, p_q=PQ)
    b = vaa.vaa_apply(pt, [x.float() for x in xs], n_heads=HEADS, p_q=PQ)
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and torch.equal(x, y)
