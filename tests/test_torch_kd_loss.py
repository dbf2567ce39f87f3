"""The port's fused KD loss against the JAX reference, on the CPU.

Reference: ``repro.kernels.kd_loss.ops`` (the Pallas kernel in interpret
mode, custom-VJP backward) and its dense oracle ``ref.py``.  Port: the
plain forward (``ref.py``, which the wrapper runs on CPU tensors) and
the vocab-blocked backward that also runs on the card.  Same numpy
inputs, f32.  Values and gradients agree to 1e-5 (f32 sums over at most
a few hundred terms in other orders: observed differences are ~1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kd_loss import ops as jops
from repro.kernels.kd_loss import ref as jref
from repro_torch.kernels.kd_loss import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(T, Ds, Dt, V, seed=0):
    rng = np.random.default_rng(seed)
    x = dict(hs=rng.standard_normal((T, Ds)).astype(np.float32),
             ws=(rng.standard_normal((Ds, V)) / np.sqrt(Ds)).astype(
                 np.float32),
             labels=rng.integers(0, V, T).astype(np.int32),
             dce=rng.standard_normal(T).astype(np.float32),
             dkl=rng.standard_normal(T).astype(np.float32))
    if Dt:
        x["ht"] = rng.standard_normal((T, Dt)).astype(np.float32)
        x["wt"] = (rng.standard_normal((Dt, V)) / np.sqrt(Dt)).astype(
            np.float32)
    return x


def _tied(x):
    """Plant a tie: row 0's logits peak at two columns (identical head
    columns, far apart), and rows 1.. keep theirs."""
    ws = x["ws"]
    V = ws.shape[1]
    a, b = 3, V - 5
    ws[:, b] = ws[:, a] = x["hs"][0] * 2.0
    x["labels"][0] = a
    x["labels"][1] = b
    return x


# (T, Ds, Dt, V, tau, softcap_s, softcap_t, block_v, tie): ragged T and V
# against the blocks, softcap on each side, τ ≠ 1, Ds ≠ Dt
CASES = [
    (37, 24, 0, 300, 1.0, 0.0, 0.0, 128, True),
    (40, 32, 0, 512, 1.0, 5.0, 0.0, 128, False),
    (29, 24, 16, 300, 2.0, 3.0, 2.0, 128, False),
    (33, 16, 40, 257, 0.5, 0.0, 4.0, 64, True),
]
IDS = [f"T{c[0]}-Ds{c[1]}-Dt{c[2]}-V{c[3]}-tau{c[4]}-cap{c[5]}/{c[6]}"
       f"{'-tie' if c[8] else ''}" for c in CASES]


def _jax(x, Dt, tau, cap_s, cap_t, block_v):
    labels = jnp.asarray(x["labels"])
    if Dt:
        ht, wt = jnp.asarray(x["ht"]), jnp.asarray(x["wt"])

    def f(hs, ws):
        if Dt:
            ce, kl, cor = jops.ce_kl_from_hidden(
                hs, ws, ht, wt, labels, tau=tau, softcap_s=cap_s,
                softcap_t=cap_t, block_v=block_v)
        else:
            ce, cor = jops.ce_from_hidden(hs, ws, labels, softcap=cap_s,
                                          block_v=block_v)
            kl = jnp.zeros_like(ce)
        return jnp.sum(ce * x["dce"]) + jnp.sum(kl * x["dkl"]), (ce, kl, cor)

    (_, out), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(x["hs"]),
                                          jnp.asarray(x["ws"]))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _port(x, Dt, tau, cap_s, cap_t, block_v):
    hs = torch.tensor(x["hs"], requires_grad=True)
    ws = torch.tensor(x["ws"], requires_grad=True)
    labels = torch.as_tensor(x["labels"])
    if Dt:
        ce, kl, cor = ops.ce_kl_from_hidden(
            hs, ws, torch.as_tensor(x["ht"]), torch.as_tensor(x["wt"]),
            labels, tau=tau, softcap_s=cap_s, softcap_t=cap_t,
            block_v=block_v)
        obj = (ce * torch.as_tensor(x["dce"])).sum() + (
            kl * torch.as_tensor(x["dkl"])).sum()
    else:
        ce, cor = ops.ce_from_hidden(hs, ws, labels, softcap=cap_s,
                                     block_v=block_v)
        kl = torch.zeros_like(ce)
        obj = (ce * torch.as_tensor(x["dce"])).sum()
    obj.backward()
    return ([t.detach().numpy() for t in (ce, kl, cor)],
            [hs.grad.numpy(), ws.grad.numpy()])


@functools.lru_cache(maxsize=None)
def _run(case):
    """Inputs, then (values, gradients) of the reference and of the port:
    computed once per case, shared by the value and gradient tests."""
    T, Ds, Dt, V, tau, cap_s, cap_t, block_v, tie = case
    x = _inputs(T, Ds, Dt, V)
    if tie:
        x = _tied(x)
    args = (Dt, tau, cap_s, cap_t, block_v)
    return x, _jax(x, *args), _port(x, *args)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_values_match_reference(case):
    T, Ds, Dt, V, tau, cap_s, cap_t, block_v, tie = case
    x, ((jce, jkl, jcor), _), ((tce, tkl, tcor), _) = _run(case)
    np.testing.assert_allclose(tce, jce, **TOL)
    np.testing.assert_allclose(tkl, jkl, **TOL)
    np.testing.assert_array_equal(tcor, jcor)
    if tie:   # the lower of the two tied columns wins, in both
        assert tcor[0] == 1.0 and tcor[1] == 0.0
    # and the reference's dense oracle
    if Dt:
        oce, okl, ocor = jref.ce_kl_ref(x["hs"], x["ws"], x["ht"], x["wt"],
                                        x["labels"], tau=tau,
                                        softcap_s=cap_s, softcap_t=cap_t)
        np.testing.assert_allclose(tkl, np.asarray(okl), **TOL)
    else:
        oce, ocor = jref.ce_ref(x["hs"], x["ws"], x["labels"],
                                softcap=cap_s)
    np.testing.assert_allclose(tce, np.asarray(oce), **TOL)
    np.testing.assert_array_equal(tcor, np.asarray(ocor))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gradients_match_reference(case):
    """hs and ws gradients of Σ ce·dce (+ Σ kl·dkl): the port's blocked
    backward against ``jax.grad`` through the reference's custom VJP."""
    _, (_, (jdh, jdw)), (_, (tdh, tdw)) = _run(case)
    np.testing.assert_allclose(tdh, jdh, **TOL)
    np.testing.assert_allclose(tdw, jdw, **TOL)


def test_teacher_gets_no_gradient():
    x = _inputs(9, 8, 12, 50)
    ht = torch.tensor(x["ht"], requires_grad=True)
    wt = torch.tensor(x["wt"], requires_grad=True)
    ce, kl, _ = ops.ce_kl_from_hidden(
        torch.tensor(x["hs"], requires_grad=True),
        torch.tensor(x["ws"], requires_grad=True), ht, wt,
        torch.as_tensor(x["labels"]), tau=2.0)
    (ce.sum() + kl.sum()).backward()
    assert ht.grad is None and wt.grad is None


def test_leading_dims_and_tied_head_view():
    """(B, S, D) hiddens and a transposed (tied-embedding) head view give
    the flat call's values, and the head's gradient reaches the embed."""
    x = _inputs(12, 16, 0, 40)
    embed = torch.tensor(x["ws"].T.copy(), requires_grad=True)   # (V, D)
    hs = torch.tensor(x["hs"]).reshape(3, 4, 16)
    ce, cor = ops.ce_from_hidden(hs, embed.T, torch.as_tensor(
        x["labels"]).reshape(3, 4))
    assert ce.shape == cor.shape == (3, 4)
    want, _ = ref.ce_ref(torch.tensor(x["hs"]), torch.tensor(x["ws"]),
                         torch.as_tensor(x["labels"]))
    torch.testing.assert_close(ce.reshape(-1), want, **TOL)
    ce.sum().backward()
    assert embed.grad.shape == (40, 16)


def test_inputs_are_checked():
    hs, ws = torch.zeros(4, 8), torch.zeros(8, 16)
    with pytest.raises(ValueError, match="labels"):
        ops.kd_loss_fwd(hs, ws, None, None, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="ws"):
        ops.kd_loss_fwd(hs, torch.zeros(7, 16), None, None,
                        torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="both"):
        ops.kd_loss_fwd(hs, ws, torch.zeros(4, 3), None,
                        torch.zeros(4, dtype=torch.int32))


def test_vocab_splits_cover_the_vocab():
    for inst in ops.TILES:
        for teacher in (False, True):
            _, tile_v = ops.tile_shape(inst, teacher)
            for T, V, n_sm in [(2048, 32000, 132), (64, 129, 132),
                               (5000, 128, 8), (1, 1, 132), (130, 1000, 132),
                               (2048, 151936, 132), (20000, 4104, 132)]:
                ns, tps = ops.vocab_splits(T, V, n_sm, inst, teacher)
                n_tiles = -(-V // tile_v)
                assert (ns - 1) * tps < n_tiles <= ns * tps
    # the paths' shapes in the wgmma instance: 16 row tiles x 8 splits =
    # 128 blocks, one wave of 132 SMs at one block an SM
    assert ops.vocab_splits(2048, 32000, 132) == (8, 16)
    assert ops.vocab_splits(2048, 151936, 132) == (8, 75)
    assert ops.vocab_splits(2048, 32000, 132, "wgmma", True) == (8, 32)
    # the general instance: 32 row tiles x 16 splits, four blocks an SM
    assert ops.vocab_splits(2048, 32000, 132, "general") == (16, 16)


@pytest.mark.parametrize("dtype,Ds,Dt,V,offset,want", [
    (torch.bfloat16, 2048, 0, 32000, 0, "wgmma"),
    (torch.bfloat16, 136, 72, 4104, 0, "wgmma"),
    (torch.bfloat16, 136, 0, 4099, 0, "general"),
    (torch.bfloat16, 136, 70, 4104, 0, "general"),
    (torch.bfloat16, 132, 0, 4104, 0, "general"),
    (torch.bfloat16, 136, 0, 4104, 1, "general"),
    (torch.float32, 136, 0, 4104, 0, "f32")])
def test_instance_follows_shapes_and_pointers(dtype, Ds, Dt, V, offset,
                                              want):
    T = 3
    hs = torch.zeros(T * Ds + offset, dtype=dtype)[offset:].view(T, Ds)
    ws = torch.zeros(Ds, V, dtype=dtype)
    ht = torch.zeros(T, Dt, dtype=dtype) if Dt else None
    wt = torch.zeros(Dt, V, dtype=dtype) if Dt else None
    assert ops.instance(hs, ws, ht, wt) == want
