"""AdamW moment policies of the port (``models/quant.py``'s
``MomentPolicy`` and int8 v codebook, ``optim/adamw.py``) against the
JAX reference, on the CPU.

Same inputs (numpy, seeded) through both packages, f32 parameters.
Limits (readings on this CPU in brackets):

* ``quantize_v``: scales bit for bit; codes equal except where XLA's
  and ATen's f32 ``log`` round a level boundary apart, each such code
  off by exactly one, at most 1 in 2,000 [4 to 13 of 65,536 on
  three seeds]; zeros exact; ``dequantize_v`` of equal codes within 4 f32
  ulps [2.9e-7 relative: ``exp`` an ulp apart, then squared].
* ``adamw_update``, 6 steps on gradients over six decades, every
  policy, a frozen leaf: parameters 1e-6 absolute [fp32 and int8
  2.4e-7]; f32 moments 1e-6 of their leaf's largest entry [2.3e-7];
  int8 codes equal except at most 1 in 1,000 [none]; stored bf16
  moments equal except where the f32 values, some ulps apart, sat on
  either side of a bf16 rounding boundary at some step, at most 1 in
  200 entries of a leaf [2 of 1,920], one bf16 ulp apart, and the
  parameters of such entries within lr · 2^-7 [3.2e-5]; the grad norm
  1e-6 relative [1.7e-7].
* the port's tracking property (the reference's
  ``test_moment_policies_track_fp32_scan_epoch``): bf16 losses within
  2e-2 [2.5e-5] and int8 within 5e-2 [2.6e-4] of the fp32 run's.
* Phase II ``distill_proxy`` with ``state_policy="int8"``: the loss
  history 2e-5 relative [1.7e-7].

A linear v codebook, planted in the port, must break the int8 update's
parameter limit tenfold [1.16, a million limits].
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import quant as jquant
from repro.optim import adamw as jadamw
from repro_torch.models import quant
from repro_torch.optim import adamw

from test_torch_train import port_cfg  # repo root on sys.path


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one thread a test process, so that parallel test workers do not
    # oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POLICIES = ["", "bf16", "int8"]
STEPS = 6
PARAM_ATOL = 1e-6
CODE_OFF_FRACTION = {"quantize": 1 / 2000, "update": 1 / 1000,
                     "bf16": 1 / 200}


def _v(seed, n=65536):
    """Second moments over twelve decades, a block of exact zeros."""
    rng = np.random.default_rng(seed)
    v = (rng.random(n, dtype=np.float32) ** 8 * 1e-3).astype(np.float32)
    v *= (10.0 ** rng.integers(-6, 0, n)).astype(np.float32)
    v[:64] = 0.0
    return v


def _codes_close(got, want, limit):
    """Codes equal, or off by one at a level boundary, rarely."""
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    off = got != want
    assert np.all(np.abs(got - want) <= 1)
    assert off.sum() <= limit * got.size, (off.sum(), got.size)
    return off


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_v_matches_reference(seed):
    v = _v(seed)
    qj, sj = jquant.quantize_v(jnp.asarray(v))
    qt, st = quant.quantize_v(torch.from_numpy(v))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == () and st.item() == float(sj)
    off = _codes_close(qt.numpy(), qj, CODE_OFF_FRACTION["quantize"])
    assert np.all(qt.numpy()[v == 0] == 0)
    dj = np.asarray(jquant.dequantize_v(qj, sj))
    dt = quant.dequantize_v(torch.tensor(np.asarray(qj)), st).numpy()
    assert np.all(dt[v == 0] == 0.0)
    np.testing.assert_allclose(dt, dj, rtol=4 * 2.0 ** -23, atol=0)
    # the port's own round trip: sub-floor entries saturate up to code 1
    back = quant.dequantize_v(qt, st).numpy()
    floor = st.item() ** 2 * np.exp(-2 * quant._V_ALPHA * 126 / 127)
    sub = (v > 0) & (v < floor)
    assert sub.any() and np.all(back[sub] >= v[sub])
    print("codes off by one:", int(off.sum()), "of", v.size)


def test_moment_policy_and_resolve_match_reference():
    for p in POLICIES:
        pt = adamw.resolve_moment_policy(p)
        pj = jadamw.resolve_moment_policy(p)
        assert (pt.m_dtype, pt.v_dtype, pt.v_quantized) == \
            (pj.m_dtype, pj.v_dtype, pj.v_quantized)
        assert str(pt.m_storage()).split(".")[-1] == \
            np.dtype(pj.m_storage()).name
        assert str(pt.v_storage()).split(".")[-1] == \
            np.dtype(pj.v_storage()).name
    assert adamw.resolve_moment_policy(None) == quant.MomentPolicy()
    with pytest.raises(ValueError, match="unknown moment policy"):
        adamw.resolve_moment_policy("int4")
    with pytest.raises(ValueError, match="m_dtype"):
        quant.MomentPolicy(m_dtype="int8")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((48, 40)).astype(np.float32),
                  "b": rng.standard_normal((40,)).astype(np.float32)},
            "frozen": rng.standard_normal((16, 8)).astype(np.float32),
            "z": rng.standard_normal((7,)).astype(np.float32)}


MASK = {"a": {"w": True, "b": True}, "frozen": False, "z": True}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("policy", POLICIES)
def test_adamw_init_structure_under_each_policy(policy):
    params = _to_torch(_tree(0))
    st = adamw.adamw_init(params, freeze_mask=MASK, policy=policy)
    sj = jadamw.adamw_init(jax.tree.map(jnp.asarray, _tree(0)),
                           freeze_mask=MASK, policy=policy)
    assert set(st) == set(sj)
    for key in ("m", "v", "v_scale"):
        if key not in sj:
            continue
        for (pt, t), (_, j) in zip(_paths(st[key]), _paths(sj[key])):
            assert tuple(t.shape) == tuple(j.shape), (key, pt)
            assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name
            assert not t.any()
    # frozen leaves keep scalar zero moments under every policy
    assert st["m"]["frozen"].shape == () and st["v"]["frozen"].shape == ()
    assert st["step"] == 0


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _run_both(policy, steps=STEPS):
    """``steps`` AdamW steps in both packages on the same gradients
    (large enough that the clip at 1.0 acts), weight decay 0.01."""
    pj = jax.tree.map(jnp.asarray, _tree(0))
    pt = _to_torch(_tree(0))
    sj = jadamw.adamw_init(pj, freeze_mask=MASK, policy=policy)
    st = adamw.adamw_init(pt, freeze_mask=MASK, policy=policy)
    norms, rounded_apart = [], {}
    for s in range(steps):
        g = _tree(100 + s)
        g["a"]["w"] *= 10.0 ** (s - 3)       # gradients over decades
        pj, sj, statj = jadamw.adamw_update(
            jax.tree.map(jnp.asarray, g), sj, pj, lr=1e-2,
            weight_decay=0.01, freeze_mask=MASK)
        pt, st, statt = adamw.adamw_update(
            _to_torch(g), st, pt, lr=1e-2, weight_decay=0.01,
            freeze_mask=MASK)
        norms.append((statt["grad_norm"].item(), float(statj["grad_norm"])))
        # entries whose stored bf16 moment rounded apart at some step
        for key in ("m", "v"):
            for (p, t), (_, j) in zip(_paths(st[key]), _paths(sj[key])):
                if t.dtype == torch.bfloat16:
                    off = t.float().numpy() != np.asarray(j, np.float32)
                    rounded_apart[p] = rounded_apart.get(p, False) | off
    return pt, st, pj, sj, norms, rounded_apart


def _param_err(pt, pj):
    return max(float(np.max(np.abs(t.numpy() - np.asarray(j))))
               for (_, t), (_, j) in zip(_paths(pt), _paths(pj)))


def _rarely_off(got, want, what):
    """Stored moments equal except at most 1 in 1,000 entries."""
    off = got != want
    assert off.sum() <= CODE_OFF_FRACTION["update"] * got.size, \
        (what, int(off.sum()), got.size)
    return off


@pytest.mark.parametrize("policy", POLICIES)
def test_adamw_update_matches_reference(policy):
    pt, st, pj, sj, norms, rounded_apart = _run_both(policy)
    for t, j in norms:
        np.testing.assert_allclose(t, j, rtol=1e-6)
    assert st["step"] == int(sj["step"]) == STEPS
    np.testing.assert_array_equal(pt["frozen"].numpy(), _tree(0)["frozen"])
    for p, off in rounded_apart.items():
        assert off.sum() <= CODE_OFF_FRACTION["bf16"] * off.size, p
    for key in ("m", "v"):
        for (p, t), (_, j) in zip(_paths(st[key]), _paths(sj[key])):
            if policy == "int8" and key == "v":
                _codes_close(t.numpy(), j, CODE_OFF_FRACTION["update"])
            elif t.dtype == torch.bfloat16:
                got, want = t.float().numpy(), np.asarray(j, np.float32)
                off = _rarely_off(got, want, (key, p))
                np.testing.assert_allclose(got[off], want[off], rtol=2 ** -7)
            else:
                j = np.asarray(j)
                np.testing.assert_allclose(
                    t.numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max(),
                    err_msg=f"{key}{p}")
    if policy == "int8":
        for (p, s), (_, sjl) in zip(_paths(st["v_scale"]),
                                    _paths(sj["v_scale"])):
            np.testing.assert_allclose(s.item(), float(sjl), rtol=1e-6,
                                       err_msg=p)
        assert st["v_scale"]["frozen"].item() == 0.0
    for (p, t), (_, j) in zip(_paths(pt), _paths(pj)):
        err = np.abs(t.numpy() - np.asarray(j))
        off = rounded_apart.get(p, np.zeros(err.shape, bool))
        assert err[~off].max(initial=0) <= PARAM_ATOL, (p, err.max())
        assert err[off].max(initial=0) <= 1e-2 * 2 ** -7, (p, err.max())
    print(policy, "param max abs err", _param_err(pt, pj))


def test_linear_v_codebook_breaks_the_update_limit(monkeypatch):
    """A planted fault: int8 v on linear levels (v / amax * 127)."""
    def q_lin(v, group=None):
        scale = torch.clamp_min(v.max(), 1e-12)
        return torch.round(v / scale * 127.0).to(torch.int8), scale

    def dq_lin(q, scale):
        return q.float() * scale / 127.0

    monkeypatch.setattr(quant, "quantize_v", q_lin)
    monkeypatch.setattr(quant, "dequantize_v", dq_lin)
    pt, _, pj, _, _, _ = _run_both("int8")
    print("linear codebook param err", _param_err(pt, pj))
    assert _param_err(pt, pj) > 10 * PARAM_ATOL


@pytest.mark.parametrize("policy,atol", [("bf16", 2e-2), ("int8", 5e-2)])
def test_moment_policies_track_fp32_on_the_port(policy, atol):
    """The reference's tracking property, on the port's ``train_device``
    (its ``quant-tiny`` config, 8 steps of 4 x 16)."""
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated.device import DeviceSpec, train_device
    from test_quantized import CFG, V
    corpus = FederatedCorpus.build(seed=0, n_devices=3, n_domains=2, vocab=V)
    spec = DeviceSpec(0, port_cfg(CFG), 0, 0)
    kw = dict(steps=8, batch=4, seq_len=16, seed=0, device="cpu")
    ref = np.asarray(train_device(spec, corpus, **kw)["losses"])
    got = np.asarray(train_device(spec, corpus, state_policy=policy,
                                  **kw)["losses"])
    print(policy, "max |loss - fp32 loss|", np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, atol=atol)
    assert not np.array_equal(got, ref)


def test_distill_proxy_int8_moments_match_reference():
    """Phase II with int8 moments: ``test_torch_distill``'s setup (gpt2-
    tiny teacher, port-drawn inits crossed to JAX), 3 steps, both
    servers at ``state_policy="int8"``."""
    from repro.core import merge as jmerge
    from repro.data.federated import FederatedCorpus as JCorpus
    from repro.federated import server as jserver
    from repro_torch import convert
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import server
    from benchmarks.common import global_moe_cfg
    from test_torch_distill import _params, _server_kw
    from test_torch_simulation import fast_reference_compiles
    from test_torch_train import device_families
    from repro.core import vaa as jvaa

    fam_j = device_families()
    fam = [port_cfg(c) for c in fam_j]
    kw = dict(distill_steps=3, state_policy="int8")
    base_j = jmerge.base_config_of(global_moe_cfg())
    base = port_cfg(base_j).replace(use_kernels=False)
    tpt, tpj = _params(fam_j[0], 40)
    s_init, s_init_j = _params(base_j, 50)
    with fast_reference_compiles():
        jc = JCorpus.build(seed=0, n_devices=4, n_domains=4,
                           vocab=fam[0].vocab_size)
        jsrv = jserver.DeepFusionServer(
            jserver.ServerConfig(**_server_kw(lambda c: c, **kw)), jc, fam_j)
        _, want = jsrv.distill_proxy(
            {"params": tpj, "arch": 0, "cluster": 0, "members": [0]},
            base_j, init_params=s_init_j, seed_offset=0)
    scfg = jsrv.cfg
    v_init = jvaa.init_vaa(
        jax.random.PRNGKey(scfg.seed + 202), n_stages=scfg.n_stages,
        d_student=base_j.d_model, d_teacher=fam_j[0].d_model,
        d=scfg.vaa_dim, n_heads=scfg.vaa_heads, p_q=scfg.p_q)
    tc = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                               vocab=fam[0].vocab_size)
    srv = server.DeepFusionServer(
        server.ServerConfig(**_server_kw(port_cfg, **kw)), tc, fam,
        device="cpu")
    _, got = srv.distill_proxy(
        {"params": tpt, "arch": 0, "cluster": 0, "members": [0]}, base,
        init_params=s_init,
        vaa_params=convert.vaa_from_jax(jax.tree.map(np.asarray, v_init)),
        seed_offset=0)
    print("int8 distill history rel err",
          np.max(np.abs(np.subtract(got, want)) / np.abs(want)))
    np.testing.assert_allclose(got, want, rtol=2e-5)
