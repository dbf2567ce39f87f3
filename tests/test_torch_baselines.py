"""The paper's federated-KD baselines in the port
(``core/baselines/{fedkmt,ofa_kd}.py``) against the JAX reference, on
the CPU; ``run_methods`` also serves
``test_torch_baselines_rounds.py`` (centralized, FedAvg, FedJETS).

Each baseline runs in both packages at cut counts on the
``benchmarks/common.py`` configs, f32, N 2 (one device of each family):
FedKMT and OFA-KD on one shared fleet's uploads (trained by the port for
3 steps, converted for the reference) with 3 distill and 3 tune steps.
Inits cross through ``test_torch_simulation.InitBridge`` (OFA-KD's exit
heads too), which asserts each draw site's seed; the reference compiles
with XLA's optimizations off, as there.  The MoE runs dropless
(``use_pallas=False`` / ``use_kernels=False``).

Limits (readings on this CPU in brackets): loss histories 2e-6 relative
[worst 5.1e-7], ``log_ppl`` and per-domain log-ppl 1e-6 relative
[8.6e-8], accuracies 1e-6 absolute [equal]; ``comm_bytes`` and cluster
sizes exactly; ``ofa_loss`` and its metrics 1e-5 relative [worst 3.6e-6,
the KL term], every gradient 1e-5 absolute + 1e-4 relative [largest
difference 4.8e-7].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core.baselines import fedjets as jfedjets
from repro.core.baselines import ofa_kd as jofa
from repro.core import distill as jdistill
from repro.core import merge as jmerge
from repro.data.federated import FederatedCorpus as JCorpus
from repro.federated import device as jdev
from repro_torch import convert
from repro_torch.core import baselines, distill
from repro_torch.core.baselines import fedjets, ofa_kd
from repro_torch.federated import simulation
from repro_torch.models import model as M
from repro_torch.utils.pytree import tree_leaves, tree_paths

from test_torch_simulation import (InitBridge, _configs, _port_sim,
                                   fast_reference_compiles)
from test_torch_train import device_families, port_cfg  # repo root on sys.path

HIST_RTOL = 2e-6
LOGPPL_RTOL = 1e-6
ACC_ATOL = 1e-6
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
LOSS_RTOL = 1e-5
N, STEPS, ROUNDS, LOCAL = 2, 3, 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(pt, cfg):
    return jax.tree.map(jnp.asarray, convert.params_to_jax(pt, cfg))


def _configs_n(port: bool):
    sim, scfg, fam = _configs(port)
    sim = dataclasses.replace(sim, n_devices=N)
    return (_port_sim(sim) if port else sim), scfg, fam


def _methods(sim, scfg, fam, moe, corpus, uploads, *, ref: bool):
    """(name, thunk) of every baseline at the cut counts."""
    b = jbase if ref else baselines
    kw = dict(corpus=corpus, log=lambda s: None)
    if not ref:
        kw["device"] = "cpu"
    return {
        "fedkmt": lambda: b.run_fedkmt(sim, scfg, fam, uploads=uploads, **kw),
        "ofa_kd": lambda: b.run_ofa_kd(sim, scfg, fam, uploads=uploads, **kw),
        "centralized": lambda: b.run_centralized(sim, moe, steps=STEPS,
                                                 batch=8, **kw),
        "fedavg": lambda: b.run_fedavg(sim, fam[0], rounds=ROUNDS,
                                       local_steps=LOCAL, batch=8, **kw),
        "fedjets": lambda: b.run_fedjets(sim, moe, rounds=ROUNDS,
                                         local_steps=LOCAL, batch=8, **kw),
    }


def run_methods(names, *, with_fleet: bool):
    """The named baselines in both packages (the fleet's uploads, when
    asked, trained by the port and shared).  Returns {"ref", "port":
    {name: report}, "hits": {name: the port's init draws}, "experts":
    {"ref", "port": the expert ids FedJETS sliced, in call order}, ...}."""
    sim_j, scfg_j, fam_j = _configs_n(port=False)
    sim, scfg, fam = _configs_n(port=True)
    out = {"ref": {}, "port": {}, "hits": {}}
    out["experts"] = {"ref": [], "port": []}
    with fast_reference_compiles(), pytest.MonkeyPatch.context() as mp:
        bridge = InitBridge(mp, extra=[(ofa_kd, "init_ofa_heads",
                                        jofa.init_ofa_heads)])
        for side, module in (("ref", jfedjets), ("port", fedjets)):
            def slicing(params, ids, _own=module._slice_experts,
                        _seen=out["experts"][side]):
                _seen.append(list(ids))
                return _own(params, ids)
            mp.setattr(module, "_slice_experts", slicing)
        corpus = simulation.build_corpus(sim)
        jc = JCorpus.build(seed=sim.seed, n_devices=N,
                           n_domains=sim.n_domains, vocab=sim.vocab,
                           alpha=sim.alpha_noniid)
        uploads = ups_j = None
        if with_fleet:
            fleet = simulation.build_fleet(sim, corpus, fam)
            uploads = simulation.train_fleet(
                fleet, corpus, steps=STEPS, batch=8, seq_len=sim.seq_len,
                seed=sim.seed, device="cpu")
            out["fleet_hits"] = bridge.take()
            ups_j = [dict(u, params=_to_jax(u["params"], fam[u["arch_id"]]),
                          upload_bytes=jdev.device_upload_bytes(
                              fam_j[u["arch_id"]])) for u in uploads]
        ref = _methods(sim_j, scfg_j, fam_j, scfg_j.moe_cfg, jc, ups_j,
                       ref=True)
        port = _methods(sim, scfg, fam, scfg.moe_cfg, corpus, uploads,
                        ref=False)
        for name in names:
            _, out["ref"][name] = ref[name]()
            _, out["port"][name] = port[name]()
            out["hits"][name] = bridge.take()
    out["uploads"] = uploads
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def assert_matches_reference(runs, name):
    """Metrics, loss histories, comm bytes and the bookkeeping keys of
    one method's report against the reference's."""
    got, want = runs["port"][name], runs["ref"][name]
    m, mr = got["metrics"], want["metrics"]
    assert set(m) == set(mr)
    d = {"log_ppl": max(_rel(m[k], mr[k]) for k in mr
                        if k.startswith(("log_ppl", "logppl_"))),
         "accuracy": max(abs(m[k] - mr[k]) for k in mr
                         if k.startswith("acc"))}
    for key in ("distill_hists", "tune_hist", "history"):
        if key in want:
            hs = want[key] if key == "distill_hists" else [want[key]]
            gs = got[key] if key == "distill_hists" else [got[key]]
            assert len(gs) == len(hs)
            d[key] = max(_rel(g, h) for g, h in zip(gs, hs))
    print(name, d)
    for k, v in d.items():
        lim = {"log_ppl": LOGPPL_RTOL, "accuracy": ACC_ATOL}.get(k, HIST_RTOL)
        assert v <= lim, (name, k, v, lim)
    assert got["comm_bytes"] == want["comm_bytes"]
    for k in ("cluster_sizes", "local_model_bytes"):
        assert got.get(k) == want.get(k)


@pytest.fixture(scope="module")
def runs():
    return run_methods(["fedkmt", "ofa_kd"], with_fleet=True)


@pytest.mark.parametrize("name", ["fedkmt", "ofa_kd"])
def test_baseline_matches_reference(runs, name):
    assert_matches_reference(runs, name)


def test_comm_bytes_are_the_uploads(runs):
    total = sum(u["upload_bytes"] for u in runs["uploads"])
    for name in ("fedkmt", "ofa_kd"):
        assert runs["port"][name]["comm_bytes"] == total


def test_every_init_draw_crossed_the_bridge(runs):
    """Devices ``seed * 100003 + id``; per proxy i a student and its VAA
    (``+101 + i``, ``+202 + i``) or OFA-KD's student and exit heads
    (``+404 + i``, ``+505 + i``); the MoE ``+303``."""
    assert sorted(runs["fleet_hits"]) == [("params", i) for i in range(N)]
    n = runs["port"]["fedkmt"]["n_clusters"]
    assert n == N == len({u["arch_id"] for u in runs["uploads"]})

    def per_proxy(a, b, tag):
        return [h for i in range(n) for h in (("params", a + i),
                                              (tag, b + i))]

    assert runs["hits"] == {
        "fedkmt": per_proxy(101, 202, "vaa") + [("params", 303)],
        "ofa_kd": per_proxy(404, 505, "init_ofa_heads") + [("params", 303)]}


def test_ofa_loss_and_every_gradient_match_jax_grad():
    """``ofa_loss`` and the gradient of every student and exit-head leaf,
    against ``jax.grad`` of the reference's, on one batch: the dense base
    of ``qwen-moe-tiny`` as the student, ``llama-tiny`` as the teacher."""
    _, scfg, _ = _configs(port=True)
    s_cfg_j = jmerge.base_config_of(_configs(port=False)[1].moe_cfg)
    t_cfg_j = device_families()[1]
    s_cfg, t_cfg = port_cfg(s_cfg_j), port_cfg(t_cfg_j)
    g = torch.Generator().manual_seed(9)
    trainable = {"student": M.init_params(s_cfg, generator=g),
                 "ofa": ofa_kd.init_ofa_heads(g, n_stages=2,
                                              d_student=s_cfg.d_model,
                                              vocab=s_cfg.vocab_size)}
    t_params = M.init_params(t_cfg, generator=g)
    toks = np.random.default_rng(4).integers(0, s_cfg.vocab_size, (2, 21))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
             "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}
    kw = dict(beta=1.0, temperature=2.0, n_stages=2)
    t_out = distill.teacher_forward(t_params, t_cfg, batch, n_stages=2)
    leaves = [p.requires_grad_(True) for p in tree_leaves(trainable)]
    loss, metrics = ofa_kd.ofa_loss(trainable, s_cfg, t_params, t_cfg, batch,
                                    t_out, **kw)
    grads = torch.autograd.grad(loss, leaves)

    tj = {"student": _to_jax(trainable["student"], s_cfg),
          "ofa": {k: jnp.asarray(v.detach().numpy())
                  for k, v in trainable["ofa"].items()}}
    tpj = _to_jax(t_params, t_cfg)
    bj = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    @jax.jit
    def ref(tj, tpj, bj):
        t_out_j = jdistill.teacher_forward(tpj, t_cfg_j, bj, n_stages=2)
        return jax.value_and_grad(jofa.ofa_loss, has_aux=True)(
            tj, s_cfg_j, tpj, t_cfg_j, bj, t_out_j, **kw)

    with fast_reference_compiles():
        (lj, mj), gj = ref(tj, tpj, bj)
    np.testing.assert_allclose(loss.item(), float(lj), rtol=LOSS_RTOL)
    for k in mj:
        np.testing.assert_allclose(metrics[k].item(), float(mj[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert len(grads) == len(jax.tree.leaves(gj))
    for (p, _), a, b in zip(tree_paths(trainable), grads,
                            jax.tree.leaves(gj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=p)


def test_baselines_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, scfg, fam = _configs_n(port=True)
    for call in (lambda: baselines.run_centralized(sim, scfg.moe_cfg),
                 lambda: baselines.run_fedavg(sim, fam[0]),
                 lambda: baselines.run_fedjets(sim, scfg.moe_cfg),
                 lambda: baselines.run_fedkmt(sim, scfg, fam)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    corpus = simulation.build_corpus(sim)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        baselines.run_ofa_kd(sim, scfg, fam, uploads=[], corpus=corpus)
