"""Phase II of the port (backbone stages, chunked CE + KL, the Eq. 11
objective, ``distill_proxy``) and the server's whole pipeline against the
JAX reference, on the CPU.

The reference runs ``use_pallas=False``, and its Pallas kd_loss kernel in
interpret mode where a test holds the port's kernel path.  The port runs
its plain path (``use_kernels=False``) and its kernel path on CPU tensors
(the kernels' plain versions and the kd_loss blocked backward).  Same
weights (JAX inits converted with ``convert``), same numpy batches, f32,
on the ``benchmarks/common.py`` configs: the dense base of
``qwen-moe-tiny`` as the student, ``gpt2-tiny`` and ``llama-tiny`` as
teachers.

Tolerances: values, metrics and loss histories 1e-4 relative (a few
steps of AdamW on f32 sums in other orders); gradients and hidden states
1e-5 absolute + 1e-4 relative; clustering, histories of two runs of the
port and ``comm_bytes`` exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import distill as jdistill
from repro.core import merge as jmerge
from repro.core import vaa as jvaa
from repro.data.federated import FederatedCorpus as JCorpus
from repro.federated import device as jdev
from repro.federated import server as jserver
from repro.models import model as JM
from repro_torch import convert
from repro_torch.core import distill, merge
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated import device as tdev
from repro_torch.federated import server
from repro_torch.kernels.kd_loss import ops as kd_ops
from repro_torch.models import model as M
from repro_torch.utils.pytree import tree_leaves, tree_map

from test_torch_train import device_families, port_cfg  # repo root on sys.path
from benchmarks.common import global_moe_cfg, server_cfg  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-4)
RTOL = 1e-4
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these small tensors gain nothing from more,
    and more oversubscribe a CPU that the suite's other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_jax(pt, cfg):
    return jax.tree.map(jnp.asarray, convert.params_to_jax(pt, cfg))


def _to_port(pj, cfg):
    return convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)


def _np(t):
    return t.detach().numpy()


def _params(cfg_j, seed):
    """Port parameters drawn for ``cfg_j`` and their JAX copy (drawing in
    the port costs no JAX compilation)."""
    cfg = port_cfg(cfg_j)
    pt = M.init_params(cfg, generator=torch.Generator().manual_seed(seed))
    return pt, _to_jax(pt, cfg)


# ---------------------------------------------------------------------------
# stage selection and the backbone's stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nG", range(1, 9))
def test_select_stages_indices_match_reference(nG):
    """The same evenly spaced groups for J = 1..6, the last repeated when
    there are fewer groups than stages."""
    for J in range(1, 7):
        got = distill.select_stages(torch.arange(nG), J)
        want = jdistill.select_stages(jnp.arange(nG), J)
        assert [int(g) for g in got] == [int(w) for w in want], (nG, J)
        assert len(got) == J


def _backbone_cfgs():
    fam = device_families()
    return {"gpt2-tiny": fam[0], "llama-tiny": fam[1],
            "qwen-moe-tiny": global_moe_cfg(),
            "mamba2-1.3b-reduced": jax_config("mamba2-1.3b",
                                              variant="reduced")}


@pytest.mark.parametrize("arch", list(_backbone_cfgs()))
def test_backbone_stages_match_reference(arch):
    cfg_j = _backbone_cfgs()[arch]
    cfg = port_cfg(cfg_j)
    pt, pj = _params(cfg_j, 1)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    hj, auxj, _, sj = JM.backbone(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                                  collect_stages=True)
    ht, auxt, caches, st = M.backbone(pt, cfg, {"tokens": torch.as_tensor(
        toks)}, collect_stages=True)
    n_groups = cfg.n_layers // cfg.layers_per_scan
    assert st.shape == (n_groups, 2, 20, cfg.d_model) == sj.shape
    assert caches == {}
    np.testing.assert_allclose(_np(st), np.asarray(sj), **TOL)
    np.testing.assert_allclose(_np(ht), np.asarray(hj), **TOL)
    np.testing.assert_allclose(auxt.item(), float(auxj), **TOL)
    # the last stage is the last group's output, before the final norm
    assert not torch.equal(st[-1], ht)
    h2, _, _, none = M.backbone(pt, cfg, {"tokens": torch.as_tensor(toks)})
    assert none is None and torch.equal(h2, ht)


# ---------------------------------------------------------------------------
# chunked CE + KL
# ---------------------------------------------------------------------------

def _pair(student_kw=None):
    """The student (dense base of qwen-moe-tiny) and the llama-tiny
    teacher: JAX configs and params, port configs and params."""
    s_cfg_j = jmerge.base_config_of(global_moe_cfg())
    if student_kw:
        s_cfg_j = s_cfg_j.replace(**student_kw)
    t_cfg_j = device_families()[1]
    spt, spj = _params(s_cfg_j, 3)
    tpt, tpj = _params(t_cfg_j, 4)
    return (s_cfg_j, t_cfg_j, spj, tpj,
            port_cfg(s_cfg_j), port_cfg(t_cfg_j), spt, tpt)


# (use_kernels, tau, remat); S 45 against loss_chunk 32 leaves a ragged
# tail, and the mask drops a few positions
CE_KL_CASES = [(False, 1.0, False), (False, 2.0, True), (True, 1.0, True),
               (True, 2.0, False)]


@pytest.mark.parametrize("use_kernels,tau,remat", CE_KL_CASES,
                         ids=[f"{'kernel' if k else 'plain'}-tau{t}"
                              f"{'-remat' if r else ''}"
                              for k, t, r in CE_KL_CASES])
def test_chunked_ce_kl_matches_reference(use_kernels, tau, remat):
    (s_cfg_j, t_cfg_j, spj, tpj,
     s_cfg, t_cfg, spt, tpt) = _pair(dict(remat=remat))
    rng = np.random.default_rng(5)
    B, S = 2, 45
    hs = rng.standard_normal((B, S, s_cfg.d_model)).astype(np.float32)
    ht = rng.standard_normal((B, S, t_cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, s_cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    wts = np.array([1.0, 0.7, 0.0, 0.0], np.float32)
    hk = "embed" if s_cfg.tie_embeddings else "lm_head"

    def jf(h, head):
        p = dict(spj, **{hk: head})
        out = jdistill.chunked_ce_kl(
            p, s_cfg_j, h, tpj, t_cfg_j, jnp.asarray(ht),
            jnp.asarray(labels), jnp.asarray(mask), temperature=tau,
            use_pallas=use_kernels)
        return sum(w * o for w, o in zip(wts, out)), out

    (_, outj), gj = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hs), spj[hk])
    h = torch.as_tensor(hs).requires_grad_(True)
    head = spt[hk].requires_grad_(True)
    n0 = kd_ops.LAUNCHES
    out = distill.chunked_ce_kl(
        spt, s_cfg, h, tpt, t_cfg, torch.as_tensor(ht),
        torch.as_tensor(labels), torch.as_tensor(mask), temperature=tau,
        use_kernels=use_kernels)
    gt = torch.autograd.grad(sum(float(w) * o for w, o in zip(wts, out)),
                             [h, head])
    assert kd_ops.LAUNCHES == n0   # CPU tensors launch nothing
    for name, a, b in zip(("ce", "kl", "tok", "correct"), out, outj):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert out[2].item() == mask.sum() and out[1].item() > 0
    for name, a, b in zip(("h_s", hk), gt, gj):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                   **TOL)


# ---------------------------------------------------------------------------
# the Eq. 11 objective
# ---------------------------------------------------------------------------

J_STAGES, P_Q, VAA_D, VAA_HEADS = 2, 32, 64, 4


KW = dict(alpha=0.5, beta=1.5, temperature=2.0, n_stages=J_STAGES,
          vaa_heads=VAA_HEADS, p_q=P_Q)


@pytest.fixture(scope="module")
def eq11():
    """The reference's Eq. 11 loss, metrics and gradients (plain path) on
    one batch, from the teacher's outputs, and the inputs in numpy."""
    s_cfg_j, t_cfg_j, spj, tpj, s_cfg, t_cfg, _, _ = _pair()
    vj = jvaa.init_vaa(jax.random.PRNGKey(6), n_stages=J_STAGES,
                       d_student=s_cfg.d_model, d_teacher=t_cfg.d_model,
                       d=VAA_D, n_heads=VAA_HEADS, p_q=P_Q)
    corpus = JCorpus.build(seed=0, n_devices=2, n_domains=2,
                           vocab=s_cfg.vocab_size)
    bnp = {k: np.asarray(v) for k, v in corpus.mixed_eval_batch(
        2, 40).items()}
    bj = {k: jnp.asarray(v) for k, v in bnp.items()}
    toj = jdistill.teacher_forward(tpj, t_cfg_j, bj, n_stages=J_STAGES)
    (lj, mj), gj = jax.jit(
        jax.value_and_grad(jdistill.distill_loss, has_aux=True),
        static_argnums=(1, 3), static_argnames=tuple(KW))(
            {"student": spj, "vaa": vj}, s_cfg_j, tpj, t_cfg_j, bj, toj,
            **KW)
    return dict(vaa=jax.tree.map(np.asarray, vj), batch=bnp,
                stages=[np.asarray(s) for s in toj["stages"]],
                loss=float(lj), metrics={k: float(v) for k, v in mj.items()},
                grads=convert.flatten(jax.tree.map(np.asarray, gj)))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
def test_distill_loss_metrics_and_every_gradient_match_reference(
        eq11, use_kernels):
    """Both port paths against the reference's plain path (the kernel
    path's chunks are held to the interpreted Pallas kernel above)."""
    _, _, _, _, s_cfg, t_cfg, spt, tpt = _pair()
    s_cfg = s_cfg.replace(use_kernels=use_kernels)
    vt = convert.vaa_from_jax(eq11["vaa"])
    bt = {k: torch.tensor(v) for k, v in eq11["batch"].items()}
    tot = distill.teacher_forward(tpt, t_cfg, bt, n_stages=J_STAGES)
    assert not tot["h"].requires_grad
    for a, b in zip(tot["stages"], eq11["stages"]):
        np.testing.assert_allclose(_np(a), b, **TOL)
    trainable = {"student": spt, "vaa": vt}
    leaves = [p.requires_grad_(True) for p in tree_leaves(trainable)]
    lt, mt = distill.distill_loss(trainable, s_cfg, tpt, t_cfg, bt, tot,
                                  **KW)
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(lt.item(), eq11["loss"], rtol=1e-5)
    assert set(mt) == set(eq11["metrics"])
    for k, v in eq11["metrics"].items():
        np.testing.assert_allclose(mt[k].item(), v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert mt["kl"].item() > 0 and mt["fm"].item() > 0
    paths = sorted(convert.flatten(tree_map(lambda _: None, trainable)))
    assert len(paths) == len(gt) == len(eq11["grads"])
    for path, g in zip(paths, gt):
        np.testing.assert_allclose(_np(g), eq11["grads"][path],
                                   err_msg=path, **TOL)


# ---------------------------------------------------------------------------
# distill_proxy: whole Phase II epochs
# ---------------------------------------------------------------------------

def _server_kw(cfg_of, **over):
    scj = server_cfg()
    kw = {f.name: getattr(scj, f.name) for f in dataclasses.fields(scj)}
    kw.update(moe_cfg=cfg_of(scj.moe_cfg), distill_steps=STEPS)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def phase2():
    """The reference's Phase II for each teacher family (seed_offset =
    the family's index) on the JAX copies of a port-drawn teacher and
    student init, with its own VAA init (drawn again here to convert)."""
    fam_j = device_families()
    fam = [port_cfg(c) for c in fam_j]
    jc = JCorpus.build(seed=0, n_devices=4, n_domains=4,
                       vocab=fam[0].vocab_size)
    jsrv = jserver.DeepFusionServer(
        jserver.ServerConfig(**_server_kw(lambda c: c)), jc, fam_j)
    base_j = jmerge.base_config_of(global_moe_cfg())
    runs = []
    for a in (0, 1):
        tpt, tpj = _params(fam_j[a], 40 + a)
        s_init, s_init_j = _params(base_j, 50 + a)
        item_j = {"params": tpj, "arch": a, "cluster": a, "members": [a]}
        _, hist = jsrv.distill_proxy(item_j, base_j, init_params=s_init_j,
                                     seed_offset=a)
        scfg = jsrv.cfg
        v_init = jvaa.init_vaa(
            jax.random.PRNGKey(scfg.seed + 202 + a), n_stages=scfg.n_stages,
            d_student=base_j.d_model, d_teacher=fam_j[a].d_model,
            d=scfg.vaa_dim, n_heads=scfg.vaa_heads, p_q=scfg.p_q)
        runs.append({"teacher": tpt, "hist": hist, "s_init": s_init,
                     "v_init": jax.tree.map(np.asarray, v_init)})
    return fam, base_j, runs


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("arch", [0, 1], ids=["gpt2-tiny", "llama-tiny"])
def test_distill_proxy_matches_reference(phase2, arch, use_kernels):
    fam, base_j, runs = phase2
    run = runs[arch]
    base = port_cfg(base_j).replace(use_kernels=use_kernels)
    assert base == merge.base_config_of(port_cfg(global_moe_cfg())).replace(
        use_kernels=use_kernels)
    tc = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                               vocab=base.vocab_size)
    seen = []
    srv = server.DeepFusionServer(
        server.ServerConfig(**_server_kw(port_cfg)), tc, fam, device="cpu",
        on_step=lambda s, loss: seen.append(s))
    init = run["s_init"]
    init_copy = {k: v.clone() for k, v in convert.flatten(init).items()}
    vaa_init = convert.vaa_from_jax(run["v_init"])
    teacher_copy = [t.clone() for t in tree_leaves(run["teacher"])]
    item = {"params": run["teacher"], "arch": arch, "cluster": arch,
            "members": [arch]}
    student, hist = srv.distill_proxy(item, base, init_params=init,
                                      vaa_params=vaa_init, seed_offset=arch)
    assert seen == list(range(STEPS))
    np.testing.assert_allclose(hist, run["hist"], rtol=RTOL)
    # the caller's inits and the teacher are left as they were
    for k, v in convert.flatten(init).items():
        assert torch.equal(v, init_copy[k]), k
    assert torch.equal(vaa_init["wq"], torch.tensor(run["v_init"]["wq"]))
    for a, b in zip(tree_leaves(run["teacher"]), teacher_copy):
        assert torch.equal(a, b)
    # and the student moved
    assert not torch.equal(student["embed"], init["embed"])


def test_distill_proxy_default_inits_are_seeded():
    """Without inits, the student and VAA are drawn from ``seed + 101 +
    offset`` and ``seed + 202 + offset``: the same offset gives the same
    history, another offset another."""
    fam = [port_cfg(c) for c in device_families()]
    tc = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                               vocab=fam[0].vocab_size)
    srv = server.DeepFusionServer(
        server.ServerConfig(**_server_kw(port_cfg, distill_steps=2)), tc,
        fam, device="cpu")
    base = merge.base_config_of(srv.cfg.moe_cfg)
    item = {"params": M.init_params(fam[0], generator=torch.Generator()
                                    .manual_seed(0)),
            "arch": 0, "cluster": 0, "members": [0]}
    s0, h0 = srv.distill_proxy(item, base, seed_offset=0)
    s1, h1 = srv.distill_proxy(item, base, seed_offset=0)
    _, h2 = srv.distill_proxy(item, base, seed_offset=1)
    assert h0 == h1 and h0 != h2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s0),
                                                 tree_leaves(s1)))


# ---------------------------------------------------------------------------
# the whole pipeline
# ---------------------------------------------------------------------------

def _uploads(fam, corpus, n=4):
    ups = []
    for i in range(n):
        a = i % 2
        spec = tdev.DeviceSpec(i, fam[a], a, int(corpus.device_domain[i]))
        params = M.init_params(fam[a], generator=torch.Generator()
                               .manual_seed(60 + i))
        ups.append(tdev._upload(spec, corpus, params, torch.zeros(1)))
    return ups


def test_run_equals_its_phases_and_bills_the_reference_bytes():
    fam_j = device_families()
    fam = [port_cfg(c) for c in fam_j]
    kw = _server_kw(port_cfg, distill_steps=2, tune_steps=2)
    tc = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                               vocab=fam[0].vocab_size)
    ups = _uploads(fam, tc)
    logs = []
    srv = server.DeepFusionServer(server.ServerConfig(**kw), tc, fam,
                                  device="cpu", log=logs.append)
    moe_params, report = srv.run(ups)

    # the same phases by hand, on a fresh server
    man = server.DeepFusionServer(server.ServerConfig(**kw), tc, fam,
                                  device="cpu")
    proxies, result = man.cluster(ups)
    base = merge.base_config_of(man.cfg.moe_cfg)
    bases, hists = [], []
    for i, p in enumerate(proxies):
        s, h = man.distill_proxy(p, base, seed_offset=i)
        bases.append(s)
        hists.append(h)
    want_params, tune_hist = man.merge_and_tune(bases)
    assert report["distill_hists"] == hists
    assert report["tune_hist"] == tune_hist
    assert report["n_clusters"] == len(proxies) == len(hists)
    assert report["cluster_sizes"] == [len(p["members"]) for p in proxies]
    for a, b in zip(tree_leaves(moe_params), tree_leaves(want_params)):
        assert torch.equal(a, b)
    assert report["wall_s"] > 0 and len(logs) >= 2 + len(proxies)

    # Phase I and the billed bytes as the reference has them
    jc = JCorpus.build(seed=0, n_devices=4, n_domains=4,
                       vocab=fam[0].vocab_size)
    jsrv = jserver.DeepFusionServer(
        jserver.ServerConfig(**_server_kw(lambda c: c)), jc, fam_j)
    ups_j = [dict(u, params=_to_jax(u["params"], fam[u["arch_id"]]),
                  upload_bytes=jdev.device_upload_bytes(fam_j[u["arch_id"]]))
             for u in ups]
    proxies_j, result_j = jsrv.cluster(ups_j)
    np.testing.assert_array_equal(result.labels, result_j.labels)
    assert result.members == result_j.members
    assert report["n_clusters"] == jsrv.report["n_clusters"]
    assert report["cluster_sizes"] == jsrv.report["cluster_sizes"]
    assert report["comm_bytes"] == int(sum(u["upload_bytes"]
                                           for u in ups_j))
