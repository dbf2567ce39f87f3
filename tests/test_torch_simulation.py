"""The port's end-to-end pipeline (``federated/simulation.py``), its
checkpoint files and CLIs against the JAX reference, on the CPU.

``run_deepfusion`` runs in both packages from ``uploads=None`` (fleet
training, Phase I, II and III, evaluation) on the ``benchmarks/common.py``
configs at N 4, with the device, distill and tune step counts cut to 3,
f32.  The MoE is the reference's default dropless path
(``use_pallas=False``; ``use_kernels=False`` in the port), since the
reference's capacity path fails on the installed JAX.

**The init bridge.** The port draws its inits from ``torch.Generator``s
seeded with the reference's key integers, and those draws differ from
``jax.random``'s.  So ``InitBridge`` makes every seeded draw of the port
(``models.model.init_params``, ``core.vaa.init_vaa``) return the
reference's draw from ``PRNGKey(seed)``, converted, and counts the
draws: one a device, two a proxy (student and VAA), one for the MoE.  A
draw that bypassed it would leave the two runs on different weights and
fail the parity limits; a draw site that moved would fail the count.

**Compile time.** The reference compiles with XLA's optimizations off
(``jax_disable_most_optimizations``, restored and every JAX cache
cleared afterwards), which halves its compile time on one core.  The
limits below come from readings taken that way.

Limits (readings on this CPU in brackets): per-device loss histories
and Phase II/III histories 2e-6 relative [largest 2.6e-7, about three
f32 ulps]; ``log_ppl`` and per-domain log-ppl 1e-6 relative [5.7e-8];
accuracies 1e-6 absolute [equal]; the tuned MoE's weights 1e-5 absolute
+ 1e-4 relative; cluster sizes and ``comm_bytes`` exactly.  Planted
faults must break a limit tenfold: α = 0 (no feature matching) moves
the Phase II histories by 5.8e-3 relative (2,900 limits), and proxies 0
and 1 swapping their seed offsets by 2.2e-3 (1,100 limits).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import vaa as jvaa
from repro.federated import server as jserver
from repro.federated import simulation as jsim
from repro.models import model as JM
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch.core import vaa as vaa_mod
from repro_torch.federated import server, simulation
from repro_torch.models import model as M
from repro_torch.utils.pytree import tree_leaves, tree_paths

from test_torch_train import device_families, port_cfg  # repo root on sys.path
from benchmarks.common import global_moe_cfg, server_cfg, sim_cfg  # noqa: E402

HIST_RTOL = 2e-6
LOGPPL_RTOL = 1e-6
ACC_ATOL = 1e-6
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
N, STEPS = 4, 3


def jax_cfg(cfg):
    """The reference's ModelConfig of a port config."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["use_pallas"] = kw.pop("use_kernels")
    return JModelConfig(**kw)


class InitBridge:
    """While active, a seeded ``torch.Generator`` draw of the port's
    parameters returns the reference's draw from ``PRNGKey(seed)``,
    converted; ``hits`` lists (what, seed) per draw.  Other generators
    (``"meta"``) pass through.  ``extra`` lists further (module, name,
    reference function) triples whose seeded draws cross the same way
    (a dict of f32 leaves)."""

    def __init__(self, mp: pytest.MonkeyPatch, extra=()):
        self.hits = []
        own_init = M.init_params

        def init_params(cfg, *, generator):
            if not isinstance(generator, torch.Generator):
                return own_init(cfg, generator=generator)
            s = generator.initial_seed()
            self.hits.append(("params", s))
            pj = JM.init_params(jax.random.PRNGKey(s), jax_cfg(cfg))
            return convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg,
                                           device=generator.device)

        def init_vaa(generator, *, n_stages, d_student, d_teacher, d=256,
                     p_q=64, dtype=torch.float32):
            s = generator.initial_seed()
            self.hits.append(("vaa", s))
            vj = jvaa.init_vaa(jax.random.PRNGKey(s), n_stages=n_stages,
                               d_student=d_student, d_teacher=d_teacher, d=d,
                               p_q=p_q)
            return convert.vaa_from_jax(jax.tree.map(np.asarray, vj),
                                        device=generator.device)

        mp.setattr(M, "init_params", init_params)
        mp.setattr(vaa_mod, "init_vaa", init_vaa)
        for module, name, ref_fn in extra:
            def bridged(generator, _name=name, _ref=ref_fn, **kw):
                s = generator.initial_seed()
                self.hits.append((_name, s))
                out = _ref(jax.random.PRNGKey(s), **kw)
                return {k: torch.from_numpy(np.array(v)).to(generator.device)
                        for k, v in out.items()}
            mp.setattr(module, name, bridged)

    def take(self):
        hits, self.hits = self.hits, []
        return hits


def _drop_reference_executables():
    jsim._eval_batch_fn.cache_clear()
    jserver._distill_epoch_fn.cache_clear()
    jserver._TUNE_EPOCH_CACHE.clear()
    jax.clear_caches()


@contextlib.contextmanager
def fast_reference_compiles():
    """XLA optimizations off for the reference's compiles; restored on
    exit.  The reference's executables are dropped on entry and on exit:
    the flag is not part of a jitted function's cache key, so what an
    earlier test in the process compiled with the optimizations on would
    otherwise run inside (``tests/test_system.py`` run first in the same
    process moved FedJETS' log-ppl by 9.6e-6 relative, past its 1e-6),
    and what ran inside would outlive it."""
    _drop_reference_executables()
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        _drop_reference_executables()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(port: bool):
    conv = port_cfg if port else (lambda c: c)
    sim = dataclasses.replace(sim_cfg(N), device_steps=STEPS)
    sc = server_cfg()
    kw = {f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)}
    kw.update(moe_cfg=conv(sc.moe_cfg), distill_steps=STEPS,
              tune_steps=STEPS)
    cls = server.ServerConfig if port else jserver.ServerConfig
    return sim, cls(**kw), [conv(c) for c in device_families()]


def _port_sim(sim):
    return simulation.SimulationConfig(**dataclasses.asdict(sim))


@pytest.fixture(scope="module")
def runs():
    """The reference's run and the port's, from ``uploads=None``; then
    the port's planted faults on the port's uploads."""
    sim_j, scfg_j, fam_j = _configs(port=False)
    sim, scfg, fam = _configs(port=True)
    with fast_reference_compiles(), pytest.MonkeyPatch.context() as mp:
        moe_j, rep_j = jsim.run_deepfusion(sim_j, scfg_j, fam_j,
                                           log=lambda s: None)
        out = {"ref": rep_j, "moe_ref": jax.tree.map(np.asarray, moe_j)}
        bridge = InitBridge(mp)
        moe, rep = simulation.run_deepfusion(_port_sim(sim), scfg, fam,
                                             device="cpu", log=lambda s: None)
        out.update(port=rep, moe_port=moe, hits=bridge.take())
        shared = dict(uploads=rep["uploads"], corpus=rep["corpus"],
                      device="cpu", log=lambda s: None)
        _, out["alpha0"] = simulation.run_deepfusion(
            _port_sim(sim), dataclasses.replace(scfg, alpha=0.0), fam,
            **shared)
        out["alpha0_hits"] = bridge.take()
        own = server.DeepFusionServer.distill_proxy

        def swapped(self, p, base, *, seed_offset=0, **kw):
            return own(self, p, base, seed_offset={0: 1, 1: 0}.get(
                seed_offset, seed_offset), **kw)

        mp.setattr(server.DeepFusionServer, "distill_proxy", swapped)
        _, out["swapped"] = simulation.run_deepfusion(_port_sim(sim), scfg,
                                                      fam, **shared)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _distances(rep, ref):
    """Each compared quantity's distance from the reference's."""
    m, mr = rep["metrics"], ref["metrics"]
    d = {"device_losses": max(_rel(u["losses"], v["losses"]) for u, v in
                              zip(rep["uploads"], ref["uploads"])),
         "distill_hists": max(_rel(h, g) for h, g in
                              zip(rep["distill_hists"],
                                  ref["distill_hists"])),
         "tune_hist": _rel(rep["tune_hist"], ref["tune_hist"]),
         "log_ppl": max(_rel(m[k], mr[k]) for k in mr
                        if k.startswith(("log_ppl", "logppl_"))),
         "accuracy": max(abs(m[k] - mr[k]) for k in mr
                         if k.startswith("acc"))}
    return d


LIMITS = {"device_losses": HIST_RTOL, "distill_hists": HIST_RTOL,
          "tune_hist": HIST_RTOL, "log_ppl": LOGPPL_RTOL,
          "accuracy": ACC_ATOL}


def test_run_deepfusion_matches_reference(runs):
    rep, ref = runs["port"], runs["ref"]
    d = _distances(rep, ref)
    print("run_deepfusion distances", d)
    for k, lim in LIMITS.items():
        assert d[k] <= lim, (k, d[k], lim)
    assert rep["cluster_sizes"] == ref["cluster_sizes"]
    assert rep["n_clusters"] == ref["n_clusters"]
    assert [u["arch_id"] for u in rep["uploads"]] == \
        [u["arch_id"] for u in ref["uploads"]]
    assert len({u["arch_id"] for u in rep["uploads"]}) == 2
    assert rep["comm_bytes"] == ref["comm_bytes"]
    assert set(rep["metrics"]) == set(ref["metrics"])
    # the tuned MoE's weights themselves
    got = convert.flatten(runs["moe_port"])
    for k, v in convert.flatten(runs["moe_ref"]).items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, **PARAM_TOL,
                                   err_msg=k)


def test_the_bridge_saw_every_draw(runs):
    """One draw a device (``seed * 100003 + id``), a student and a VAA
    module a proxy (``seed + 101 + i``, ``seed + 202 + i``), one MoE
    (``seed + 303``); the fault runs reuse the uploads."""
    n_prox = runs["port"]["n_clusters"]
    assert n_prox == 4
    want = [("params", i) for i in range(N)]
    for i in range(n_prox):
        want += [("params", 101 + i), ("vaa", 202 + i)]
    want.append(("params", 303))
    # devices train bucket by bucket (``train_fleet``), then the server
    assert sorted(runs["hits"][:N]) == want[:N]
    assert runs["hits"][N:] == want[N:]
    assert runs["alpha0_hits"] == want[N:]


@pytest.mark.parametrize("fault", ["alpha0", "swapped"])
def test_planted_faults_break_a_limit(runs, fault):
    d = _distances(runs[fault], runs["ref"])
    print(fault, d)
    assert max(d[k] / LIMITS[k] for k in LIMITS) > 10.0, d


def test_evaluate_model_matches_reference(runs):
    """``evaluate_model`` alone, on the reference's tuned MoE converted."""
    _, scfg_j, _ = _configs(port=False)
    _, scfg, _ = _configs(port=True)
    params = convert.params_from_jax(runs["moe_ref"], scfg.moe_cfg)
    corpus = runs["port"]["corpus"]
    got = simulation.evaluate_model(params, scfg.moe_cfg, corpus,
                                    seq_len=16, batch=2, n_batches=2)
    with fast_reference_compiles():
        want = jsim.evaluate_model(
            jax.tree.map(jnp.asarray, runs["moe_ref"]), scfg_j.moe_cfg,
            runs["ref"]["corpus"], seq_len=16, batch=2, n_batches=2)
    assert set(got) == set(want)
    for k in want:
        tol = ACC_ATOL if k.startswith("acc") else LOGPPL_RTOL * want[k]
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_build_fleet_matches_reference_and_its_errors():
    sim, _, fam = _configs(port=True)
    sim_j, _, fam_j = _configs(port=False)
    sim = dataclasses.replace(_port_sim(sim), n_devices=9, seed=3)
    sim_j = dataclasses.replace(sim_j, n_devices=9, seed=3)
    corpus = simulation.build_corpus(sim)
    jcorpus = jsim.FederatedCorpus.build(
        seed=3, n_devices=9, n_domains=sim.n_domains, vocab=sim.vocab,
        alpha=sim.alpha_noniid)
    full = [port_cfg(c).replace(n_layers=6) for c in device_families()]
    got = simulation.build_fleet(sim, corpus, fam, full_cfgs=full)
    want = jsim.build_fleet(sim_j, jcorpus, fam_j,
                            full_cfgs=[jax_cfg(c) for c in full])
    assert [(s.device_id, s.arch_id, s.domain_id, s.cfg.name,
             s.comm_cfg.n_layers) for s in got] == \
        [(s.device_id, s.arch_id, s.domain_id, s.cfg.name,
          s.comm_cfg.n_layers) for s in want]
    for bad in (full[:1], full + full[:1]):
        with pytest.raises(ValueError) as e_port:
            simulation.build_fleet(sim, corpus, fam, full_cfgs=bad)
        with pytest.raises(ValueError) as e_ref:
            jsim.build_fleet(sim_j, jcorpus, fam_j,
                             full_cfgs=[jax_cfg(c) for c in bad])
        assert str(e_port.value) == str(e_ref.value)
    with pytest.raises(ValueError) as e_port:
        simulation.build_fleet(sim, corpus, fam, traffic="flaky")
    with pytest.raises(ValueError) as e_ref:
        jsim.build_fleet(sim_j, jcorpus, fam_j, traffic="flaky")
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("what", ["traffic", "n_hosts", "schedule"])
def test_unported_options_refused_before_training(what, monkeypatch):
    """More hosts than ranks (here one, no process group) is the
    reference's oversubscription error (multi-host fleets are ported:
    tests/test_torch_fleet_hosts.py); a bad straggler profile or schedule
    is refused as the reference refuses it.  All three before any
    training."""
    sim, scfg, fam = _configs(port=True)

    def no_training(*a, **k):
        raise AssertionError("trained before refusing")

    monkeypatch.setattr(simulation, "train_fleet", no_training)
    monkeypatch.setattr(simulation, "train_fleet_async", no_training)
    kw = {"traffic": dict(traffic="flaky"), "n_hosts": dict(n_hosts=2),
          "schedule": {}}[what]
    if what == "schedule":
        scfg = dataclasses.replace(scfg, schedule=server.AsyncFleetConfig(
            deadline_policy="wait-forever"))
    err, match = ValueError, {"traffic": "straggler profile",
                              "n_hosts": "fleet mesh wants 2 hosts",
                              "schedule": "deadline_policy"}[what]
    with pytest.raises(err, match=match):
        simulation.run_deepfusion(_port_sim(sim), scfg, fam, device="cpu",
                                  **kw)


def _mixed_tree():
    g = torch.Generator().manual_seed(5)
    return {"a": {"w": torch.randn(3, 4, generator=g),
                  "h": torch.randn(2, 5, generator=g).to(torch.bfloat16)},
            "b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "z": torch.randn(7, generator=g)}


def test_checkpoints_load_in_both_directions(tmp_path):
    tree = _mixed_tree()
    # the port's file, read by the reference
    ckpt.save_pytree(tree, str(tmp_path / "port"))
    data = np.load(tmp_path / "port.npz")
    assert sorted(data.files) == ["a|h#bf16", "a|w", "b", "z"]
    template = {"a": {"w": jnp.zeros((3, 4)),
                      "h": jnp.zeros((2, 5), jnp.bfloat16)},
                "b": jnp.zeros((2, 3), jnp.int32), "z": jnp.zeros(7)}
    back_j = jckpt.load_pytree(template, str(tmp_path / "port"))
    for (p, t), leaf in zip(tree_paths(tree), jax.tree.leaves(back_j)):
        assert leaf.dtype.name == str(t.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      t.float().numpy(), err_msg=p)
    # the reference's file, read by the port (a meta template)
    jtree = jax.tree.map(jnp.asarray, {
        "a": {"w": tree["a"]["w"].numpy(),
              "h": tree["a"]["h"].float().numpy().astype(jnp.bfloat16)},
        "b": tree["b"].numpy(), "z": tree["z"].numpy()})
    jckpt.save_pytree(jtree, str(tmp_path / "ref.npz"))
    meta = {"a": {k: v.to("meta") for k, v in tree["a"].items()},
            "b": tree["b"].to("meta"), "z": tree["z"].to("meta")}
    back = ckpt.load_pytree(meta, str(tmp_path / "ref.npz"))
    for p, t in convert.flatten(tree).items():
        got = convert.flatten(back)[p]
        assert got.dtype == t.dtype and got.device.type == "cpu"
        assert torch.equal(got, t), p
    with pytest.raises(KeyError, match="checkpoint missing a|x"):
        ckpt.load_pytree({"a": {"x": torch.zeros(1)}},
                         str(tmp_path / "ref.npz"))


def _jax_template(cfg):
    return jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jax_cfg(cfg)))


def _equal_to_file(params, cfg, path):
    back = jckpt.load_pytree(_jax_template(cfg), path)
    got = convert.flatten(params)
    for k, v in convert.flatten(jax.tree.map(np.asarray, back)).items():
        np.testing.assert_array_equal(
            v.astype(np.float32), got[k].detach().float().numpy(), err_msg=k)


def test_distill_run_cli_writes_a_file_the_reference_loads(tmp_path, capsys):
    from repro_torch.launch import distill_run
    path = str(tmp_path / "moe.npz")
    params, report = distill_run.main(
        ["--device", "cpu", "--devices", "2", "--steps", "2", "--seq", "16",
         "--save", path])
    out = capsys.readouterr().out
    m = report["metrics"]
    assert (f"deepfusion: log-ppl {m['log_ppl']:.4f} acc {m['accuracy']:.3f}"
            f" comm {report['comm_bytes']/1e6:.1f} MB") in out
    assert f"saved {path}" in out and np.isfinite(m["log_ppl"])
    cfg = port_cfg(global_moe_cfg()).replace(name="moe", use_kernels=True)
    _equal_to_file(params, cfg, path)


def test_train_cli_save_writes_a_file_the_reference_loads(tmp_path,
                                                          monkeypatch):
    from repro_torch.launch import train
    saved = {}
    own = train.save_pytree

    def keep(params, path):
        saved["params"] = params
        own(params, path)

    monkeypatch.setattr(train, "save_pytree", keep)
    path = str(tmp_path / "tiny")
    train.main(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps",
                "2", "--batch", "2", "--seq", "16", "--save", path])
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b", variant="reduced").replace(
        vocab_size=512)
    _equal_to_file(saved["params"], cfg, path + ".npz")


def test_default_device_needs_cuda(monkeypatch):
    from repro_torch.launch import distill_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim, scfg, fam = _configs(port=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        simulation.run_deepfusion(_port_sim(sim), scfg, fam)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distill_run.main(["--devices", "2", "--steps", "1"])
    params = M.init_params(scfg.moe_cfg, generator=torch.Generator())
    assert tree_leaves(params)[0].device.type == "cpu"
