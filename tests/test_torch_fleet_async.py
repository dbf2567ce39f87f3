"""The port's fleet extensions (``federated/async_fleet.py``, the traffic
model in ``federated/device.py``, ``AsyncFleetConfig`` and
``FleetAggregator`` in ``federated/server.py``, ``build_fleet`` /
``run_deepfusion`` with a schedule, ``launch/train.py --fleet``) against
the JAX reference, on the CPU.

Small f32 fleets of the reference test's two families (``CFG_A``,
``CFG_B`` of ``tests/test_fleet_async.py``); the port's device inits
cross from ``jax.random`` through ``test_torch_simulation.InitBridge``,
and the reference compiles with XLA's optimizations off.

Limits (readings on this CPU in brackets): traffic draws, selections,
``rounds`` logs and every integer of ``fleet_report`` exactly; uploads'
parameters 2e-6 absolute [4.9e-7] and losses 1e-6 relative [2.3e-7]
after 3 rounds of 2 steps; per-bucket aggregates 2e-6 absolute
[3.8e-7]; ``FleetAggregator`` all-fresh equal to ``tree_average`` bit
for bit, mixed staleness within 2e-6 relative of the f64 closed form
[4.4e-7] and 1e-6 absolute of the reference's merge; ideal async rounds
equal to the port's ``train_fleet`` bit for bit.

A stale report merged without its discount, planted in the port, must
break the stale run's aggregate limit by a factor of ten [7.7e-2].
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.federated import FederatedCorpus as JCorpus
from repro.federated import async_fleet as jaf
from repro.federated import device as jdev
from repro.federated import server as jserver
from repro.federated import simulation as jsim
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated import async_fleet as af
from repro_torch.federated import device as dev
from repro_torch.federated import server, simulation
from repro_torch.utils.pytree import tree_average, tree_leaves

from test_fleet_async import CFG_A, CFG_B, V
from test_torch_simulation import InitBridge, fast_reference_compiles
from test_torch_train import port_cfg  # repo root on sys.path

BATCH, SEQ = 2, 16
KW = dict(batch=BATCH, seq_len=SEQ)
PARAM_ATOL = 2e-6
LOSS_RTOL = 1e-6
TRAFFIC = dict(median_latency_s=2.0, latency_sigma=1.0, dropout_p=0.3)
ACFG = dict(rounds=3, steps_per_round=2, participation=0.7, deadline_s=1.5,
            seed=3)
MODES = {"drop": dict(deadline_policy="drop"),
         "stale": dict(deadline_policy="stale"),
         "standby": dict(deadline_policy="standby"),
         "hierarchical": dict(deadline_policy="stale", hierarchical=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora():
    kw = dict(seed=0, n_devices=8, n_domains=2, vocab=V)
    return JCorpus.build(**kw), FederatedCorpus.build(**kw)


def _fleet(port: bool, n, traffic=None):
    cfgs = [port_cfg(CFG_B), port_cfg(CFG_A)] if port else [CFG_B, CFG_A]
    D = dev if port else jdev
    tm = D.TrafficModel(**traffic) if traffic else None
    return [D.DeviceSpec(i, cfgs[i % 2], i % 2, i % 2, traffic=tm)
            for i in range(n)]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _max_diff(a, b):
    return max(float(np.max(np.abs(_np(x) - _np(y))))
               for x, y in zip(tree_leaves(a), jax.tree.leaves(b)))


def _bitwise(ua, ub):
    return all(a["losses"] == b["losses"] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a["params"]),
                                          tree_leaves(b["params"])))
        for a, b in zip(ua, ub))


# ---------------------------------------------------------------------------
# traffic, fleets, merging
# ---------------------------------------------------------------------------

def test_sample_traffic_matches_reference_bit_for_bit():
    models = [("profile", p) for p in sorted(dev.STRAGGLER_PROFILES)] + [
        ("custom", TRAFFIC),
        ("custom", dict(avail_period=3, avail_duty=2, dropout_p=0.5))]
    assert sorted(dev.STRAGGLER_PROFILES) == sorted(jdev.STRAGGLER_PROFILES)
    for kind, m in models:
        if kind == "profile":
            tm_t, tm_j = dev.STRAGGLER_PROFILES[m], jdev.STRAGGLER_PROFILES[m]
            assert dataclasses.asdict(tm_t) == dataclasses.asdict(tm_j)
        else:
            tm_t, tm_j = dev.TrafficModel(**m), jdev.TrafficModel(**m)
        for d in range(6):
            st = dev.DeviceSpec(d, None, 0, 0, traffic=tm_t)
            sj = jdev.DeviceSpec(d, None, 0, 0, traffic=tm_j)
            for seed in (0, 3):
                for r in range(10):
                    assert dev.sample_traffic(st, r, seed) == \
                        jdev.sample_traffic(sj, r, seed), (m, d, seed, r)
    ideal = dev.DeviceSpec(0, None, 0, 0)
    assert dev.sample_traffic(ideal, 4, 1) == \
        jdev.sample_traffic(jdev.DeviceSpec(0, None, 0, 0), 4, 1)


def test_build_fleet_applies_traffic_and_rejects_bad_profiles(corpora):
    jc, tc = corpora
    sim = simulation.SimulationConfig(n_devices=5, vocab=V, seq_len=SEQ)
    sim_j = jsim.SimulationConfig(n_devices=5, vocab=V, seq_len=SEQ)
    fam = [port_cfg(CFG_A), port_cfg(CFG_B)]
    for traffic in ("harsh", "mild", None):
        got = simulation.build_fleet(sim, tc, fam, traffic=traffic)
        want = jsim.build_fleet(sim_j, jc, [CFG_A, CFG_B], traffic=traffic)
        assert [(s.device_id, s.arch_id, s.domain_id) for s in got] == \
            [(s.device_id, s.arch_id, s.domain_id) for s in want]
        for s, sj in zip(got, want):
            assert (dataclasses.asdict(s.traffic) if s.traffic else None) \
                == (dataclasses.asdict(sj.traffic) if sj.traffic else None)
    tm = dev.TrafficModel(dropout_p=0.5)
    assert all(s.traffic is tm for s in
               simulation.build_fleet(sim, tc, fam, traffic=tm))
    with pytest.raises(ValueError) as e_port:
        simulation.build_fleet(sim, tc, fam, traffic="bogus")
    with pytest.raises(ValueError) as e_ref:
        jsim.build_fleet(sim_j, jc, [CFG_A, CFG_B], traffic="bogus")
    assert str(e_port.value) == str(e_ref.value)


def test_async_config_validates_as_the_reference():
    for bad in (dict(deadline_policy="wait"), dict(participation=0.0),
                dict(rounds=0)):
        with pytest.raises(ValueError) as e_port:
            server.AsyncFleetConfig(**bad).validate()
        with pytest.raises(ValueError) as e_ref:
            jserver.AsyncFleetConfig(**bad).validate()
        assert str(e_port.value) == str(e_ref.value)
    assert [f.name for f in dataclasses.fields(server.AsyncFleetConfig)] == \
        [f.name for f in dataclasses.fields(jserver.AsyncFleetConfig)]
    for t in (0, 1, 2, 5):
        assert server.staleness_weight(0.6, t, 0.5) == \
            jserver.staleness_weight(0.6, t, 0.5)


def _reports(seed, staleness):
    rng = np.random.default_rng(seed)
    return [{"device_id": i, "staleness": t,
             "params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": {"h": rng.standard_normal(5).astype(np.float32)}}}
            for i, t in enumerate(staleness)]


def _as(reps, to):
    return [dict(r, params=jax.tree.map(to, r["params"])) for r in reps]


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_aggregator_matches_reference(seed):
    acfg = server.AsyncFleetConfig(alpha=0.6, staleness_power=0.5)
    jacfg = jserver.AsyncFleetConfig(alpha=0.6, staleness_power=0.5)
    # all fresh: exactly tree_average, a copy even of one report
    fresh = _reports(seed, [0, 0, 0, 0])
    got = server.FleetAggregator(acfg).merge_round("b", _as(fresh,
                                                            torch.tensor))
    want = tree_average([jax.tree.map(torch.tensor, r["params"])
                         for r in fresh])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(got), tree_leaves(want)))
    one = _as(fresh[:1], torch.tensor)
    alone = server.FleetAggregator(acfg).merge_round("b", one)
    assert all(torch.equal(a, b) and a.data_ptr() != b.data_ptr() for a, b in
               zip(tree_leaves(alone), tree_leaves(one[0]["params"])))
    # mixed staleness: the f64 closed form and the reference's merge
    stale = [0, 2, 1]
    reps = _reports(seed + 10, stale)
    agg = server.FleetAggregator(acfg)
    got = agg.merge_round("b", _as(reps[::-1], torch.tensor))
    jagg = jserver.FleetAggregator(jacfg)
    want = jagg.merge_round("b", _as(reps, jnp.asarray))
    ws = np.array([server.staleness_weight(0.6, t, 0.5) for t in stale])
    ws /= ws.sum()
    for path in (("w",), ("b", "h")):
        cf = sum(w * np.asarray(_get(r["params"], path), np.float64)
                 for w, r in zip(ws, reps))
        np.testing.assert_allclose(_np(_get(got, path)), cf, rtol=2e-6,
                                   atol=1e-7)
    assert _max_diff(got, want) <= 1e-6
    assert agg.staleness_histogram() == jagg.staleness_histogram() == \
        {0: 1, 1: 1, 2: 1}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_server_momentum_matches_reference():
    """Three rounds at momentum 0.5 against the reference's; the last
    (one fresh report) is half the previous aggregate, half the report."""
    acfg = server.AsyncFleetConfig(server_momentum=0.5)
    jacfg = jserver.AsyncFleetConfig(server_momentum=0.5)
    agg, jagg = server.FleetAggregator(acfg), jserver.FleetAggregator(jacfg)
    for rnd, st in enumerate(([0], [0, 1], [0])):
        prev = agg.aggregates.get("b")
        reps = _reports(20 + rnd, st)
        got = agg.merge_round("b", _as(reps, torch.tensor))
        want = jagg.merge_round("b", _as(reps, jnp.asarray))
        assert _max_diff(got, want) <= 1e-6
    np.testing.assert_allclose(
        _np(got["w"]), 0.5 * _np(prev["w"]) + 0.5 * reps[0]["params"]["w"],
        rtol=1e-6)


# ---------------------------------------------------------------------------
# train_fleet_async against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def async_runs(corpora):
    """Every mode in both packages on one 6-device straggler fleet."""
    jc, tc = corpora
    out = {}
    with fast_reference_compiles(), pytest.MonkeyPatch.context() as mp:
        InitBridge(mp)
        for name, mode in MODES.items():
            acfg = dict(ACFG, **mode)
            want = jaf.train_fleet_async(
                _fleet(False, 6, TRAFFIC), jc,
                jserver.AsyncFleetConfig(**acfg), **KW)
            got = af.train_fleet_async(
                _fleet(True, 6, TRAFFIC), tc,
                server.AsyncFleetConfig(**acfg), device="cpu", **KW)
            out[name] = (got, want)
    return out


INT_KEYS = ("mode", "rounds", "participation_rate", "staleness_hist",
            "staleness_p95", "merged_reports", "lost_reports",
            "comm_bytes_global", "comm_bytes_edge", "n_hosts")


@pytest.mark.parametrize("mode", list(MODES))
def test_train_fleet_async_matches_reference(async_runs, mode):
    (ups, rep), (ups_j, rep_j) = async_runs[mode]
    assert set(rep) == set(rep_j)
    for k in INT_KEYS:
        assert rep[k] == rep_j[k], k
    assert set(rep["aggregates"]) == set(rep_j["aggregates"])
    for k in rep_j["aggregates"]:
        assert _max_diff(rep["aggregates"][k],
                         rep_j["aggregates"][k]) <= PARAM_ATOL, k
    for u, uj in zip(ups, ups_j):
        assert (u["device_id"], u["arch_id"], u["upload_bytes"]) == \
            (uj["device_id"], uj["arch_id"], uj["upload_bytes"])
        assert len(u["losses"]) == len(uj["losses"])
        np.testing.assert_allclose(u["losses"], uj["losses"], rtol=LOSS_RTOL)
        assert _max_diff(u["params"], uj["params"]) <= PARAM_ATOL
    print(mode, rep["rounds"], rep["staleness_hist"], rep["lost_reports"])


def test_straggler_runs_exercise_every_route(async_runs):
    """The draws give the runs what they are meant to test: offline
    devices, late reports dropped, stale merges, lost reports, standby
    over-selection and a cheaper global tier."""
    (_, drop), _ = async_runs["drop"]
    (_, stale), _ = async_runs["stale"]
    (_, standby), _ = async_runs["standby"]
    (_, hier), _ = async_runs["hierarchical"]
    assert any(r["online"] < 6 for r in stale["rounds"])
    assert sum(r["late_dropped"] for r in drop["rounds"]) > 0
    assert sum(r["stale_merged"] for r in stale["rounds"]) > 0
    assert stale["lost_reports"] > 0
    assert all(s["selected"] > d["selected"]
               for s, d in zip(standby["rounds"], drop["rounds"]))
    assert 0 < hier["comm_bytes_global"] < stale["comm_bytes_global"] == \
        hier["comm_bytes_edge"]


def test_stale_report_without_its_discount_breaks_the_limit(corpora,
                                                            async_runs):
    """A planted fault: every report merged at the fresh weight."""
    _, tc = corpora
    (_, _), (_, rep_j) = async_runs["stale"]
    with pytest.MonkeyPatch.context() as mp:
        InitBridge(mp)
        mp.setattr(server, "staleness_weight",
                   lambda alpha, staleness, power: float(alpha))
        _, rep = af.train_fleet_async(
            _fleet(True, 6, TRAFFIC), tc,
            server.AsyncFleetConfig(**ACFG, deadline_policy="stale"),
            device="cpu", **KW)
    worst = max(_max_diff(rep["aggregates"][k], rep_j["aggregates"][k])
                for k in rep_j["aggregates"])
    assert worst > 10 * PARAM_ATOL


# ---------------------------------------------------------------------------
# the port's own invariants
# ---------------------------------------------------------------------------

def test_ideal_async_equals_train_fleet_bit_for_bit(corpora):
    _, tc = corpora
    fleet = _fleet(True, 5)
    asy, rep = af.train_fleet_async(
        fleet, tc, server.AsyncFleetConfig(rounds=3, steps_per_round=2),
        device="cpu", **KW)
    sync = dev.train_fleet(fleet, tc, steps=6, device="cpu", **KW)
    assert _bitwise(asy, sync)
    assert rep["participation_rate"] == 1.0
    assert rep["staleness_hist"] == {0: 15} and rep["lost_reports"] == 0


def test_dropped_device_rejoins_where_it_paused(corpora):
    """Online on even rounds only: after 4 rounds of 2 steps the device
    has trained steps 0..3 of an 8-step horizon, on its stream's first
    four batches, bit for bit as a loop of ``train_step``."""
    from repro_torch.optim import cosine_schedule
    _, tc = corpora
    spec = dev.DeviceSpec(0, port_cfg(CFG_A), 0, 0,
                          traffic=dev.TrafficModel(avail_period=2,
                                                   avail_duty=1))
    ups, rep = af.train_fleet_async(
        [spec], tc, server.AsyncFleetConfig(rounds=4, steps_per_round=2),
        device="cpu", **KW)
    assert [r["online"] for r in rep["rounds"]] == [1, 0, 1, 0]
    params, opt = dev._device_init(spec, 0, torch.device("cpu"))
    sched = cosine_schedule(3e-3, 8, warmup=1)
    batches = tc.device_batches(0, 4, BATCH, SEQ)
    losses = []
    for s in range(4):
        loss, _, _ = dev.train_step(params, opt, spec.cfg,
                                    {k: v[s] for k, v in batches.items()},
                                    sched(s))
        losses.append(loss.item())
    assert ups[0]["losses"] == losses
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(ups[0]["params"]), tree_leaves(params)))


def test_multi_host_fleets_are_refused(corpora):
    """Multi-host fleets are ported (tests/test_torch_fleet_hosts.py, on
    4 ranks).  Refused, as the reference refuses them: more hosts than
    ranks (here one, no process group), and a mesh that is not a
    ``("hosts",)`` DeviceMesh."""
    _, tc = corpora
    acfg = server.AsyncFleetConfig(rounds=1, steps_per_round=1)
    with pytest.raises(ValueError, match="fleet mesh wants 2 hosts"):
        af.train_fleet_async(_fleet(True, 2), tc, acfg, n_hosts=2,
                             device="cpu", **KW)
    with pytest.raises(ValueError, match="fleet mesh wants 2 hosts"):
        dev.train_fleet(_fleet(True, 2), tc, steps=1, n_hosts=2,
                        device="cpu", **KW)
    with pytest.raises(ValueError, match="'hosts'"):
        dev.train_fleet(_fleet(True, 2), tc, steps=1, mesh=object(),
                        device="cpu", **KW)


def test_run_deepfusion_with_a_schedule_matches_reference_fleet():
    """``run_deepfusion`` with ``AsyncFleetConfig(rounds=2,
    steps_per_round=0)`` (derived: 4 steps over 2 rounds), ``traffic=
    "mild"`` and int8 Phase II moments runs end to end in the port, and
    its ``report["fleet"]`` equals the reference's (whose server is not
    run: the fleet log does not depend on it)."""
    moe = dict(name="async-moe-tiny", arch_type="moe", n_layers=1,
               d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
               n_experts=2, top_k=1, moe_d_ff=64, vocab_size=V,
               dtype="float32", remat=False, attn_chunk_q=16,
               attn_chunk_k=16, loss_chunk=16)
    from repro.models.config import ModelConfig as JModelConfig
    moe_j = JModelConfig(**moe).validate()
    sim = dict(n_devices=4, n_domains=2, vocab=V, seq_len=SEQ,
               device_steps=4, device_batch=BATCH, seed=0)
    srv = dict(distill_steps=2, distill_batch=2, tune_steps=2, tune_batch=2,
               seq_len=SEQ, n_stages=1, p_q=16, vaa_dim=32,
               state_policy="int8")
    sched = dict(rounds=2, steps_per_round=0, participation=0.75)
    logs = []
    with fast_reference_compiles(), pytest.MonkeyPatch.context() as mp:
        InitBridge(mp)
        mp.setattr(jsim, "DeepFusionServer", _NoServer)
        mp.setattr(jsim, "evaluate_model", lambda *a, **k: {"log_ppl": 0.0,
                                                             "accuracy": 0.0})
        _, want = jsim.run_deepfusion(
            jsim.SimulationConfig(**sim),
            jserver.ServerConfig(moe_cfg=moe_j, **srv,
                                 schedule=jserver.AsyncFleetConfig(**sched)),
            [CFG_A, CFG_B], log=lambda s: None, traffic="mild")
        _, got = simulation.run_deepfusion(
            simulation.SimulationConfig(**sim),
            server.ServerConfig(moe_cfg=port_cfg(moe_j).replace(
                use_kernels=False), **srv,
                schedule=server.AsyncFleetConfig(**sched)),
            [port_cfg(CFG_A), port_cfg(CFG_B)], log=logs.append,
            traffic="mild", device="cpu")
    for k in INT_KEYS:
        assert got["fleet"][k] == want["fleet"][k], k
    assert sum(len(u["losses"]) for u in got["uploads"]) == \
        sum(len(u["losses"]) for u in want["uploads"])
    assert np.isfinite(got["metrics"]["log_ppl"])
    assert all(np.isfinite(h).all() for h in got["distill_hists"])


class _NoServer:
    def __init__(self, *a, **k):
        pass

    def run(self, uploads):
        return None, {}


def test_train_launcher_fleet_check_sync_on_the_cpu():
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--fleet", "4", "--async-rounds", "2",
                         "--steps-per-round", "2", "--straggler-profile",
                         "mild", "--check-sync", "--device", "cpu",
                         "--batch", "2", "--seq", "16"])
    assert rc == 0, out.getvalue()
    assert "check-sync OK" in out.getvalue()
    # more hosts than ranks (no torchrun: one) is the reference's
    # oversubscription error; the production mesh stays refused
    with pytest.raises(ValueError, match="fleet mesh wants 2 hosts"):
        train.main(["--fleet", "4", "--device", "cpu", "--n-hosts", "2"])
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train.main(["--fleet", "4", "--device", "cpu", "--production-mesh"])
