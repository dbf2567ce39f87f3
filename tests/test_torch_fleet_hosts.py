"""Multi-host fleets (``n_hosts``, ``launch/mesh.py::make_fleet_mesh``)
on 4 CPU ranks, against the port's one host and the JAX reference.

The port runs in one ``torch.multiprocessing.spawn`` of 4 gloo ranks
(rendezvous through a file in the test's temporary directory), each rank
one simulated host; the reference runs in this process meanwhile, with
XLA's optimizations off, and so does ``launch/train.py --fleet 8
--n-hosts 4`` under ``torchrun --nproc-per-node 4``.  All are shared by
the file's tests.

**The oracle.** The reference's own multi-host fleet fails on the
installed JAX (0.9.0): with ``n_hosts`` > 1 its vmapped, scanned bucket
epoch over lanes laid out by a ``NamedSharding`` on ``("hosts",)``
raises ``ValueError: Resource axis: hosts ... is not found in mesh: ()``
(4 forced host devices, with or without ``jax.set_mesh``).  Its lanes
are independent and its own test holds ``n_hosts=4`` to ``n_hosts=1``
within 1e-6 (``tests/test_fleet_async.py::
test_multihost_matches_single_host_to_ulp``), so the port's
``n_hosts=4`` is held to the reference's ``n_hosts=1``.

The fleet: 6 devices of ``tests/test_fleet_async.py``'s two families
(``CFG_B``, ``CFG_A`` alternating), buckets of 3 lanes over 4 hosts, so
hosts 0-2 own one lane of each bucket and host 3 none (the reference
pads each bucket to 4 lanes with a copy of lane 0 and discards it).  The
port's device inits are the reference's draws (``jax.random`` at each
device's key, made in this process and converted), so the two packages
train the same weights.  ``train_fleet`` 4 steps, and
``train_fleet_async`` 3 rounds of 2 steps on a straggler fleet (the
traffic of ``tests/test_torch_fleet_async.py``: offline devices, late
reports merged stale).

Held: on every rank, ``n_hosts=4`` equals the port's ``n_hosts=1``
bit for bit (uploads' parameters and losses, bytes, the async report
with its aggregates, ``n_hosts`` apart); ``n_hosts=2`` (ranks 2 and 3
outside the mesh, receiving every upload) too; the uploads and the
async report match the reference's within
``tests/test_torch_fleet_async.py``'s ``PARAM_ATOL`` and ``LOSS_RTOL``,
its integers exactly (``n_hosts`` apart); a rank builds at most
ceil(lanes / n_hosts) lanes' state of each bucket (params and moments,
counted where they are made); ``run_deepfusion(n_hosts=4)`` equals
``n_hosts=1``; ``make_fleet_mesh`` beyond the world size raises
``ValueError``; the launcher exits 0 with one line, rank 0's.

Rank workers live at module level; this module imports torch and numpy
only at its top, since the spawned ranks import it.
"""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

V, BATCH, SEQ, N_DEV, STEPS = 64, 2, 16, 6, 4
KW = dict(batch=BATCH, seq_len=SEQ)
PARAM_ATOL = 2e-6       # tests/test_torch_fleet_async.py:51-52
LOSS_RTOL = 1e-6
TRAFFIC = dict(median_latency_s=2.0, latency_sigma=1.0, dropout_p=0.3)
ACFG = dict(rounds=3, steps_per_round=2, participation=0.7, deadline_s=1.5,
            seed=3, deadline_policy="stale")
SMALL = dict(vocab_size=V, dtype="float32", remat=False, attn_chunk_q=16,
             attn_chunk_k=16, loss_chunk=16)
# tests/test_fleet_async.py's CFG_A and CFG_B (checked below)
FAMILIES = {
    "async-b-tiny": dict(name="async-b-tiny", n_layers=2, d_model=48,
                         n_heads=2, n_kv_heads=2, head_dim=24, d_ff=96,
                         **SMALL),
    "async-a-tiny": dict(name="async-a-tiny", n_layers=1, d_model=32,
                         n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                         norm_type="layernorm", act="gelu", mlp_gated=False,
                         pos_embedding="sinusoidal", **SMALL)}
INT_KEYS = ("mode", "rounds", "participation_rate", "staleness_hist",
            "staleness_p95", "merged_reports", "lost_reports",
            "comm_bytes_global", "comm_bytes_edge", "n_hosts")
# run_deepfusion's small pipeline: the families above, a one-layer MoE
SIM = dict(n_devices=4, n_domains=2, vocab=V, seq_len=SEQ, device_steps=2,
           device_batch=BATCH, seed=0)
MOE = dict(name="hosts-moe-tiny", arch_type="moe", n_layers=1, d_model=32,
           n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, n_experts=2,
           top_k=1, moe_d_ff=64, **SMALL)
SRV = dict(distill_steps=2, distill_batch=2, tune_steps=2, tune_batch=2,
           seq_len=SEQ, n_stages=1, p_q=16, vaa_dim=32)
LAUNCHER = ["--fleet", "8", "--n-hosts", "4", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _family_of(device_id):
    return list(FAMILIES)[device_id % 2]


def _bridged_init(inits, own):
    """``models.model.init_params`` returning the reference's draw for a
    seeded generator whose (config, seed) ``inits`` holds, else ``own``'s."""
    from repro_torch import convert

    def init_params(cfg, *, generator):
        if isinstance(generator, torch.Generator):
            key = f"{cfg.name}/{generator.initial_seed()}"
            if key in inits:
                return convert.params_from_jax(inits[key], cfg,
                                               device=generator.device)
        return own(cfg, generator=generator)
    return init_params


def _bytes_counter(dev_mod, af_mod, counts):
    """Wraps both modules' ``_device_init`` so that each made state's
    bytes (params and moments) add to ``counts[cfg.name]``."""
    from repro_torch.utils.pytree import tree_bytes
    own = dev_mod._device_init

    def device_init(spec, *a, **k):
        params, opt = own(spec, *a, **k)
        counts[spec.cfg.name] = counts.get(spec.cfg.name, 0) + (
            tree_bytes(params) + tree_bytes(opt["m"]) + tree_bytes(opt["v"]))
        return params, opt
    dev_mod._device_init = af_mod._device_init = device_init
    return own


def _np_uploads(ups):
    from repro_torch.utils.pytree import tree_map
    return [dict(u, params=tree_map(lambda t: t.detach().numpy(),
                                    u["params"]), embedding=None)
            for u in ups]


def _same_uploads(a, b):
    from repro_torch.utils.pytree import tree_leaves
    return len(a) == len(b) and all(
        x["losses"] == y["losses"] and x["upload_bytes"] == y["upload_bytes"]
        and x["device_id"] == y["device_id"] and x["arch_id"] == y["arch_id"]
        and all(torch.equal(p, q) for p, q in zip(tree_leaves(x["params"]),
                                                   tree_leaves(y["params"])))
        for x, y in zip(a, b))


def _same_report(r1, r4, n_hosts):
    from repro_torch.utils.pytree import tree_leaves
    return (r1["n_hosts"] == 1 and r4["n_hosts"] == n_hosts
            and set(r1) == set(r4)
            and all(r1[k] == r4[k] for k in r1
                    if k not in ("aggregates", "n_hosts"))
            and set(r1["aggregates"]) == set(r4["aggregates"])
            and all(torch.equal(p, q) for k in r1["aggregates"]
                    for p, q in zip(tree_leaves(r1["aggregates"][k]),
                                    tree_leaves(r4["aggregates"][k]))))


def _rank_worker(rank, rdzv, inits_path, out_path):
    """One simulated host: the fleets at n_hosts 1, 4 and 2, the
    pipeline at 1 and 4, the oversubscription check; rank 0 writes what
    the tests read, every rank's flags and bytes gathered."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=4)
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import async_fleet as af
    from repro_torch.federated import device as dev
    from repro_torch.federated import server, simulation
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig
    from repro_torch.utils.pytree import tree_leaves, tree_map
    with open(inits_path, "rb") as f:
        M.init_params = _bridged_init(pickle.load(f), M.init_params)
    cfgs = {k: ModelConfig(**v).validate() for k, v in FAMILIES.items()}
    tm = dev.TrafficModel(**TRAFFIC)
    fleet = [dev.DeviceSpec(i, cfgs[_family_of(i)], i % 2, i % 2, traffic=tm)
             for i in range(N_DEV)]
    corpus = FederatedCorpus.build(seed=0, n_devices=8, n_domains=2, vocab=V)
    acfg = server.AsyncFleetConfig(**ACFG)
    flags, made = {}, {}
    runs = {}
    for n in (1, 4, 2):
        made[n] = {}
        own = _bytes_counter(dev, af, made[n])
        try:
            runs[n] = (dev.train_fleet(fleet, corpus, steps=STEPS, n_hosts=n,
                                       device="cpu", **KW),
                       af.train_fleet_async(fleet, corpus, acfg, n_hosts=n,
                                            device="cpu", **KW))
        finally:
            dev._device_init = af._device_init = own
    for n in (4, 2):
        flags[f"sync/{n}"] = _same_uploads(runs[n][0], runs[1][0])
        flags[f"async/{n}"] = _same_uploads(runs[n][1][0], runs[1][1][0])
        flags[f"report/{n}"] = _same_report(runs[1][1][1], runs[n][1][1], n)
    # the pipeline, fleet over hosts then the server whole on every rank
    sim = simulation.SimulationConfig(**SIM)
    scfg = server.ServerConfig(moe_cfg=ModelConfig(**MOE).validate().replace(
        use_kernels=False), **SRV)
    fam = list(cfgs.values())
    pipe = {}
    for n in (1, 4):
        moe_params, rep = simulation.run_deepfusion(
            sim, scfg, fam, log=lambda s: None, n_hosts=n, device="cpu")
        pipe[n] = (moe_params, rep)
    one, four = pipe[1], pipe[4]
    flags["pipeline"] = (
        _same_uploads(four[1]["uploads"], one[1]["uploads"])
        and all(four[1][k] == one[1][k] for k in ("metrics", "tune_hist",
                                                   "distill_hists",
                                                   "cluster_sizes",
                                                   "comm_bytes"))
        and all(torch.equal(a, b) for a, b in zip(tree_leaves(four[0]),
                                                  tree_leaves(one[0]))))
    try:
        LM.make_fleet_mesh(5, device="cpu")
        flags["oversubscribed"] = False
    except ValueError as e:
        flags["oversubscribed"] = "fleet mesh wants 5 hosts" in str(e)
    everyone = [None] * 4
    dist.all_gather_object(everyone, {"flags": flags, "made": made})
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump({"ranks": everyone,
                         "sync": _np_uploads(runs[4][0]),
                         "async": _np_uploads(runs[4][1][0]),
                         "report": dict(runs[4][1][1], aggregates={
                             k: tree_map(lambda t: t.numpy(), v) for k, v in
                             runs[4][1][1]["aggregates"].items()})}, f)
    dist.barrier()
    dist.destroy_process_group()


def _reference(cfgs):
    """The reference's n_hosts=1 fleet runs (numpy parameters)."""
    import jax
    from repro.data.federated import FederatedCorpus
    from repro.federated import async_fleet as jaf
    from repro.federated import device as jdev
    from repro.federated import server as jserver
    from test_torch_simulation import fast_reference_compiles
    tm = jdev.TrafficModel(**TRAFFIC)
    fleet = [jdev.DeviceSpec(i, cfgs[_family_of(i)], i % 2, i % 2,
                             traffic=tm) for i in range(N_DEV)]
    corpus = FederatedCorpus.build(seed=0, n_devices=8, n_domains=2, vocab=V)

    def np_tree(t):
        return jax.tree.map(np.asarray, t)

    with fast_reference_compiles():
        ups = jdev.train_fleet(fleet, corpus, steps=STEPS, **KW)
        asy, rep = jaf.train_fleet_async(
            fleet, corpus, jserver.AsyncFleetConfig(**ACFG), **KW)
    return {"sync": [dict(u, params=np_tree(u["params"])) for u in ups],
            "async": [dict(u, params=np_tree(u["params"])) for u in asy],
            "report": dict(rep, aggregates={
                k: np_tree(v) for k, v in rep["aggregates"].items()})}


@pytest.fixture(scope="module")
def results():
    """(reference, port, launcher) results: the ranks and the torchrun
    launcher run while the reference runs here."""
    import jax
    import torch.multiprocessing as mp
    from repro.models import model as JM
    from repro.models.config import ModelConfig as JModelConfig
    from repro_torch import convert
    from test_fleet_async import CFG_A, CFG_B
    cfgs = {k: JModelConfig(**v).validate() for k, v in FAMILIES.items()}
    assert cfgs["async-a-tiny"] == CFG_A and cfgs["async-b-tiny"] == CFG_B
    inits = {}
    for d in range(max(N_DEV, SIM["n_devices"])):
        for name, c in cfgs.items():
            pj = JM.init_params(jax.random.PRNGKey(d), c)
            inits[f"{name}/{d}"] = convert.unflatten(
                convert.flatten(jax.tree.map(np.asarray, pj)))
    with tempfile.TemporaryDirectory() as tmp:
        inits_path, port_path = (os.path.join(tmp, f"{n}.pkl")
                                 for n in ("inits", "port"))
        with open(inits_path, "wb") as f:
            pickle.dump(inits, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src"),
             env.get("PYTHONPATH", "")])
        launcher = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
             *LAUNCHER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            ranks = mp.spawn(_rank_worker, args=(
                os.path.join(tmp, "rdzv"), inits_path, port_path), nprocs=4,
                join=False)
            want = _reference(cfgs)
            while not ranks.join():
                pass
        finally:
            l_out, l_err = launcher.communicate(timeout=600)
        with open(port_path, "rb") as f:
            got = pickle.load(f)
        yield want, got, (launcher.returncode, l_out, l_err)


def _max_diff(a, b):
    from repro_torch.utils.pytree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
               for x, y in zip(la, lb))


@pytest.mark.parametrize("n_hosts", [4, 2])
@pytest.mark.parametrize("what", ["sync", "async", "report"])
def test_fleet_over_hosts_equals_one_host(results, what, n_hosts):
    """Every rank's uploads (and async report) at n_hosts equal its own
    n_hosts=1 run's bit for bit; at 2 hosts ranks 2 and 3 are outside the
    mesh and receive every upload."""
    _, got, _ = results
    for r, rk in enumerate(got["ranks"]):
        assert rk["flags"][f"{what}/{n_hosts}"], (r, what, n_hosts)


@pytest.mark.parametrize("what", ["sync", "async"])
def test_fleet_over_hosts_matches_reference(results, what):
    want, got, _ = results
    assert len(got[what]) == len(want[what]) == N_DEV
    for u, uj in zip(got[what], want[what]):
        assert (u["device_id"], u["arch_id"], u["upload_bytes"]) == \
            (uj["device_id"], uj["arch_id"], uj["upload_bytes"])
        assert len(u["losses"]) == len(uj["losses"])
        if what == "sync":
            assert len(u["losses"]) == STEPS
        if u["losses"]:
            np.testing.assert_allclose(u["losses"], uj["losses"],
                                       rtol=LOSS_RTOL)
        assert _max_diff(u["params"], uj["params"]) <= PARAM_ATOL


def test_async_report_over_hosts_matches_reference(results):
    want, got, _ = results
    rep, rep_j = got["report"], want["report"]
    assert (rep["n_hosts"], rep_j["n_hosts"]) == (4, 1)
    assert set(rep) == set(rep_j)
    for k in INT_KEYS[:-1]:
        assert rep[k] == rep_j[k], k
    assert set(rep["aggregates"]) == set(rep_j["aggregates"])
    for k in rep_j["aggregates"]:
        assert _max_diff(rep["aggregates"][k],
                         rep_j["aggregates"][k]) <= PARAM_ATOL, k
    # the traffic reaches every route the sharing must carry
    assert any(r["online"] < N_DEV for r in rep["rounds"])
    assert sum(r["stale_merged"] for r in rep["rounds"]) > 0


@pytest.mark.parametrize("n_hosts", [4, 2])
def test_resident_fleet_state_is_a_share(results, n_hosts):
    """A rank builds at most ceil(lanes / n_hosts) lanes' state of each
    bucket: at most that share of the state one host builds (params and
    moments, sync and async runs together); every lane is built once."""
    _, got, _ = results
    lanes = N_DEV // 2
    share = -(-lanes // n_hosts) / lanes
    whole = got["ranks"][0]["made"][1]
    assert set(whole) == set(FAMILIES)
    for name, total in whole.items():
        per_rank = [rk["made"][n_hosts].get(name, 0) for rk in got["ranks"]]
        assert max(per_rank) <= share * total, (name, per_rank, total)
        assert sum(per_rank) == total, (name, per_rank, total)
    if n_hosts == 4:
        assert got["ranks"][3]["made"][4] == {}


def test_run_deepfusion_over_hosts_equals_one_host(results):
    _, got, _ = results
    assert all(rk["flags"]["pipeline"] for rk in got["ranks"])


def test_make_fleet_mesh_refuses_more_hosts_than_ranks(results):
    from repro_torch.launch import mesh as LM
    _, got, _ = results
    assert all(rk["flags"]["oversubscribed"] for rk in got["ranks"])
    # no process group: one rank
    with pytest.raises(ValueError, match="fleet mesh wants 2 hosts"):
        LM.make_fleet_mesh(2, device="cpu")


def test_fleet_launcher_on_four_ranks(results):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --fleet 8
    --n-hosts 4 --device cpu``: only rank 0 prints its line."""
    _, _, (rc, out, err) = results
    assert rc == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    lines = [ln for ln in out.splitlines() if ln.startswith("sync fleet")]
    assert len(lines) == 1 and "8 uploads" in lines[0] and \
        "on 4 host(s)" in lines[0], out
