"""The port's expert-parallel MoE paths (``moe_a2a``, ``moe_replicated_ep``)
against the JAX reference's, on 4 CPU ranks.

The reference runs in one subprocess on 4 forced host devices
(``XLA_FLAGS`` must be set before JAX starts, and this process has
started it), with ``use_pallas=False``: its Pallas dispatch kernel needs
``pl.load``, which the installed JAX lacks.  The port runs in one
``torch.multiprocessing.spawn`` of 4 gloo ranks (rendezvous through a
file in the test's temporary directory), each rank one device of the
mesh, on both its kernel path (the kernels' plain versions on CPU
tensors) and its plain path.  Both are shared by the file's tests.

Cases: meshes (2, 2) and (1, 4), E 3 (padded to 4) and E 4, top-2 of
64 rows, one shared expert; dropless (``moe_dropless``), dropping
(``capacity_factor`` 0.5: drops must happen, the dense path differs),
and dropping with a ``live`` mask whose dead rows come first.  Outputs,
the aux loss, and the gradients of x and of every router and expert
leaf of ``sum(out * ct) + 3 aux`` within 1e-5 (f32 sums in another
order), every rank's output and x gradient equal to rank 0's, data
replicas' expert gradients equal.  Planted faults must break them:
capacity from the global row count instead of the rank's, the combine
without its reverse transpose, ``live`` not passed to
``capacity_positions``, replicated_ep without its local mask.  A rank's
resident expert bytes are 1/ep of the padded whole.

Rank workers live at module level; this module imports torch and numpy
only at its top, since the spawned ranks import it.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

MESHES = ((2, 2), (1, 4))
EXPERTS = (3, 4)
REGIMES = ("dropless", "drops", "live")
IMPLS = ("a2a", "replicated_ep")
FAULTS = {"global_capacity": ("a2a",), "no_reverse_transpose": ("a2a",),
          "live_ignored": IMPLS, "no_local_mask": ("replicated_ep",)}
B, S, D, F, K = 4, 16, 16, 24, 2
TOL = 1e-5
LEAVES = ("router", "wi_gate", "wi_up", "wo", "shared/wi_gate",
          "shared/wi_up", "shared/wo")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case_names():
    return [f"{m[0]}x{m[1]}-E{e}-{r}" for m in MESHES for e in EXPERTS
            for r in REGIMES]


def _parse(case):
    mesh, e, regime = case.split("-")
    return tuple(map(int, mesh.split("x"))), int(e[1:]), regime


def _inputs():
    """Seeded numpy inputs: per E the layer's weights, and x, the
    cotangent and the live mask."""
    rng = np.random.default_rng(0)
    arrays = {"x": rng.normal(size=(B, S, D)).astype(np.float32),
              "ct": rng.normal(size=(B, S, D)).astype(np.float32)}
    live = np.ones((B, S), bool)
    live[0, :12] = False          # dead rows first: they would crowd
    live[2, 3::4] = False         # live ones out of capacity
    arrays["live"] = live
    for E in EXPERTS:
        shapes = {"router": (D, E), "wi_gate": (E, D, F),
                  "wi_up": (E, D, F), "wo": (E, F, D),
                  "shared/wi_gate": (D, F), "shared/wi_up": (D, F),
                  "shared/wo": (F, D)}
        for name, shape in shapes.items():
            arrays[f"E{E}/{name}"] = (rng.normal(size=shape)
                                      / np.sqrt(shape[-2])).astype(np.float32)
    return arrays


def _cfg_kwargs(E, regime):
    kw = dict(name="ep", arch_type="moe", n_layers=1, d_model=D, n_heads=2,
              n_kv_heads=2, head_dim=8, d_ff=32, n_experts=E, top_k=K,
              moe_d_ff=F, n_shared_experts=1, vocab_size=64, dtype="float32")
    if regime == "dropless":
        kw["moe_dropless"] = True
    else:
        kw["capacity_factor"] = 0.5
    return kw


_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
jax.config.update("jax_disable_most_optimizations", True)
from repro.models import moe
from repro.models.config import ModelConfig
sys.path.insert(0, os.path.dirname(sys.argv[3]))
import test_torch_moe_ep as T

inp = dict(np.load(sys.argv[1]))
out = {}
for case in T._case_names():
    shape, E, regime = T._parse(case)
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    cfg = ModelConfig(**T._cfg_kwargs(E, regime)).validate()
    p = {}
    for name in T.LEAVES:
        node, *rest = name.split("/")
        v = jnp.asarray(inp[f"E{E}/{name}"])
        if rest:
            p.setdefault(node, {})[rest[0]] = v
        else:
            p[node] = v
    x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])
    live = jnp.asarray(inp["live"]) if regime == "live" else None
    dense = jax.jit(lambda p, x: moe.apply_moe(
        p, cfg.replace(moe_impl="dense"), x, mesh, live)[0])(p, x)
    out[f"{case}/dense/out"] = np.asarray(dense)
    for impl in T.IMPLS:
        c = cfg.replace(moe_impl=impl, use_pallas=False)

        def loss(p, x):
            o, aux = moe.apply_moe(p, c, x, mesh, live)
            return jnp.sum(o * ct) + 3.0 * aux, (o, aux)

        (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
        key = f"{case}/{impl}"
        out[f"{key}/out"], out[f"{key}/aux"] = np.asarray(o), np.asarray(aux)
        out[f"{key}/gx"] = np.asarray(gx)
        for name in T.LEAVES:
            node, *rest = name.split("/")
            g = gp[node][rest[0]] if rest else gp[node]
            out[f"{key}/g/{name}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _rank_worker(rank, rdzv, inputs_path, out_path):
    """One rank of the port's mesh: every case on both port paths, then
    the planted faults; rank 0 writes what the tests read."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=4)
    from repro_torch.launch import mesh as LM
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    inp = dict(np.load(inputs_path))
    res = {}
    orig = {n: getattr(moe, n) for n in ("_capacity", "_source_major",
                                         "capacity_positions", "_local_mask")}
    faults = {
        "global_capacity": ("_capacity", lambda cfg, t, E, *, align:
                            orig["_capacity"](cfg, B * S, E, align=align)),
        "no_reverse_transpose": ("_source_major", lambda y, ep, E_loc, cap:
                                 y.reshape(ep * E_loc * cap, D)),
        "live_ignored": ("capacity_positions", lambda flat_e, cap, valid=None:
                         orig["capacity_positions"](flat_e, cap)),
        "no_local_mask": ("_local_mask", lambda flat_e, E_loc, dev:
                          torch.ones_like(flat_e, dtype=torch.bool))}
    meshes = {(2, 2): LM.make_decode_mesh(device="cpu"),
              (1, 4): LM.make_host_mesh(device="cpu")}
    assert sorted(meshes) == sorted(MESHES)
    for case in _case_names():
        shape, E, regime = _parse(case)
        mesh = meshes[shape]
        cfg = ModelConfig(**_cfg_kwargs(E, regime)).validate()
        whole = {}
        for name in LEAVES:
            node, *rest = name.split("/")
            v = torch.from_numpy(inp[f"E{E}/{name}"])
            if rest:
                whole.setdefault(node, {})[rest[0]] = v
            else:
                whole[node] = v
        x, ct = torch.from_numpy(inp["x"]), torch.from_numpy(inp["ct"])
        live = torch.from_numpy(inp["live"]) if regime == "live" else None
        for impl in IMPLS:
            runs = [(f"kernels={k}", k, None) for k in (True, False)]
            runs += [(f"fault={f}", True, f) for f, on in faults.items()
                     if impl in FAULTS[f]]
            for tag, use_kernels, fault in runs:
                c = cfg.replace(moe_impl=impl, use_kernels=use_kernels)
                if fault:
                    setattr(moe, faults[fault][0], faults[fault][1])
                try:
                    _run_case(res, f"{case}/{impl}/{tag}", moe, c, mesh,
                              whole, x, ct, live, full=fault is None)
                finally:
                    for n, f in orig.items():
                        setattr(moe, n, f)
    if rank == 0:
        np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()


def _run_case(res, key, moe, cfg, mesh, whole, x, ct, live, *, full):
    import torch.distributed as dist
    local = moe.shard_experts({"moe": whole}, cfg, mesh)["moe"]
    p = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v) else
             {kk: vv.clone().requires_grad_(True) for kk, vv in v.items()})
         for k, v in local.items()}
    xx = x.clone().requires_grad_(True)
    out, aux = moe.apply_moe(p, cfg, xx, mesh, live=live)
    (torch.sum(out * ct) + 3.0 * aux).backward()
    res[f"{key}/out"] = out.detach().numpy()
    res[f"{key}/gx"] = xx.grad.numpy()
    if not full:
        return
    res[f"{key}/aux"] = aux.detach().numpy()
    world = dist.get_world_size()

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return parts

    # every rank's output and x gradient against rank 0's
    res[f"{key}/rank_spread"] = np.float32(max(
        (a - b).abs().max().item() for t in (out.detach(), xx.grad)
        for a, b in zip(gather(t), [t] * world)))
    m = mesh.shape
    impl = moe.moe_path(cfg, mesh)
    E = cfg.n_experts
    for name in LEAVES:
        node, *rest = name.split("/")
        g = p[node][rest[0]].grad if rest else p[node].grad
        if node in ("wi_gate", "wi_up", "wo"):
            parts = gather(g)
            if impl == "a2a":
                # rank r holds block r % model, replicated over data
                blocks = [parts[k] for k in range(m[1])]
                res[f"{key}/replica_spread"] = np.float32(max(
                    (parts[r] - parts[r % m[1]]).abs().max().item()
                    for r in range(world)))
            else:
                blocks = parts
            g = torch.cat(blocks)[:E]
            res[f"{key}/resident/{name}"] = np.int64(local[node].numel())
        res[f"{key}/g/{name}"] = g.numpy()


@pytest.fixture(scope="module")
def results():
    """(reference, port) result dicts: the JAX subprocess and the ranks
    run side by side."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.npz")
        np.savez(inputs, **_inputs())
        ref_path, port_path = (os.path.join(tmp, f"{n}.npz")
                               for n in ("ref", "port"))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src"),
             env.get("PYTHONPATH", "")])
        env.pop("XLA_FLAGS", None)
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, inputs, ref_path,
             os.path.abspath(__file__)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            mp.spawn(_rank_worker, args=(os.path.join(tmp, "rdzv"), inputs,
                                         port_path), nprocs=4)
        finally:
            stdout, stderr = ref.communicate(timeout=600)
        assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        yield dict(np.load(ref_path)), dict(np.load(port_path))


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max())


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", _case_names())
def test_sharded_paths_match_reference(results, case, impl, kernels):
    ref, port = results
    want, got = f"{case}/{impl}", f"{case}/{impl}/kernels={kernels}"
    errs = {what: _err(port[f"{got}/{what}"], ref[f"{want}/{what}"])
            for what in ["out", "aux", "gx"] + [f"g/{n}" for n in LEAVES]}
    assert max(errs.values()) < TOL, errs
    assert float(port[f"{got}/rank_spread"]) == 0.0
    if impl == "a2a":
        assert float(port[f"{got}/replica_spread"]) == 0.0


@pytest.mark.parametrize("case", [c for c in _case_names()
                                  if not c.endswith("dropless")])
def test_drops_happen(results, case):
    """Under capacity_factor 0.5 both reference paths drop assignments:
    they differ from the dense path; dropless they equal it."""
    ref, _ = results
    dense = ref[f"{case}/dense/out"]
    for impl in IMPLS:
        assert _err(ref[f"{case}/{impl}/out"], dense) > 1e-2, impl
        free = case.rsplit("-", 1)[0] + "-dropless"
        assert _err(ref[f"{free}/{impl}/out"], ref[f"{free}/dense/out"]) \
            < TOL, impl


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_break_it(results, fault):
    ref, port = results
    worst = max(
        max(_err(port[f"{c}/{i}/fault={fault}/out"], ref[f"{c}/{i}/out"]),
            _err(port[f"{c}/{i}/fault={fault}/gx"], ref[f"{c}/{i}/gx"]))
        for c in _case_names() for i in FAULTS[fault])
    assert worst > 1e3 * TOL, (fault, worst)


@pytest.mark.parametrize("impl", IMPLS)
def test_resident_expert_bytes_are_a_share(results, impl):
    """A rank holds 1/ep of the experts padded to E_pad (a2a: ep = the
    model axis; replicated_ep: every rank)."""
    _, port = results
    for case in _case_names():
        shape, E, _ = _parse(case)
        ep = shape[1] if impl == "a2a" else shape[0] * shape[1]
        e_pad = -(-E // ep) * ep
        for name in ("wi_gate", "wi_up", "wo"):
            got = int(port[f"{case}/{impl}/kernels=True/resident/{name}"])
            assert got * ep == e_pad * D * F, (case, name)
