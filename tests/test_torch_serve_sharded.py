"""Sharded serving of the port on 4 CPU ranks (gloo), the decode mesh
(2, 2), against the JAX reference.

The reference's engines run in this process with ``mesh=None`` and
``use_pallas=False`` on the traffic of ``tests/test_serve_sharded.py``
(``_traffic``: 4 requests of 6-11 tokens, 2 slots, segments of 3), its
reduced weights at ``PRNGKey(1)``.  Its own 1-device-mesh engine emits
other tokens than ``mesh=None`` for reduced qwen2-moe (a known failure of
the reference), so the ``mesh=None`` engine is the oracle.  The port
runs in one ``torch.multiprocessing.spawn`` of 4 ranks (rendezvous
through a file in a temporary directory) shared by the file's tests,
the weights converted:

* both engines' greedy tokens on the mesh equal the reference's for
  reduced qwen2-moe, deepseek-moe, deepseek-v3 and tinyllama (the MoEs
  through the a2a path, experts cut to the rank's block); the paged
  engine's allocator split in 2 data shards and drained;
* qwen2-moe: ``Temperature(0.8)`` on the mesh equal to the port's
  ``mesh=None`` engine (the port's streams are not JAX's);
  ``overlap_a2a`` on equal to off; the replicated_ep path equal too;
* ``launch/serve.py --sharded --check-unsharded`` on the ranks prints
  ``check-unsharded: completions match``, and so does one rank without
  ``torchrun``, in process;
* the ``_overlap_ok`` gate's cases, in process.

Rank workers live at module level; this module imports torch and numpy
only at its top, since the spawned ranks import it.
"""
import contextlib
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

ARCHS = ("qwen2-moe-a2.7b", "deepseek-moe-16b", "deepseek-v3-671b",
         "tinyllama-1.1b")
ENGINE_KW = dict(n_slots=2, seg_len=3, seed=0)
PAGED_KW = dict(block_len=4, n_blocks=32)
LAUNCH = ["--arch", "qwen2-moe-a2.7b", "--variant", "reduced", "--device",
          "cpu", "--sharded", "--check-unsharded", "--paged"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(tmp):
    """The reference's weights, traffic and ``mesh=None`` tokens, written
    for the ranks; returns the tokens by arch."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    from repro.serve import ServeEngine as JaxEngine
    from repro_torch import convert

    from test_serve_chunked import run_engine
    from test_serve_sharded import _traffic
    from test_torch_simulation import fast_reference_compiles

    arrays, meta, want = {}, {}, {}
    with fast_reference_compiles():
        for arch in ARCHS:
            cfg_j = jax_config(arch, variant="reduced").replace(
                use_pallas=False)
            pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
            for path, leaf in convert.flatten(
                    jax.tree.map(np.asarray, pj)).items():
                assert leaf.dtype == np.float32, (arch, path)
                arrays[f"{arch}|{path}"] = leaf
            batches, lengths, max_len = _traffic(cfg_j)
            for i, b in enumerate(batches):
                arrays[f"{arch}#{i}"] = np.asarray(b["tokens"], np.int32)
            meta[arch] = {"lengths": lengths, "max_len": max_len}
            want[arch], _ = run_engine(JaxEngine, pj, cfg_j, batches,
                                       lengths, max_len, mesh=None,
                                       **ENGINE_KW)
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
    return want


def _run(cls, params, cfg, batches, lengths, max_len, **kw):
    eng = cls(params, cfg, max_len=max_len, device="cpu", **kw)
    for b, (_, g) in zip(batches, lengths):
        eng.submit(b, max_new=g)
    comps = eng.run()
    return {str(u): c.tokens.tolist() for u, c in comps.items()}, eng


def _rank_worker(rank, rdzv, tmp):
    """One rank: every engine case on the (2, 2) mesh, then the launcher;
    rank 0 writes what the tests read."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=4)
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import PagedServeEngine, ServeEngine, Temperature

    data = dict(np.load(os.path.join(tmp, "inputs.npz")))
    meta = json.loads(str(data.pop("meta")))
    mesh = LM.make_decode_mesh(device="cpu")
    res = {"mesh": list(mesh.shape)}
    for arch in ARCHS:
        cfg = get_config(arch, variant="reduced")
        flat = {k.split("|", 1)[1]: torch.from_numpy(v)
                for k, v in data.items() if k.startswith(arch + "|")}
        pt = convert.params_from_jax(convert.unflatten(flat), cfg)
        lengths, max_len = meta[arch]["lengths"], meta[arch]["max_len"]
        batches = [{"tokens": data[f"{arch}#{i}"]}
                   for i in range(len(lengths))]
        traffic = (batches, lengths, max_len)
        r = res[arch] = {}
        r["contiguous"], _ = _run(ServeEngine, pt, cfg, *traffic, mesh=mesh,
                                  **ENGINE_KW)
        r["paged"], eng = _run(PagedServeEngine, pt, cfg, *traffic,
                               mesh=mesh, **ENGINE_KW, **PAGED_KW)
        r["n_shards"] = eng.alloc.n_shards
        r["drained"] = (eng.alloc.n_free == eng.alloc.n_blocks - 1
                        and not eng._slot_blocks)
        if arch != "qwen2-moe-a2.7b":
            continue
        r["overlap"], _ = _run(ServeEngine, pt,
                               cfg.replace(overlap_a2a=True), *traffic,
                               mesh=mesh, **ENGINE_KW)
        r["replicated_ep"], _ = _run(ServeEngine, pt,
                                     cfg.replace(moe_impl="replicated_ep"),
                                     *traffic, mesh=mesh, **ENGINE_KW)
        hot = dict(ENGINE_KW, seed=7, sampler=Temperature(0.8))
        r["temperature"], _ = _run(ServeEngine, pt, cfg, *traffic[:2],
                                   max_len, mesh=mesh, **hot)
        r["temperature_unsharded"], _ = _run(ServeEngine, pt, cfg,
                                             *traffic[:2], max_len, **hot)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(LAUNCH)
    res["launcher_stdout"] = out.getvalue()
    if rank == 0:
        with open(os.path.join(tmp, "port.json"), "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs():
    """(reference tokens, the ranks' results)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        want = _reference(tmp)
        mp.spawn(_rank_worker, args=(os.path.join(tmp, "rdzv"), tmp),
                 nprocs=4)
        with open(os.path.join(tmp, "port.json")) as f:
            got = json.load(f)
    return {a: {str(u): t for u, t in w.items()} for a, w in want.items()}, got


@pytest.mark.parametrize("engine", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engines_match_reference(runs, arch, engine):
    want, got = runs
    assert got["mesh"] == [2, 2]
    assert got[arch][engine] == want[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_allocator_splits_over_data_and_drains(runs, arch):
    _, got = runs
    assert got[arch]["n_shards"] == 2
    assert got[arch]["drained"]


def test_temperature_matches_unsharded(runs):
    _, got = runs
    r = got["qwen2-moe-a2.7b"]
    assert r["temperature"] == r["temperature_unsharded"]
    assert r["temperature"] != r["contiguous"]   # the sampler bites


@pytest.mark.parametrize("variant", ["overlap", "replicated_ep"])
def test_overlap_and_replicated_ep_match(runs, variant):
    want, got = runs
    r = got["qwen2-moe-a2.7b"]
    assert r[variant] == r["contiguous"] == want["qwen2-moe-a2.7b"]


def test_launcher_check_unsharded(runs):
    _, got = runs
    out = got["launcher_stdout"]
    assert "check-unsharded: completions match" in out
    assert "sharded: mesh={'data': 2, 'model': 2} moe path=a2a" in out
    assert out.count("sample:") == 1     # rank 0 alone prints


@pytest.mark.parametrize("flags", [["--sharded"],
                                   ["--sharded", "--paged", "--overlap-a2a"]],
                         ids=["contiguous", "paged-overlap"])
def test_launcher_runs_one_rank_without_torchrun(flags, capsys):
    """Without torchrun's variables ``--sharded`` starts a one-rank gloo
    group, serves on the (1, 1) mesh and ends the group."""
    import torch.distributed as dist
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "qwen2-moe-a2.7b", "--variant", "reduced",
                       "--device", "cpu", "--check-unsharded", *flags])
    out = capsys.readouterr().out
    assert "sharded: mesh={'data': 1, 'model': 1} moe path=dense" in out
    assert "check-unsharded: completions match" in out
    assert not dist.is_initialized()


def test_overlap_ok_gate():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.sharding import rules
    moe_cfg = get_config("qwen2-moe-a2.7b",
                         variant="reduced").replace(overlap_a2a=True)
    dense_cfg = get_config("tinyllama-1.1b",
                           variant="reduced").replace(overlap_a2a=True)
    mesh = rules.abstract_mesh((2, 4), ("data", "model"))
    flat = rules.abstract_mesh((1, 8), ("data", "model"))
    one = rules.abstract_mesh((8, 1), ("data", "model"))
    assert M._overlap_ok(moe_cfg, mesh, 4, None)
    assert M._overlap_ok(moe_cfg, flat, 2, None)
    assert not M._overlap_ok(moe_cfg.replace(overlap_a2a=False), mesh, 4,
                             None)
    assert not M._overlap_ok(dense_cfg, mesh, 4, None)          # not MoE
    assert not M._overlap_ok(moe_cfg, None, 4, None)            # no mesh
    assert not M._overlap_ok(moe_cfg, one, 4, None)             # model == 1
    assert not M._overlap_ok(moe_cfg, mesh, 3, None)            # odd batch
    assert not M._overlap_ok(moe_cfg, mesh, 0, None)            # empty
    assert not M._overlap_ok(moe_cfg, mesh, 4, object())        # paged
    assert not M._overlap_ok(moe_cfg.replace(moe_impl="replicated_ep"),
                             mesh, 4, None)
