"""The federated server, evaluation and OFA-KD on a mesh
(``DeepFusionServer(mesh=)``, ``evaluate_model(mesh=)``,
``ofa_loss(mesh=)``) on 4 CPU ranks, against the JAX reference's on 4
forced host devices.

The reference runs in one subprocess on 4 forced host devices
(``XLA_FLAGS`` must be set before JAX starts, and this process has
started it), XLA's optimizations off, ``use_pallas=False``.  It first
draws every input both packages start from (``jax.random`` at the
reference's keys: the teacher ``device_families()[1]``, the student
base, the VAA module, the MoE's init, two bases to merge, the OFA-KD exit
heads) and writes them out; the port's ``torch.multiprocessing.spawn``
of 4 gloo ranks (rendezvous through a file in the test's temporary
directory) starts on them, on its kernel path (the kernels' plain
versions on CPU tensors), while the reference runs its side.

``benchmarks/common.py``'s reduced MoE (``global_moe_cfg``: 2 layers, 4
experts top-2, one shared expert, capacity factor 1.25) on the meshes
(2, 2) and (1, 4), where ``moe_path`` "auto" is a2a.

Held within ``TOL = 1e-5`` (``tests/test_torch_moe_ep.py``: f32 sums in
another order), each quantity relative to its largest |value| where that
is above 1, on every rank:
- Phase II (``distill_proxy``, 2 steps): losses and every student leaf.
  The student base is dense, so the mesh changes nothing in the
  reference (its ``shard_act`` constraints lay out, they do not compute):
  both meshes' runs are held to its (2, 2) run.
- Phase III (``merge_and_tune`` of the two bases, 3 steps): losses, the
  clip's ``grad_norm`` each step (read inside the reference's compiled
  epoch by a callback), and every leaf of the returned whole parameters,
  of the reference's shapes; the frozen experts bit-equal to the merge.
- Every leaf trainable, on (2, 2), under each moment policy (fp32, bf16,
  int8: the experts' moments cut with them, int8's per-tensor scales the
  whole tensors', held relatively): 2 steps of ``make_tune_epoch`` at
  Phase III's lr.  Each step's gradients and grad norm within TOL; every
  leaf within TOL of its largest change from the merge, beyond the
  bound that the two sides' own gradients put on Adam's steps (Adam
  normalises each gradient element, so an element whose gradients
  nearly cancel carries their f32 noise into an update of up to lr;
  ``_policy_limits``).
- ``evaluate_model`` of the merged MoE on both meshes (every metric) and
  ``ofa_loss`` with the MoE as the student on (2, 2) (loss, metrics and
  the gradient of every leaf).
Readings on this CPU: Phase II 1.8e-7, Phase III 2.6e-7 and 1.7e-7,
evaluation 6.4e-7 and 1.3e-6, OFA-KD 8.9e-8; the policies 0.38 of their
limits (fp32: gradients 3.8e-6), 0.49 (bf16: 1 entry of 65,536 rounded
apart, 0.0039 lr beyond the bound) and 0.51 (int8: 0.0040 lr).  A (1, 4) round trip of ``shard_experts`` and
``gather_experts`` at 3 experts (padded to 4) is the identity.  Drops happen: the a2a path's
capacity (per data shard, factor 1.25, sized as the reference sizes it)
drops assignments in the tune on each mesh.

Planted faults, run on (2, 2), each of which must break its check by
``FAULT_MARGIN`` limits or the run itself: the clip's norm counted per
rank (every leaf's square summed over all ranks; read 0.995), the
moments not cut (``shard_opt_state`` a no-op: the update's shapes
break), int8's scale from the rank's block alone (0.54 of a scale,
54,000 limits), and the experts not gathered back (``gather_experts`` a
no-op: the shapes differ).

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

MESHES = ((2, 2), (1, 4))
POLICIES = ("", "bf16", "int8")
TOL = 1e-5
SEQ, BATCH, TEACHER_ARCH = 48, 4, 1
SERVER = dict(distill_steps=2, distill_batch=BATCH, tune_steps=3,
              tune_batch=BATCH, seq_len=SEQ, n_stages=2, p_q=32, vaa_dim=64,
              seed=0)
# the lr of each step with every leaf trainable (Phase III's, the
# ServerConfig default) and their batches' seed salt
POLICY_LRS = (5e-4, 5e-4)
POLICY_SALT = 20_000
B1, B2, EPS = 0.9, 0.95, 1e-8       # adamw_update's defaults
# a leaf's entries whose bf16 moments rounded apart (``_policy_limits``):
# at most this share of a leaf, each within lr times this beyond the
# Adam bound, as ``tests/test_torch_moments.py`` holds them
STRADDLE_SHARE, STRADDLE_STEP = 1 / 200, 2 ** -7
FAULT_MARGIN = 100.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


_REF_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
jax.config.update("jax_disable_most_optimizations", True)
from repro.core import distill as D, merge, tuning
from repro.core.baselines.ofa_kd import ofa_loss
from repro.data.federated import FederatedCorpus
from repro.federated.server import DeepFusionServer, ServerConfig
from repro.federated.simulation import evaluate_model
from repro.models.config import ModelConfig
from repro.optim import adamw_init
from repro_torch.convert import flatten
sys.path.insert(0, os.path.dirname(sys.argv[2]))
sys.path.insert(0, os.path.dirname(os.path.dirname(sys.argv[2])))
import test_torch_server_mesh as T

inp = T.reference_inputs()
with open(sys.argv[1] + ".part", "wb") as f:
    pickle.dump(inp, f)
os.replace(sys.argv[1] + ".part", sys.argv[1])      # the ranks start here
cfg = ModelConfig(**inp["moe_cfg"]).validate()
fam = [ModelConfig(**c).validate() for c in inp["fam"]]
t_cfg = fam[T.TEACHER_ARCH]
base_cfg = merge.base_config_of(cfg)
scfg = ServerConfig(moe_cfg=cfg, **T.SERVER)
corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                               vocab=cfg.vocab_size)
tree = lambda t: jax.tree.map(jnp.asarray, t)
teacher, student = tree(inp["teacher"]), tree(inp["student"])
bases = [tree(b) for b in inp["bases"]]
heads = tree(inp["heads"])
merged = merge.merge_into_moe(jax.random.PRNGKey(scfg.seed + 303), cfg,
                              bases)
batch = corpus.mixed_eval_batch(T.BATCH, T.SEQ, seed_salt=0)
out = {}

def put(prefix, t):
    for k, v in flatten(jax.tree.map(np.asarray, t)).items():
        out[f"{prefix}/{k}"] = v

put("merged", merged)

# each tune step's clip norm from inside the compiled epochs (the
# server's and the policies'), by the optimizer's step count (a device
# may report a replicated value more than once)
norms, own_step = {}, tuning.make_tune_step

def make_tune_step(*a, **k):
    step = own_step(*a, **k)

    def noted(*args):
        res = step(*args)
        jax.debug.callback(
            lambda i, g: norms.__setitem__(int(i), float(g)),
            res[1]["step"], res[3]["grad_norm"])
        return res
    return noted

def by_step():
    jax.effects_barrier()
    return np.array([norms[i] for i in sorted(norms)])

tuning.make_tune_step = make_tune_step

for shape in T.MESHES:
    k = T._key(shape)
    mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
    srv = DeepFusionServer(scfg, corpus, fam, mesh=mesh)
    if shape == (2, 2):
        s, hist = srv.distill_proxy({"arch": T.TEACHER_ARCH,
                                     "params": teacher, "cluster": 0},
                                    base_cfg, init_params=student)
        out["distill/hist"] = np.array(hist); put("distill/p", s)
    norms.clear()
    p, hist = srv.merge_and_tune(bases)
    out[f"{k}/tune/hist"] = np.array(hist); put(f"{k}/tune/p", p)
    out[f"{k}/tune/gnorm"] = by_step()
    ev = evaluate_model(merged, cfg, corpus, seq_len=T.SEQ, batch=T.BATCH,
                        n_batches=1, mesh=mesh)
    for m, v in ev.items():
        out[f"{k}/eval/{m}"] = np.float64(v)
    if shape != (2, 2):
        continue
    assert set(T.POLICY_LRS) == {scfg.tune_lr}
    every = jax.tree.map(lambda _: True, merged)
    batches = corpus.mixed_eval_batches(len(T.POLICY_LRS), T.BATCH, T.SEQ,
                                        seed_salt0=T.POLICY_SALT)
    # each step's gradients too, by the optimizer's step count
    grads, own_update = {}, tuning.adamw_update

    def recording(g, opt_state, params, **kw):
        jax.debug.callback(lambda i, g: grads.__setitem__(int(i), g),
                           opt_state["step"], g)
        return own_update(g, opt_state, params, **kw)

    for pol in T.POLICIES:
        norms.clear(); grads.clear()
        tuning.adamw_update = recording
        epoch = jax.jit(tuning.make_tune_epoch(
            cfg, every, steps=len(T.POLICY_LRS),
            schedule=lambda s: jnp.asarray(T.POLICY_LRS)[s], mesh=mesh))
        p, opt, _ = epoch(merged, adamw_init(merged, policy=pol), batches)
        tuning.adamw_update = own_update
        out[f"{k}/policy/{pol}/gnorm"] = by_step()
        for i in sorted(grads):
            put(f"{k}/policy/{pol}/g{i}", grads[i])
        put(f"{k}/policy/{pol}/p", p)
        if "v_scale" in opt:
            put(f"{k}/policy/{pol}/vscale", opt["v_scale"])
    t_out = D.teacher_forward(teacher, t_cfg, batch, n_stages=T.SERVER[
        "n_stages"])
    (loss, mets), g = jax.jit(jax.value_and_grad(
        lambda tr: ofa_loss(tr, cfg, teacher, t_cfg, batch, t_out, beta=1.0,
                            temperature=2.0, n_stages=T.SERVER["n_stages"],
                            mesh=mesh), has_aux=True))(
        {"student": merged, "ofa": heads})
    out[f"{k}/ofa/loss"] = np.asarray(loss)
    for m, v in mets.items():
        out[f"{k}/ofa/m/{m}"] = np.asarray(v)
    put(f"{k}/ofa/g", g)
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


class _Faults:
    """The planted faults, each a patch of the port's modules (undone on
    exit)."""

    def __init__(self, fault):
        self.fault, self.undo = fault, []

    def __enter__(self):
        import torch.distributed as dist
        from repro_torch.models import moe, quant
        from repro_torch.sharding import rules

        def patch(mod, name, fn):
            self.undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

        if self.fault == "norm_per_rank":
            patch(moe, "clip_shards", lambda params, cfg, mesh: (
                rules.map_with_paths(lambda p, t: True, params),
                dist.group.WORLD))
        elif self.fault == "moments_not_cut":
            patch(moe, "shard_opt_state", lambda state, cfg, mesh: state)
        elif self.fault == "int8_local_scale":
            own = quant.quantize_v
            patch(quant, "quantize_v", lambda v, group=None: own(v))
        elif self.fault == "not_gathered":
            patch(moe, "gather_experts", lambda params, cfg, mesh: params)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.undo):
            setattr(mod, name, fn)


# what each planted fault runs (on (2, 2)): the part it would break
FAULT_PARTS = {"norm_per_rank": ("tune",), "moments_not_cut": ("policy:",),
               "int8_local_scale": ("policy:int8",),
               "not_gathered": ("tune",)}
PARTS = {(2, 2): ("distill", "tune", "eval", "ofa",
                  *(f"policy:{p}" for p in POLICIES)),
         (1, 4): ("distill", "tune", "eval")}


def _rank_worker(rank, rdzv, inputs_path, out_path):
    """One rank of the port's meshes: every part on both meshes (the
    policies on (2, 2)), then each fault's part on (2, 2); rank 0 writes
    every rank's results."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=4)
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.utils.pytree import tree_leaves
    import time
    while not os.path.exists(inputs_path):   # the reference draws them
        time.sleep(0.2)
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    cfg = ModelConfig(**_port_kw(inp["moe_cfg"])).validate()
    fam = [ModelConfig(**_port_kw(c)).validate() for c in inp["fam"]]
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    meshes = {(2, 2): LM.make_decode_mesh(device="cpu"),
              (1, 4): LM.make_host_mesh(device="cpu")}
    res = {}
    for shape, mesh in meshes.items():
        _port_cases(res, _key(shape), inp, cfg, fam, corpus, mesh,
                    PARTS[shape])
    for fault, parts in FAULT_PARTS.items():
        with _Faults(fault):
            try:
                _port_cases(res, f"fault={fault}", inp, cfg, fam, corpus,
                            meshes[(2, 2)], parts)
            except Exception as e:          # a fault may break a shape
                res[f"fault={fault}/error"] = repr(e)
    # the gather round trip at 3 experts on (1, 4): padded to 4, one a rank
    c3 = cfg.replace(n_experts=3)
    p3 = M.init_params(c3, generator=torch.Generator().manual_seed(3))
    back = moe.gather_experts(moe.shard_experts(p3, c3, meshes[(1, 4)]), c3,
                              meshes[(1, 4)])
    res["roundtrip"] = all(torch.equal(a, b) for a, b in
                           zip(tree_leaves(back), tree_leaves(p3)))
    ranks = [None] * 4
    dist.all_gather_object(ranks, res)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(ranks, f)
    dist.barrier()
    dist.destroy_process_group()


def _port_cases(res, k, inp, cfg, fam, corpus, mesh, parts):
    """The port's side of each of ``parts`` on ``mesh``, under keys the
    reference's results share ("policy:<p>" a moment policy's steps,
    "policy:" the fp32 one)."""
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.core import distill as D
    from repro_torch.core import merge, tuning
    from repro_torch.core.baselines.ofa_kd import ofa_loss
    from repro_torch.federated import device as dev
    from repro_torch.federated import server, simulation
    from repro_torch.models import moe
    from repro_torch.optim import adamw_init
    from repro_torch.utils.pytree import (tree_leaves, tree_map,
                                          tree_unflatten_like)

    def put(prefix, t):
        for p, v in convert.flatten(t).items():
            res[f"{prefix}/{p}"] = v.detach().double().numpy()

    norms, own_update = [], dev.adamw_update

    def noted(*a, **kw):             # each tune step's clip norm
        out = own_update(*a, **kw)
        norms.append(float(out[2]["grad_norm"]))
        return out

    t_cfg = fam[TEACHER_ARCH]
    base_cfg = merge.base_config_of(cfg)
    teacher = convert.params_from_jax(inp["teacher"], t_cfg)
    bases = [convert.params_from_jax(b, base_cfg) for b in inp["bases"]]
    moe_init = convert.params_from_jax(inp["moe_init"], cfg)
    merged = merge.merge_into_moe(None, cfg, bases, params=moe_init)
    mask = tuning.expert_freeze_mask(merged)
    srv = server.DeepFusionServer(server.ServerConfig(moe_cfg=cfg, **SERVER),
                                  corpus, fam, mesh=mesh, device="cpu")
    if "distill" in parts:
        s, hist = srv.distill_proxy(
            {"arch": TEACHER_ARCH, "params": teacher, "cluster": 0},
            base_cfg, init_params=convert.params_from_jax(inp["student"],
                                                          base_cfg),
            vaa_params=convert.vaa_from_jax(inp["vaa"]))
        res[f"{k}/distill/hist"] = np.array(hist)
        put(f"{k}/distill/p", s)
    if "tune" in parts:
        own, dropped = moe.capacity_positions, []

        def counting(flat_e, cap, valid=None):
            pos, keep = own(flat_e, cap, valid=valid)
            dropped.append(int((~keep & valid).sum()))
            return pos, keep

        moe.capacity_positions, dev.adamw_update = counting, noted
        try:
            p, hist = srv.merge_and_tune(bases, init_params=moe_init)
        finally:
            moe.capacity_positions, dev.adamw_update = own, own_update
        res[f"{k}/tune/hist"] = np.array(hist)
        res[f"{k}/tune/gnorm"] = np.array(norms)
        res[f"{k}/dropped"] = sum(dropped)
        put(f"{k}/tune/p", p)
        res[f"{k}/frozen_unchanged"] = all(
            torch.equal(a, b) for a, b, m in zip(
                tree_leaves(p), tree_leaves(merged), tree_leaves(mask))
            if not m)
    every = tree_map(lambda _: True, merged)
    batches = corpus.mixed_eval_batches(len(POLICY_LRS), BATCH, SEQ,
                                        seed_salt0=POLICY_SALT)
    for pol in POLICIES:
        if f"policy:{pol}" not in parts:
            continue
        epoch = tuning.make_tune_epoch(cfg, every, steps=len(POLICY_LRS),
                                       schedule=lambda s: POLICY_LRS[s],
                                       mesh=mesh)
        params = moe.shard_experts(tree_map(torch.clone, merged), cfg, mesh)
        opt = moe.shard_opt_state(adamw_init(merged, policy=pol), cfg, mesh)
        norms.clear()
        step = iter(range(len(POLICY_LRS)))

        def noted_grads(g, *a, **kw):   # each step's whole gradients
            whole = moe.gather_experts(g, cfg, mesh)
            i = next(step)
            if dist.get_rank() == 0:    # the same on every rank
                put(f"{k}/policy/{pol}/g{i}", whole)
            return noted(g, *a, **kw)

        dev.adamw_update = noted_grads
        try:
            params, opt, _ = epoch(params, opt, batches)
        finally:
            dev.adamw_update = own_update
        res[f"{k}/policy/{pol}/gnorm"] = np.array(norms)
        put(f"{k}/policy/{pol}/p", moe.gather_experts(params, cfg, mesh))
        if "v_scale" in opt:
            put(f"{k}/policy/{pol}/vscale", opt["v_scale"])
    if "eval" in parts:
        ev = simulation.evaluate_model(merged, cfg, corpus, seq_len=SEQ,
                                       batch=BATCH, n_batches=1, mesh=mesh)
        for m, v in ev.items():
            res[f"{k}/eval/{m}"] = np.float64(v)
    if "ofa" in parts:
        batch = corpus.mixed_eval_batch(BATCH, SEQ, seed_salt=0)
        t_out = D.teacher_forward(teacher, t_cfg, batch,
                                  n_stages=SERVER["n_stages"])
        trainable = {"student": moe.shard_experts(
            tree_map(torch.clone, merged), cfg, mesh),
            "ofa": {n: torch.tensor(np.asarray(v))
                    for n, v in inp["heads"].items()}}
        leaves = [t.requires_grad_(True) for t in tree_leaves(trainable)]
        loss, mets = ofa_loss(trainable, cfg, teacher, t_cfg, batch, t_out,
                              beta=1.0, temperature=2.0,
                              n_stages=SERVER["n_stages"], mesh=mesh)
        g = tree_unflatten_like(trainable, torch.autograd.grad(loss, leaves))
        g["student"] = moe.gather_experts(g["student"], cfg, mesh)
        res[f"{k}/ofa/loss"] = loss.detach().double().numpy()
        for m, v in mets.items():
            res[f"{k}/ofa/m/{m}"] = v.detach().double().numpy()
        put(f"{k}/ofa/g", g)


def _err(a, b, relative=False):
    """The largest |a - b| over the scale of b: its largest |value| where
    that is above 1 (or always, ``relative``), else 1 (inf if the shapes
    differ)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    scale = np.abs(b).max()
    return float(np.abs(a - b).max() / (max(scale, 1e-300) if relative
                                        else max(scale, 1.0)))


def reference_inputs():
    """Every draw both packages start from, the reference's (``jax.random``
    at its keys) as numpy trees, and the reference's configs' fields."""
    import dataclasses

    import jax
    from benchmarks.common import device_families, global_moe_cfg
    from repro.core import merge as jmerge
    from repro.core import vaa as jvaa
    from repro.core.baselines import ofa_kd as jofa
    from repro.models import model as JM
    from repro_torch import convert

    def kw(c):
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}

    def draw(fn, seed, *a, **k):
        return convert.unflatten(convert.flatten(jax.tree.map(
            np.asarray, fn(jax.random.PRNGKey(seed), *a, **k))))

    cfg, fam = global_moe_cfg(), device_families()
    base_cfg = jmerge.base_config_of(cfg)
    t_cfg, seed = fam[TEACHER_ARCH], SERVER["seed"]
    return {"moe_cfg": kw(cfg), "fam": [kw(c) for c in fam],
            "teacher": draw(JM.init_params, 7, t_cfg),
            "student": draw(JM.init_params, seed + 101, base_cfg),
            "vaa": draw(jvaa.init_vaa, seed + 202,
                        n_stages=SERVER["n_stages"],
                        d_student=base_cfg.d_model, d_teacher=t_cfg.d_model,
                        d=SERVER["vaa_dim"], p_q=SERVER["p_q"]),
            "moe_init": draw(JM.init_params, seed + 303, cfg),
            "bases": [draw(JM.init_params, 50 + i, base_cfg)
                      for i in range(2)],
            "heads": draw(jofa.init_ofa_heads, 505,
                          n_stages=SERVER["n_stages"],
                          d_student=cfg.d_model, vocab=cfg.vocab_size)}


@pytest.fixture(scope="module")
def results():
    """(reference, every rank's) results: the JAX subprocess draws the
    inputs, and the ranks start on them while it runs its side."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        in_path, ref_path, port_path = (
            os.path.join(tmp, f"{n}.pkl") for n in ("in", "ref", "port"))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src"),
             env.get("PYTHONPATH", "")])
        env.pop("XLA_FLAGS", None)
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, in_path,
             os.path.abspath(__file__), ref_path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        ranks = mp.spawn(_rank_worker, args=(os.path.join(tmp, "rdzv"),
                                             in_path, port_path), nprocs=4,
                         join=False)
        try:
            while not ranks.join(timeout=1):
                if ref.poll() not in (None, 0):
                    break           # the ranks would wait for its inputs
        finally:
            for p in ranks.processes:
                if p.is_alive():
                    p.terminate()
            stdout, stderr = ref.communicate(timeout=600)
        assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        with open(ref_path, "rb") as f:
            want = pickle.load(f)
        with open(port_path, "rb") as f:
            got = pickle.load(f)
        yield want, got


def _port_kw(kw):
    """The port's config of a reference config's fields, on its kernel
    path (the kernels' plain versions on CPU tensors)."""
    kw = dict(kw)
    kw.pop("use_pallas")
    return dict(kw, use_kernels=True)


def _worst(want, ranks, prefix, port_prefix=None):
    """The largest error over every rank and the reference's keys under
    ``prefix`` (inf where a rank lacks one or its shape differs); int8's
    scales relative."""
    keys = [k for k in want if k.startswith(prefix + "/")]
    assert keys, prefix
    port_prefix = port_prefix or prefix
    worst = 0.0
    for got in ranks:
        for k in keys:
            kp = port_prefix + k[len(prefix):]
            worst = max(worst, _err(got[kp], want[k], "/vscale/" in k)
                        if kp in got else float("inf"))
    return worst


@pytest.mark.parametrize("shape,case", [
    (shape, case) for shape in MESHES for case in PARTS[shape]
    if not case.startswith("policy")], ids=lambda v: _key(v) if isinstance(
        v, tuple) else v)
def test_server_mesh_matches_reference(results, shape, case):
    """Phase II's student base is dense, so the mesh changes nothing in
    the reference's (its ``shard_act`` constraints lay out, not compute):
    both meshes' distillations are held to its (2, 2) run.  OFA-KD's MoE
    student runs on (2, 2)."""
    want, ranks = results
    k = _key(shape)
    assert _worst(want, ranks, case if case == "distill" else f"{k}/{case}",
                  f"{k}/{case}") < TOL
    if case == "tune":
        assert all(got[f"{k}/frozen_unchanged"] for got in ranks)
        assert len(want[f"{k}/tune/gnorm"]) == SERVER["tune_steps"]


def _leaves(res, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in res.items() if k.startswith(prefix + "/")}


def _adam_directions(grads, policy):
    """``m̂ / (√v̂ + eps)`` of every step and leaf, in f64 from one side's
    gradients (a list over steps of {path: array}): clipped at norm 1.0
    over all leaves as ``adamw_update`` does, the moments stored between
    steps as the policy stores them (bf16, int8 ``v`` through
    ``quantize_v``)."""
    from repro_torch.models import quant
    from repro_torch.optim.adamw import resolve_moment_policy
    pol = resolve_moment_policy(policy)

    def stored(x, dtype, v=False):
        t = torch.from_numpy(x)
        if v and pol.v_quantized:
            return quant.dequantize_v(*quant.quantize_v(t.float())).double()
        return t.to(dtype).double()

    m = {k: np.zeros(()) for k in grads[0]}
    v = dict(m)
    out = []
    for s, g in enumerate(grads, start=1):
        norm = np.sqrt(sum(np.sum(np.square(x)) for x in g.values()))
        scale = min(1.0, 1.0 / max(norm, 1e-9))
        u = {}
        for k, x in g.items():
            x = np.asarray(x, np.float64) * scale
            m_new = B1 * m[k] + (1 - B1) * x
            v_new = B2 * v[k] + (1 - B2) * np.square(x)
            u[k] = (m_new / (1 - B1 ** s)) / (
                np.sqrt(v_new / (1 - B2 ** s)) + EPS)
            m[k] = stored(m_new, pol.m_storage()).numpy()
            v[k] = stored(v_new, pol.v_storage(), v=True).numpy()
        out.append(u)
    return out


def _policy_limits(want, ranks, policy, got_prefix):
    """Every leaf trainable under ``policy`` on (2, 2) against the
    reference's, as the largest error over its limit (so at most 1
    passes):
    - each step's gradient of every leaf (rank 0's, gathered) over that
      leaf's largest |value|, and the clip's norm, within TOL;
    - every leaf's distance to the reference's beyond ``Σ_s lr_s ·
      |Δ(m̂/(√v̂+eps))|`` from the two sides' own gradients
      (``_adam_directions``) and an f32 rounding of the leaf a step, over
      the leaf's largest change from the merge, within TOL.  Adam divides
      each gradient element by its own size, so where gradients nearly
      cancel their f32 noise becomes a relative error of the step; the
      bound widens there, and only there;
    - bf16 and int8 store m (and bf16 v) in bf16: where the two sides'
      f32 moments, some ulps apart, sat on either side of a bf16 rounding
      boundary, the next step differs by up to 2^-8 of itself
      (``tests/test_torch_moments.py``).  At most STRADDLE_SHARE of a
      leaf's entries may miss the limit above, each within
      ``lr · STRADDLE_STEP`` beyond the bound;
    - int8's per-tensor scales (the whole tensors') relative, within TOL.
    """
    k = f"2x2/policy/{policy}"
    steps = range(len(POLICY_LRS))
    g_ref = [_leaves(want, f"{k}/g{s}") for s in steps]
    g_port = [_leaves(ranks[0], f"{got_prefix}/g{s}") for s in steps]
    if any(set(a) != set(b) or not a for a, b in zip(g_port, g_ref)):
        return float("inf")
    worst = max(_err(g_port[s][n], g_ref[s][n], relative=True)
                for s in steps for n in g_ref[s]) / TOL
    worst = max([worst] + [_err(got.get(f"{got_prefix}/gnorm", np.inf),
                                want[f"{k}/gnorm"]) / TOL for got in ranks])
    if policy == "int8":
        worst = max(worst, _worst(want, ranks, f"{k}/vscale",
                                  f"{got_prefix}/vscale") / TOL)
    u_ref = _adam_directions(g_ref, policy)
    u_port = _adam_directions(g_port, policy)
    p0 = _leaves(want, "merged")
    share = STRADDLE_SHARE if policy else 0.0
    for n, w in _leaves(want, f"{k}/p").items():
        bound = sum(lr * np.abs(u_port[s][n] - u_ref[s][n])
                    for s, lr in zip(steps, POLICY_LRS)) + len(steps) * \
            np.spacing(np.abs(w).astype(np.float32))
        size = np.abs(w - p0[n]).max()
        for got in ranks:
            a = got.get(f"{got_prefix}/p/{n}")
            if a is None or a.shape != w.shape:
                return float("inf")
            excess = np.abs(a - w) - bound
            off = excess > TOL * size
            worst = max(worst, excess[~off].max(initial=0) / (TOL * size))
            if off.any():
                worst = max(worst, off.sum() / (share * w.size), float(
                    excess[off].max() / (max(POLICY_LRS) * STRADDLE_STEP)))
    return worst


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: p or "fp32")
def test_every_leaf_trained_under_each_moment_policy(results, policy):
    """Every leaf trainable at Phase III's lr, so the experts' moments are
    cut too (``_policy_limits``)."""
    want, ranks = results
    assert _policy_limits(want, ranks, policy, f"2x2/policy/{policy}") < 1


def test_gather_round_trip_with_padding(results):
    _, ranks = results
    assert all(got["roundtrip"] for got in ranks)


@pytest.mark.parametrize("shape", MESHES, ids=_key)
def test_drops_happen(results, shape):
    """The mesh tune drops assignments (capacity per data shard at
    factor 1.25, sized as the reference sizes it), counted where the a2a
    path ranks them on each rank; the tune matches the reference's."""
    want, ranks = results
    k = _key(shape)
    assert sum(got[f"{k}/dropped"] for got in ranks) > 0
    assert _worst(want, ranks, f"{k}/tune") < TOL


@pytest.mark.parametrize("fault", list(FAULT_PARTS))
def test_planted_faults_break_it(results, fault):
    """Each fault breaks its part's check by FAULT_MARGIN limits, or the
    run itself."""
    want, ranks = results
    if any(f"fault={fault}/error" in got for got in ranks):
        assert all(f"fault={fault}/error" in got for got in ranks)
        return
    worst = 0.0                     # in limits
    for part in FAULT_PARTS[fault]:
        if part.startswith("policy:"):
            pol = part[len("policy:"):]
            worst = max(worst, _policy_limits(want, ranks, pol,
                                              f"fault={fault}/policy/{pol}"))
        else:
            worst = max(worst, _worst(want, ranks, f"2x2/{part}",
                                      f"fault={fault}/{part}") / TOL)
    assert worst > FAULT_MARGIN, (fault, worst)

