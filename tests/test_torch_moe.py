"""Phase III of the port (MoE family, merge, frozen-expert tuning)
against the JAX reference, on the CPU.

Reduced ``qwen2-moe-a2.7b`` (4 experts, top-2, ``moe_d_ff`` 128, one
shared expert), f32.  The reference runs with ``use_pallas=False`` (the
dropless all-experts path; its Pallas dispatch kernel needs
``pl.load``/``pl.store``, which the installed JAX lacks).  The port runs
both its plain path (``use_kernels=False``) and its kernel path on CPU
tensors (the kernels' plain versions through ``moe_ffn``'s capacity
buffers): at top-2 of 4 experts the capacity max(ceil(T·k/E)·2, 8) ≥ T
holds every assignment, so nothing drops and both paths compute the
same function.  Same weights (converted between the packages), same
numpy batches.

Tolerances: losses and metrics 1e-5 relative; gradients and parameters
1e-5 absolute + 1e-4 relative (f32 sums in other orders through a few
layers); merged leaves and masks exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import merge as jmerge
from repro.core import tuning as jtuning
from repro.data.federated import FederatedCorpus as JCorpus
from repro.federated import server as jserver
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import merge, tuning
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated import server
from repro_torch.kernels.moe_dispatch import ops as dis_ops
from repro_torch.kernels.moe_gemm import ops as gemm_ops
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import cosine_schedule
from repro_torch.serve import PagedServeEngine, ServeEngine
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one thread a test process, so that parallel test workers do not
    # oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(atol=1e-5, rtol=1e-4)
RTOL = 1e-5


def port_cfg(cfg_j, **kw):
    """The port's ModelConfig of a reference config (use_pallas is
    use_kernels in the port)."""
    fields = {f.name: getattr(cfg_j, f.name)
              for f in dataclasses.fields(cfg_j)}
    fields["use_kernels"] = fields.pop("use_pallas")
    fields.update(kw)
    return ModelConfig(**fields)


def _jcfg():
    return jax_config("qwen2-moe-a2.7b", variant="reduced")


def _to_jax(pt, cfg):
    return jax.tree.map(jnp.asarray, convert.params_to_jax(pt, cfg))


def _to_port(pj, cfg):
    return convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)


def _flat(tree):
    return {k: np.asarray(v.detach() if hasattr(v, "detach") else v)
            for k, v in convert.flatten(tree).items()}


def _assert_trees_close(got, want, **tol):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_config_and_reduced_match_reference():
    for variant in ("full", "reduced"):
        cj = jax_config("qwen2-moe-a2.7b", variant=variant)
        assert get_config("qwen2-moe-a2.7b", variant=variant) == port_cfg(
            cj, use_kernels=True)
    red = get_config("qwen2-moe-a2.7b", variant="reduced")
    assert (red.n_experts, red.top_k, red.moe_d_ff) == (4, 2, 128)


@pytest.fixture(scope="module")
def moe_params():
    cfg = port_cfg(_jcfg())
    pt = M.init_params(cfg, generator=torch.Generator().manual_seed(3))
    return cfg, pt, _to_jax(pt, cfg)


def _x(cfg, B=2, S=12, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def test_route_matches_reference(moe_params):
    cfg, pt, pj = moe_params
    p_t = {k: v[1] for k, v in pt["blocks"]["sub0"]["moe"].items()
           if k != "shared"}
    p_j = {k: v[1] for k, v in pj["blocks"]["sub0"]["moe"].items()
           if k != "shared"}
    xt = _x(cfg).reshape(-1, cfg.d_model)
    wj, ij, aj = jmoe.route(p_j, _jcfg(), jnp.asarray(xt))
    wt, it, at = moe.route(p_t, cfg, torch.as_tensor(xt))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    np.testing.assert_allclose(at.item(), float(aj), rtol=RTOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_dense_matches_reference(moe_params, use_kernels):
    cfg, pt, pj = moe_params
    p_t = M._layer(pt["blocks"]["sub0"]["moe"], 0)
    p_j = jax.tree.map(lambda a: a[0], pj["blocks"]["sub0"]["moe"])
    x = _x(cfg, seed=5)
    oj, aj = jmoe.moe_dense(p_j, _jcfg(), jnp.asarray(x))
    ot, at = moe.moe_dense(p_t, cfg.replace(use_kernels=use_kernels),
                           torch.as_tensor(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_allclose(at.item(), float(aj), rtol=RTOL)


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


@pytest.mark.parametrize("use_kernels,remat", [(False, False), (True, True)])
def test_loss_fn_and_every_gradient_match_reference(moe_params, use_kernels,
                                                    remat):
    cfg, pt, pj = moe_params
    cfg = cfg.replace(use_kernels=use_kernels, remat=remat, loss_chunk=16)
    b = _batch(cfg, 2, 21, seed=6)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, _jcfg().replace(loss_chunk=16),
                             {k: jnp.asarray(v) for k, v in b.items()}),
        has_aux=True))(pj)
    pt = jax.tree.map(lambda t: t, pt)
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(pt)]
    pt = tree_unflatten_like(pt, leaves)
    lt, mt = M.loss_fn(pt, cfg, {k: torch.as_tensor(v) for k, v in b.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    assert float(mj["aux_loss"]) > 0
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    _assert_trees_close(tree_unflatten_like(pt, list(gt)),
                        jax.tree.map(np.asarray, gj), **TOL)


def _bases(base_cfg, K, seed0=20):
    return [M.init_params(base_cfg,
                          generator=torch.Generator().manual_seed(seed0 + i))
            for i in range(K)]


@pytest.mark.parametrize("K", [1, 3])
def test_merge_into_moe_matches_reference_leaf_by_leaf(K):
    cfg_j = _jcfg()
    cfg = port_cfg(cfg_j)
    base_j = jmerge.base_config_of(cfg_j)
    base = merge.base_config_of(cfg)
    assert base == port_cfg(base_j)
    bases = _bases(base, K)
    key = jax.random.PRNGKey(7)
    want = jmerge.merge_into_moe(key, cfg_j, [_to_jax(b, base) for b in bases])
    init = _to_port(JM.init_params(key, cfg_j), cfg)
    init_copy = _flat(init)
    got = merge.merge_into_moe(None, cfg, bases, params=init)
    _assert_trees_close(got, jax.tree.map(np.asarray, want), rtol=0, atol=0)
    # the caller's init and the base models are left as they were, and the
    # merged model shares no storage with them
    for k, v in _flat(init).items():
        np.testing.assert_array_equal(v, init_copy[k])
    ptrs = {t.data_ptr() for b in bases + [init] for t in tree_leaves(b)}
    assert not ptrs & {t.data_ptr() for t in tree_leaves(got)}
    # round-robin expert copies
    wg = got["blocks"]["sub0"]["moe"]["wi_gate"]
    for e in range(cfg.n_experts):
        assert torch.equal(wg[:, e],
                           bases[e % K]["blocks"]["sub0"]["mlp"]["wi_gate"])


def test_freeze_mask_and_trainable_fraction_match_reference(moe_params):
    cfg, pt, pj = moe_params
    mj = jtuning.expert_freeze_mask(pj)
    mt = tuning.expert_freeze_mask(pt)
    frozen_j = {k for k, v in convert.flatten(jax.tree.map(
        lambda m: m, mj, is_leaf=lambda m: isinstance(m, bool))).items()
        if not v}
    frozen_t = {k for k, v in convert.flatten(mt).items() if not v}
    assert frozen_t == frozen_j
    assert {k.split("/", 3)[-1] for k in frozen_t} == {
        "wi_gate", "wi_up", "wo", "shared/wi_gate", "shared/wi_up",
        "shared/wo"}
    assert tuning.trainable_fraction(pt) == jtuning.trainable_fraction(pj)


def _corpus_pair(cfg):
    kw = dict(seed=1, n_devices=4, n_domains=2, vocab=cfg.vocab_size)
    return JCorpus.build(**kw), FederatedCorpus.build(**kw)


TUNE_KW = dict(tune_steps=3, tune_batch=2, seq_len=16, tune_lr=5e-3, seed=2)
B1, B2, EPS = 0.9, 0.95, 1e-8


def _adam_directions(grads):
    """``m̂ / (√v̂ + eps)`` of every step, in f64 from one side's raw
    gradients (a list over steps of {path: array}), clipped at norm 1.0
    over all leaves as ``adamw_update`` does."""
    m = {k: 0.0 for k in grads[0]}
    v = {k: 0.0 for k in grads[0]}
    out = []
    for s, g in enumerate(grads, start=1):
        g = {k: np.asarray(x, np.float64) for k, x in g.items()}
        norm = np.sqrt(sum(np.sum(x * x) for x in g.values()))
        scale = min(1.0, 1.0 / max(norm, 1e-9))
        u = {}
        for k, x in g.items():
            m[k] = B1 * m[k] + (1 - B1) * x * scale
            v[k] = B2 * v[k] + (1 - B2) * np.square(x * scale)
            u[k] = (m[k] / (1 - B1 ** s)) / (
                np.sqrt(v[k] / (1 - B2 ** s)) + EPS)
        out.append(u)
    return out


@pytest.fixture(scope="module")
def tune_reference():
    """The reference's ``merge_and_tune`` and, for the bound, its steps
    replayed one at a time (jitted gradient, ``adamw_update``): every
    leaf's gradient along its own trajectory."""
    from repro.optim import adamw_update as jadamw
    from repro.optim import cosine_schedule as jcosine
    cfg_j = _jcfg()
    base = merge.base_config_of(port_cfg(cfg_j))
    bases_j = [_to_jax(b, base) for b in _bases(base, 2)]
    jc, _ = _corpus_pair(port_cfg(cfg_j))
    jsrv = jserver.DeepFusionServer(jserver.ServerConfig(cfg_j, **TUNE_KW),
                                    jc, [])
    pj, hj = jsrv.merge_and_tune(bases_j)
    moe_j = jmerge.merge_into_moe(jax.random.PRNGKey(TUNE_KW["seed"] + 303),
                                  cfg_j, bases_j)
    mask, opt = jtuning.init_tuning(moe_j)
    steps = TUNE_KW["tune_steps"]
    sched = jcosine(TUNE_KW["tune_lr"], steps, warmup=1)
    grad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, cfg_j, b)[0]))
    batches = jc.mixed_eval_batches(steps, TUNE_KW["tune_batch"],
                                    TUNE_KW["seq_len"], seed_salt0=10_000)
    grads = []
    for s in range(steps):
        g = grad(moe_j, {k: v[s] for k, v in batches.items()})
        grads.append(_flat(jax.tree.map(np.asarray, g)))
        moe_j, opt, _ = jadamw(g, opt, moe_j, lr=sched(s),
                               weight_decay=0.01, freeze_mask=mask)
    return {"params": _flat(jax.tree.map(np.asarray, pj)), "hist": hj,
            "fraction": jsrv.report["trainable_fraction"], "grads": grads}


def _no_bias_correction(update):
    """A planted fault: AdamW as if at step 10^6, so c1 = c2 = 1."""
    def faulty(grads, state, params, **kw):
        state["step"] += 10 ** 6
        out = update(grads, state, params, **kw)
        state["step"] -= 10 ** 6
        return out
    return faulty


def _clip_without_frozen(update):
    """A planted fault: the clip norm leaves the frozen experts out."""
    def faulty(grads, state, params, *, freeze_mask=None, **kw):
        grads = tree_unflatten_like(grads, [
            g if t else torch.zeros_like(g) for g, t in
            zip(tree_leaves(grads), tree_leaves(freeze_mask))])
        return update(grads, state, params, freeze_mask=freeze_mask, **kw)
    return faulty


def _tune_and_compare(ref, use_kernels, fault=None):
    """The port's ``merge_and_tune`` from the same merge, held to the
    reference: the loss history 1e-5 relative; every step's gradient of
    every leaf at ``TOL`` (each side on its own trajectory); every final
    parameter within ``TOL`` plus ``lr_s · Σ_s |Δ(m̂/(√v̂+eps))|`` from
    the two sides' own gradients.  Adam divides a gradient by its own
    scale, so an element whose gradients nearly cancel (an embedding row
    first met at the last step, |g| 3e-6) turns their f32 noise into a
    relative error of the step itself: the bound widens there, and only
    there.  The frozen experts stay the merge's, bit for bit."""
    cfg = port_cfg(_jcfg(), use_kernels=use_kernels)
    base = merge.base_config_of(cfg)
    bases = _bases(base, 2)
    _, tc = _corpus_pair(cfg)
    init = _to_port(JM.init_params(jax.random.PRNGKey(TUNE_KW["seed"] + 303),
                                   _jcfg()), cfg)
    grads = []
    from repro_torch.federated import device as dev_mod
    update = dev_mod.adamw_update if fault is None else fault(
        dev_mod.adamw_update)

    def recording(g, *a, **kw):
        grads.append({k: x.detach().numpy().copy()
                      for k, x in convert.flatten(g).items()})
        return update(g, *a, **kw)

    srv = server.DeepFusionServer(server.ServerConfig(cfg, **TUNE_KW), tc,
                                  [], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dev_mod, "adamw_update", recording)
        pt, ht = srv.merge_and_tune(bases, init_params=init)
    np.testing.assert_allclose(ht, ref["hist"], rtol=RTOL)
    assert srv.report["trainable_fraction"] == ref["fraction"]
    assert len(grads) == len(ref["grads"])
    for gt, gj in zip(grads, ref["grads"]):
        for k in gj:
            np.testing.assert_allclose(gt[k], gj[k], err_msg=k, **TOL)
    sched = cosine_schedule(TUNE_KW["tune_lr"], TUNE_KW["tune_steps"],
                            warmup=1)
    ut, uj = _adam_directions(grads), _adam_directions(ref["grads"])
    mask = convert.flatten(tuning.expert_freeze_mask(pt))
    got = _flat(pt)
    assert set(got) == set(ref["params"])
    for k, want in ref["params"].items():
        if not mask[k]:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
            continue
        bound = sum(sched(s) * np.abs(ut[s][k] - uj[s][k])
                    for s in range(len(ut)))
        excess = np.abs(got[k] - want) - (TOL["atol"] + TOL["rtol"] *
                                          np.abs(want) + bound)
        assert excess.max() <= 0, (k, float(excess.max()))
    return cfg, bases, init, pt


@pytest.mark.parametrize("use_kernels", [False, True])
def test_merge_and_tune_matches_reference(tune_reference, use_kernels):
    """3 tuning steps from the same merge: the loss history, every
    step's gradients and every final parameter (``_tune_and_compare``).
    The clip norm covers the frozen experts, so a port that left them
    out of the gradient would drift here."""
    cfg, bases, init, pt = _tune_and_compare(tune_reference, use_kernels)
    # frozen experts are exactly the merge's; trainable leaves moved
    merged = merge.merge_into_moe(None, cfg, bases, params=init)
    mask = tuning.expert_freeze_mask(pt)
    for (k, a), b, m in zip(convert.flatten(pt).items(),
                            tree_leaves(merged), tree_leaves(mask)):
        assert torch.equal(a, b) != m, k


@pytest.mark.parametrize("fault", [_no_bias_correction, _clip_without_frozen])
def test_merge_and_tune_bound_catches_a_planted_fault(tune_reference, fault):
    with pytest.raises(AssertionError):
        _tune_and_compare(tune_reference, False, fault=fault)


def test_merge_and_tune_default_init_and_on_step():
    cfg = get_config("qwen2-moe-a2.7b", variant="reduced")
    base = merge.base_config_of(cfg)
    _, tc = _corpus_pair(cfg)
    seen = []
    srv = server.DeepFusionServer(
        server.ServerConfig(cfg, tune_steps=2, tune_batch=2, seq_len=8), tc,
        [], device="cpu", on_step=lambda s, loss: seen.append(s))
    _, hist = srv.merge_and_tune(_bases(base, 2))
    assert seen == [0, 1] and len(hist) == 2
    assert all(np.isfinite(hist))


def test_moe_ffn_sums_exactly_the_kept_assignments():
    """With a router biased onto expert 0 past its capacity, ``moe_ffn``
    is the sum over the assignments ``capacity_positions`` keeps of the
    routing weight times that expert's FFN, and the dropped ones add
    nothing (f32, 1e-5 + 1e-5 relative)."""
    g = torch.Generator().manual_seed(3)
    T, E, k, D, Fh = 40, 8, 2, 8, 12
    logits = torch.randn(T, E, generator=g)
    logits[:, 0] += 4.0
    w, idx = torch.softmax(logits, -1).topk(k, -1)
    w = w / w.sum(-1, keepdim=True)
    xt = torch.randn(T, D, generator=g)
    wg, wu = (torch.randn(E, D, Fh, generator=g) / D ** 0.5 for _ in "gu")
    wo = torch.randn(E, Fh, D, generator=g) / Fh ** 0.5
    _, keep = dis_ops.capacity_positions(idx.reshape(-1),
                                         max(-(-T * k // E) * 2, 8))
    keep = keep.reshape(T, k)
    assert not keep.all()
    want = torch.zeros(T, D)
    for t in range(T):
        for j in range(k):
            if keep[t, j]:
                e = idx[t, j]
                h = torch.nn.functional.silu(xt[t] @ wg[e]) * (xt[t] @ wu[e])
                want[t] += w[t, j] * (h @ wo[e])
    got = gemm_ops.moe_ffn(xt, w, idx, wg, wu, wo)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_train_launcher_runs_the_moe_on_the_cpu():
    from repro_torch.launch import train
    losses = train.main(["--arch", "qwen2-moe-a2.7b", "--variant",
                         "reduced", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "16"])
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_convert_round_trips_moe_leaves(moe_params):
    cfg, pt, pj = moe_params
    back = _to_port(pj, cfg)
    for k, v in convert.flatten(pt).items():
        assert torch.equal(convert.flatten(back)[k], v), k
    assert convert.flatten(back)["blocks/sub0/moe/router"].dtype == \
        torch.float32
    bad = dict(convert.flatten(jax.tree.map(np.asarray, pj)))
    bad["blocks/sub0/moe/wi_gate"] = bad["blocks/sub0/moe/wi_gate"][:, :3]
    with pytest.raises(ValueError, match="wi_gate"):
        convert.params_from_jax(convert.unflatten(bad), cfg)


# the expert-parallel paths are ported (tests/test_torch_moe_ep.py): their
# cases hold that they run over a mesh only; a mesh behind the federated
# server is ported too (tests/test_torch_server_mesh.py), and the mesh
# case holds what stays refused, the multi-pod ("pod", "data") axes
@pytest.mark.parametrize("what", ["a2a", "replicated_ep", "mesh"])
def test_unported_moe_paths_raise(moe_params, what):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    cfg, pt, _ = moe_params
    p = M._layer(pt["blocks"]["sub0"]["moe"], 0)
    x = torch.zeros((1, 2, cfg.d_model))
    if what in ("a2a", "replicated_ep"):
        with pytest.raises(ValueError, match="runs over a mesh"):
            moe.apply_moe(p, cfg.replace(moe_impl=what), x)
        return
    # one gloo rank over an in-process store, its mesh with a "pod" axis
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        pods = init_device_mesh("cpu", (1, 1, 1),
                                mesh_dim_names=("pod", "data", "model"))
        with pytest.raises(NotImplementedError, match="multi-pod"):
            moe.apply_moe(p, cfg.replace(moe_impl="a2a"), x, pods)
    finally:
        dist.destroy_process_group()
