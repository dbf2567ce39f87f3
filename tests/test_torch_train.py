"""The port's local-training path against the JAX reference, on the CPU.

Reference with ``use_pallas=True`` (Pallas kernels in interpret mode);
port with ``use_kernels=True`` on CPU tensors (the kernels' plain
versions and the kd_loss blocked backward).  Same weights (converted
between the packages; ``train_device`` starts from the reference's own
init), same numpy batches, f32.  Configurations: reduced
TinyLlama (remat on, a loss chunk that leaves a ragged tail) and the
two device families of ``benchmarks/common.py`` (``gpt2-tiny``: no
positions, tied head, LayerNorm, ungated tanh-GELU MLP; ``llama-tiny``:
RMSNorm, SwiGLU, RoPE, GQA 4:2).

Tolerances: losses and metrics 1e-5 relative; gradients and parameters
1e-5 absolute + 1e-4 relative (f32 sums in other orders through a few
layers; the observed worst differences are ~1e-6).
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.federated import FederatedCorpus as JCorpus
from repro.federated import device as jdev
from repro.models import model as JM
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import schedule as jsched
from repro_torch import convert
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated import device as tdev
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.kd_loss import ops as kd_ops
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update, schedule
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # benchmarks/ is not an installed package
    sys.path.insert(0, str(ROOT))
from benchmarks.common import device_families  # noqa: E402


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


def port_cfg(cfg_j):
    """The port's ModelConfig of a reference config (use_pallas is
    use_kernels in the port)."""
    kw = {f.name: getattr(cfg_j, f.name) for f in dataclasses.fields(cfg_j)}
    kw["use_kernels"] = kw.pop("use_pallas")
    return ModelConfig(**kw)


def _families():
    tiny = jax_config("tinyllama-1.1b", variant="reduced").replace(
        remat=True, loss_chunk=16)
    return {"tinyllama-reduced": tiny,
            **{c.name: c for c in device_families()}}


FAMILIES = _families()


def _convert(pj, cfg):
    return convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)


def _flat(tree):
    return {k: np.asarray(v.detach() if hasattr(v, "detach") else v)
            for k, v in convert.flatten(tree).items()}


def _batch(cfg, B, S, seed, with_mask):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if with_mask:
        b["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


@pytest.mark.parametrize("name,use_kernels,with_mask", [
    ("tinyllama-reduced", True, False), ("gpt2-tiny", True, True),
    ("llama-tiny", True, False), ("gpt2-tiny", False, False)])
def test_loss_fn_and_every_gradient_match_reference(name, use_kernels,
                                                    with_mask):
    cfg_j = FAMILIES[name].replace(use_pallas=use_kernels)
    cfg = port_cfg(cfg_j)
    # the reference runs without remat (the same values at a third of the
    # compile time); the port runs with it where the config asks
    cfg_j = cfg_j.replace(remat=False)
    # the port's init, handed to the reference (JAX's eager init is slow)
    pt = M.init_params(cfg, generator=torch.Generator().manual_seed(3))
    pj = jax.tree.map(jnp.asarray, convert.params_to_jax(pt, cfg))
    b = _batch(cfg, 2, 21, seed=4, with_mask=with_mask)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, {k: jnp.asarray(v)
                                        for k, v in b.items()}),
        has_aux=True))(pj)
    leaves = [p.requires_grad_(True) for p in tree_leaves(pt)]
    lt, mt = M.loss_fn(pt, cfg, {k: torch.as_tensor(v) for k, v in b.items()})
    gt = torch.autograd.grad(lt, leaves)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=RTOL)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(mt[k].item(), float(mj[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    want = _flat(jax.tree.map(np.asarray, gj))
    got = _flat(tree_unflatten_like(pt, list(gt)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def test_adamw_update_matches_reference_with_clip_and_freeze():
    """Three steps, gradients with a global norm far above the clip,
    weight decay, and one frozen leaf (scalar zero moments, unchanged)."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"w": rng.standard_normal((4,)).astype(np.float32),
                    "frozen": rng.standard_normal((2, 2)).astype(np.float32)}}
    mask = {"a": True, "b": {"w": True, "frozen": False}}
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 3
                                     ).astype(np.float32), params)
             for _ in range(3)]
    pj = jax.tree.map(jnp.asarray, params)
    oj = j_adamw_init(pj, freeze_mask=mask)
    pt = jax.tree.map(torch.tensor, params)
    ot = adamw_init(pt, freeze_mask=mask)
    assert ot["m"]["b"]["frozen"].shape == ()
    for s, g in enumerate(grads):
        lr = 1e-2 * (s + 1)
        pj, oj, sj = j_adamw_update(jax.tree.map(jnp.asarray, g), oj, pj,
                                    lr=lr, weight_decay=0.01,
                                    freeze_mask=mask)
        pt, ot, st = adamw_update(jax.tree.map(torch.tensor, g), ot, pt,
                                  lr=lr, weight_decay=0.01, freeze_mask=mask)
        assert float(sj["grad_norm"]) > 1.0   # the clip is active
        np.testing.assert_allclose(float(st["grad_norm"]),
                                   float(sj["grad_norm"]), rtol=RTOL)
        for key in ("params", "m", "v"):
            want = {"params": pj, "m": oj["m"], "v": oj["v"]}[key]
            got = {"params": pt, "m": ot["m"], "v": ot["v"]}[key]
            w, t = _flat(jax.tree.map(np.asarray, want)), _flat(got)
            for k in w:
                np.testing.assert_allclose(t[k], w[k], rtol=1e-6, atol=1e-7,
                                           err_msg=f"{key}/{k} step {s}")
        assert ot["step"] == int(oj["step"]) == s + 1
    np.testing.assert_array_equal(pt["b"]["frozen"].numpy(),
                                  params["b"]["frozen"])


@pytest.mark.parametrize("lr,total,warmup,min_ratio", [
    (3e-3, 4, 1, 0.1), (1e-3, 50, 2, 0.1), (0.02, 37, 5, 0.3)])
def test_cosine_schedule_matches_reference_at_every_step(lr, total, warmup,
                                                         min_ratio):
    fj = jsched.cosine_schedule(lr, total, warmup=warmup, min_ratio=min_ratio)
    ft = schedule.cosine_schedule(lr, total, warmup=warmup,
                                  min_ratio=min_ratio)
    got = [ft(s) for s in range(total + 3)]
    want = [float(fj(s)) for s in range(total + 3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0   # step 0 runs at lr = 0
    lj, lt = jsched.linear_schedule(lr, total, warmup), \
        schedule.linear_schedule(lr, total, warmup)
    np.testing.assert_allclose([lt(s) for s in range(total + 3)],
                               [float(lj(s)) for s in range(total + 3)],
                               rtol=1e-6)
    assert schedule.constant_schedule(lr)(7) == float(
        jsched.constant_schedule(lr)(7))


def test_corpus_batches_and_embeddings_are_bit_identical():
    kw = dict(seed=3, n_devices=5, n_domains=3, vocab=97, alpha=0.3)
    cj, ct = JCorpus.build(**kw), FederatedCorpus.build(**kw)
    np.testing.assert_array_equal(ct.device_domain, cj.device_domain)
    np.testing.assert_array_equal(ct.device_scale, cj.device_scale)

    def same(bt, bj):
        assert set(bt) == set(bj)
        for k in bj:
            assert bt[k].dtype == torch.int32
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))

    for d in range(5):
        same(ct.device_batch(d, 3, 11, step=2), cj.device_batch(d, 3, 11,
                                                                step=2))
        same(ct.device_batches(d, 4, 2, 9, start=1),
             cj.device_batches(d, 4, 2, 9, start=1))
        np.testing.assert_array_equal(ct.device_embedding(d),
                                      cj.device_embedding(d))
    same(ct.mixed_eval_batch(5, 13, seed_salt=4),
         cj.mixed_eval_batch(5, 13, seed_salt=4))
    same(ct.mixed_eval_batches(3, 4, 7, seed_salt0=2),
         cj.mixed_eval_batches(3, 4, 7, seed_salt0=2))
    same(ct.domain_eval_batch(1, 2, 8), cj.domain_eval_batch(1, 2, 8))


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_train_device_matches_reference(name):
    """4 steps, batch 2, seq 48, from the reference's init converted:
    per-step losses, final parameters, embedding and upload bytes."""
    cfg_j = FAMILIES[name].replace(use_pallas=True)
    cfg = port_cfg(cfg_j)
    kw = dict(seed=0, n_devices=3, n_domains=2, vocab=cfg.vocab_size)
    cj, ct = JCorpus.build(**kw), FederatedCorpus.build(**kw)
    seed, dev_id = 1, 2
    run = dict(steps=4, batch=2, seq_len=48, lr=3e-3, seed=seed)
    up_j = jdev.train_device(jdev.DeviceSpec(dev_id, cfg_j, 0, 1), cj, **run)
    init = JM.init_params(jax.random.PRNGKey(seed * 100003 + dev_id), cfg_j)
    up_t = tdev.train_device(tdev.DeviceSpec(dev_id, cfg, 0, 1), ct,
                             device="cpu", params=_convert(init, cfg), **run)
    np.testing.assert_allclose(up_t["losses"], up_j["losses"], rtol=RTOL)
    want = _flat(jax.tree.map(np.asarray, up_j["params"]))
    got = _flat(up_t["params"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    np.testing.assert_array_equal(up_t["embedding"], up_j["embedding"])
    assert up_t["upload_bytes"] == up_j["upload_bytes"]
    assert (up_t["arch_id"], up_t["device_id"]) == (0, dev_id)


def test_model_param_bytes_of_full_tinyllama_match_reference():
    cfg_j = jax_config("tinyllama-1.1b")
    assert tdev.model_param_bytes(port_cfg(cfg_j)) == \
        jdev.model_param_bytes(cfg_j) == 2 * 1_100_048_384


def test_train_fleet_returns_each_devices_upload_in_fleet_order():
    fams = [port_cfg(c) for c in device_families()]
    corpus = FederatedCorpus.build(seed=0, n_devices=3, n_domains=2,
                                   vocab=fams[0].vocab_size)
    fleet = [tdev.DeviceSpec(0, fams[1], 1, 0),
             tdev.DeviceSpec(1, fams[0], 0, 1),
             tdev.DeviceSpec(2, fams[1], 1, 1)]
    run = dict(steps=2, batch=1, seq_len=8, device="cpu")
    ups = tdev.train_fleet(fleet, corpus, **run)
    assert [u["device_id"] for u in ups] == [0, 1, 2]
    assert [u["arch_id"] for u in ups] == [1, 0, 1]
    alone = tdev.train_device(fleet[2], corpus, **run)
    assert ups[2]["losses"] == alone["losses"]


def test_remat_recomputes_each_kernel_once_in_the_backward(monkeypatch):
    """With ``cfg.remat`` every group and every loss chunk runs forward
    again in the backward: one step calls the flash forward 2x per layer
    and the kd_loss forward 2x per chunk.  ``chip_smoke.py`` asserts the
    same counts of kernel launches on the card."""
    calls = {"kd": 0, "flash": 0}
    kd_fwd, fa_ref = kd_ops.kd_loss_fwd, fa_ops.flash_attention_ref

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kd_ops, "kd_loss_fwd", count("kd", kd_fwd))
    monkeypatch.setattr(fa_ops, "flash_attention_ref", count("flash", fa_ref))
    cfg = port_cfg(FAMILIES["tinyllama-reduced"].replace(use_pallas=True))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 2, 40, 0,
                                                  False).items()}
    tdev.train_step(params, opt, cfg, b, 1e-3)
    assert calls == {"kd": 2 * 3, "flash": 2 * cfg.n_layers}


def test_cli_trains_on_the_cpu_and_needs_cuda_by_default(monkeypatch):
    from repro_torch.launch import train
    losses = train.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16"])
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    # a single model ignores --n-hosts (it reaches the fleet only), as in
    # the reference; the production mesh stays refused
    again = train.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "16",
                        "--n-hosts", "2"])
    assert again == losses
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                    "--production-mesh"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "tinyllama-1.1b", "--steps", "1"])


def test_unported_training_options_raise():
    from repro_torch.launch import train
    cfg = port_cfg(FAMILIES["tinyllama-reduced"])
    spec = tdev.DeviceSpec(0, cfg, 0, 0)
    # multi-host fleets are ported (tests/test_torch_fleet_hosts.py); more
    # hosts than ranks is the reference's oversubscription error
    with pytest.raises(ValueError, match="fleet mesh wants 2 hosts"):
        tdev.train_fleet([spec], None, steps=1, batch=1, seq_len=4,
                         n_hosts=2, device="cpu")
    # remat_policy="dots" is ported (tests/test_torch_encdec.py); the
    # production mesh stays refused
    with pytest.raises(NotImplementedError, match="not ported yet"):
        train.parse_args(["--arch", "tinyllama-1.1b", "--production-mesh"])
