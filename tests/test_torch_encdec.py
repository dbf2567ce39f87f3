"""Whisper (the encoder-decoder family) and ``remat_policy="dots"`` in the
port against the JAX reference, on the CPU.

Reduced ``whisper-small`` (``models.config.reduced``: 2 encoder and 2
decoder layers, d_model 128, 4 heads of 32, LayerNorm, ungated GELU,
sinusoidal positions, the tied head, 16 stub frames), f32, the
reference's weights converted, held to ``TOL`` (1e-4 absolute and
relative, as ``tests/test_torch_model.py``).  The reference's kernel
path runs its Pallas kernels interpreted (``use_pallas=True``: the
encoder through flash attention with ``causal=False``), its plain path
with ``use_pallas=False``; the port runs the matching path (the
kernels' plain versions on CPU tensors).

* the config equals the reference's, the init tree is the reference's
  and ``convert`` round-trips it bit for bit;
* forward logits on both paths; zeroed frames must break the check, and
  a change in the last frame reaches the first decoder position's
  logits only through the bidirectional encoder;
* ``loss_fn``'s loss, metrics and every gradient with remat off, full
  and ``dots``, on both paths;
* ``dots`` keeps the outputs of the products without batch dims: a
  (B, S, D) @ (D, F) product dispatches to ``aten.mm``; a checkpointed
  function's backward under ``dots`` recomputes none of its products
  where full remat recomputes them; the whole model recomputes fewer
  under ``dots`` than under full remat (only the decoder's, which the
  reference checkpoints whatever the policy), with equal gradients;
* the train launcher's ``make_batch`` gives the reference's shapes and
  dtypes, and ``launch.train`` takes 2 steps on reduced
  ``paligemma-3b`` and ``whisper-small``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.launch import train as jax_train
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.federated import FederatedCorpus
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M

from test_torch_simulation import fast_reference_compiles

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-small"


@pytest.fixture(autouse=True, scope="module")
def _fast_reference():
    with fast_reference_compiles():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def models():
    if not _MODELS:
        cfg_j = jax_config(ARCH, variant="reduced")
        cfg = get_config(ARCH, variant="reduced")
        pj = JM.init_params(jax.random.PRNGKey(7), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS["m"] = (cfg_j, pj, cfg, pt)
    return _MODELS["m"]


def _paths(use_kernels):
    """The reference's and the port's configs of one path."""
    cfg_j, _, cfg, _ = models()
    return (cfg_j.replace(use_pallas=use_kernels),
            cfg.replace(use_kernels=use_kernels))


def _batch(cfg, B=2, S=24, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
              * 0.05).astype(np.float32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "frames": frames}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _inputs(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _logits_j(pj, cfg_j, batch):
    hj = JM.backbone(pj, cfg_j, _jax(_inputs(batch)))[0]
    return np.asarray(JM._head(pj, cfg_j, hj))


def _logits_t(pt, cfg, batch):
    ht = M.backbone(pt, cfg, _torch(_inputs(batch)))[0]
    return M._head(pt, cfg, ht).numpy()


@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_config_matches_reference(variant):
    """Every field equal to the reference's config (``use_pallas`` is
    ``use_kernels`` in the port, True by default)."""
    want = dataclasses.asdict(jax_config(ARCH, variant=variant))
    want.pop("use_pallas")
    got = dataclasses.asdict(get_config(ARCH, variant=variant))
    assert got.pop("use_kernels") is True
    assert got == want
    if variant == "reduced":
        assert (got["n_layers"], got["n_enc_layers"], got["d_model"],
                got["frontend_tokens"]) == (2, 2, 128, 16)


def test_tree_round_trips_through_convert():
    cfg_j, pj, cfg, pt = models()
    want = convert.flatten(jax.tree.map(np.asarray, pj))
    back = convert.flatten(convert.params_to_jax(pt, cfg))
    assert set(back) == set(want)
    for p, a in want.items():
        assert back[p].dtype == a.dtype
        np.testing.assert_array_equal(back[p], a, err_msg=p)
    meta = convert.flatten(M.init_params(cfg, generator="meta"))
    assert {p: tuple(t.shape) for p, t in meta.items()} == \
        {p: a.shape for p, a in want.items()}
    # encoder blocks are plain blocks; decoder blocks add ln_x and xattn
    assert "enc_blocks/attn/wq" in want and "enc_norm/bias" in want
    assert "dec_blocks/xattn/wo" in want and "dec_blocks/ln_x/scale" in want
    assert "lm_head" not in want
    assert want["enc_blocks/mlp/wi"].shape == (cfg.n_enc_layers, cfg.d_model,
                                               cfg.d_ff)
    bad = dict(want)
    bad["dec_blocks/xattn/wk"] = bad["dec_blocks/xattn/wk"][:, :3]
    with pytest.raises(ValueError, match="xattn/wk"):
        convert.params_from_jax(convert.unflatten(bad), cfg)
    # a port draw has the reference's layout too
    drawn = convert.flatten(M.init_params(cfg,
                                          generator=torch.Generator()))
    assert {p: tuple(t.shape) for p, t in drawn.items()} == \
        {p: a.shape for p, a in want.items()}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_match_reference(use_kernels):
    cfg_j, cfg = _paths(use_kernels)
    _, pj, _, pt = models()
    batch = _batch(cfg)
    want = _logits_j(pj, cfg_j, batch)
    got = _logits_t(pt, cfg, batch)
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)
    # the frames reach the logits: zeroed frames break the check
    zeroed = dict(batch, frames=np.zeros_like(batch["frames"]))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_logits_t(pt, cfg, zeroed), want, **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_encoder_is_bidirectional(use_kernels):
    """A change in the last frame moves the memory at frame 0, and the
    memory is what the decoder reads; a causal encoder would leave frame
    0's memory as it was."""
    _, cfg = _paths(use_kernels)
    _, _, _, pt = models()
    frames = torch.as_tensor(_batch(cfg, B=1)["frames"])
    other = frames.clone()
    # a direction LayerNorm does not remove (a constant shift it would)
    other[0, -1] += torch.linspace(-1.0, 1.0, cfg.d_model)
    m0, _ = M._encode(pt, cfg, frames)
    m1, _ = M._encode(pt, cfg, other)
    assert (m0[0, 0] - m1[0, 0]).abs().max() > 1e-3
    causal = cfg.replace(use_kernels=False)
    orig = M._block_full

    def causal_block(*a, **kw):
        return orig(*a, **{**kw, "causal": True})

    M._block_full = causal_block
    try:
        c0, _ = M._encode(pt, causal, frames)
        c1, _ = M._encode(pt, causal, other)
    finally:
        M._block_full = orig
    torch.testing.assert_close(c0[:, :-1], c1[:, :-1], rtol=0, atol=0)


REMAT = {"off": dict(remat=False), "full": dict(remat=True),
         "dots": dict(remat=True, remat_policy="dots")}


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("remat", sorted(REMAT))
def test_loss_and_gradients_match_reference(remat, use_kernels):
    cfg_j, cfg = _paths(use_kernels)
    cfg_j, cfg = cfg_j.replace(**REMAT[remat]), cfg.replace(**REMAT[remat])
    _, pj, _, pt = models()
    batch = _batch(cfg, seed=5)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, _jax(batch)), has_aux=True)(pj)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in convert.flatten(pt).items()}
    lt, mt = M.loss_fn(convert.unflatten(leaves), cfg, _torch(batch))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    for key in ("nll", "tokens", "accuracy", "aux_loss", "ce_loss"):
        np.testing.assert_allclose(mt[key].item(), float(mj[key]),
                                   err_msg=key, **TOL)
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(want) == set(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[k], err_msg=k, **TOL)
    # the encoder's and the cross-attention's weights get gradient
    for k in ("enc_blocks/attn/wq", "dec_blocks/xattn/wk",
              "enc_norm/scale"):
        assert np.abs(want[k]).max() > 0, k


# ---------------------------------------------------------------------------
# the dots policy
# ---------------------------------------------------------------------------

class _CountMM(TorchDispatchMode):
    """Counts the ``aten.mm`` / ``aten.addmm`` calls that reach the
    dispatcher while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_a_batched_activation_times_a_matrix_is_one_mm():
    x = torch.randn(2, 5, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)
    with _CountMM() as c:
        y = x @ w
    assert c.n == 1
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    with Ops():
        torch.einsum("bqd,bkd->bqk", x, x)
    assert torch.ops.aten.bmm.default in seen
    assert torch.ops.aten.mm.default not in seen
    assert y.shape == (2, 5, 3)


def _backward_mms(cfg, pt, batch):
    """(mm calls in the forward, mm calls in the backward) of one
    ``loss_fn`` and its gradient on the port's plain path."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in convert.flatten(pt).items()}
    with _CountMM() as fwd:
        loss, _ = M.loss_fn(convert.unflatten(leaves), cfg, _torch(batch))
    with _CountMM() as bwd:
        loss.backward()
    return fwd.n, bwd.n, {k: t.grad for k, t in leaves.items()}


def test_dots_keeps_every_product_of_a_checkpointed_function():
    """One function under ``_maybe_remat``: its backward under ``dots``
    runs the mm calls of the backward without remat (the products' outputs
    kept, the GELU recomputed), full remat recomputes the first product
    (non-reentrant checkpointing stops once the backward has what it
    needs, so the last is not rerun); the gradients are bit-equal."""
    _, cfg = _paths(False)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 8, generator=g)
    w1, w2 = torch.randn(8, 16, generator=g), torch.randn(16, 8, generator=g)
    counts, grads = {}, {}
    for name, kw in REMAT.items():
        fn = M._maybe_remat(cfg.replace(**kw), lambda x, a, b: (
            torch.nn.functional.gelu(x @ a) @ b))
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, w2)]
        out = fn(*leaves).square().sum()
        with _CountMM() as c:
            out.backward()
        counts[name], grads[name] = c.n, [t.grad for t in leaves]
    assert counts["dots"] == counts["off"] == 4
    assert counts["full"] == counts["off"] + 1
    for name in ("dots", "full"):
        for a, b in zip(grads[name], grads["off"]):
            assert torch.equal(a, b)


def test_dots_recomputes_fewer_products_than_full_remat():
    """The whole model: the backward's mm calls beyond those of the run
    without remat (its recomputed products) are fewer under ``dots``
    than under full remat, yet not none, since each decoder layer is
    rematerialised whole (``test_dots_recomputes_the_decoder_whatever_
    the_policy``); the gradients are equal bit for bit."""
    _, cfg = _paths(False)
    _, _, _, pt = models()
    batch = _batch(cfg, seed=8)
    runs = {k: _backward_mms(cfg.replace(**v), pt, batch)
            for k, v in REMAT.items()}
    f_off, b_off, g_off = runs["off"]
    assert all(f == f_off > 0 for f, _, _ in runs.values())
    full = runs["full"][1] - b_off
    dots = runs["dots"][1] - b_off
    assert 0 < dots < full < f_off
    for name in ("full", "dots"):
        for k, g in runs[name][2].items():
            assert torch.equal(g, g_off[k]), (name, k)


def test_dots_recomputes_the_decoder_whatever_the_policy():
    """The reference checkpoints each decoder layer without a policy:
    under ``dots`` the port recomputes the decoder's products, and only
    those, when the encoder and the loss keep theirs."""
    _, cfg = _paths(False)
    _, _, _, pt = models()
    batch = _batch(cfg, seed=8)
    seen = []
    orig = M._maybe_remat

    def spy(c, fn, *, policy=None):
        seen.append(c.remat_policy if policy is None else policy)
        return orig(c, fn, policy=policy)

    M._maybe_remat = spy
    try:
        M.loss_fn(pt, cfg.replace(remat=True, remat_policy="dots"),
                  _torch(batch))
    finally:
        M._maybe_remat = orig
    # the encoder's blocks, the decoder's layers, the loss chunks
    assert seen == ["dots", "nothing", "dots"]


def test_dots_runs_fn_as_is_without_autograd():
    _, cfg = _paths(False)
    calls = []
    fn = M._maybe_remat(cfg.replace(remat=True, remat_policy="dots"),
                        lambda x: calls.append(1) or x * 2)
    with torch.no_grad():
        out = fn(torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and calls == [1]


# ---------------------------------------------------------------------------
# the train launcher's batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-small",
                                  "tinyllama-1.1b"])
def test_make_batch_matches_reference(arch):
    cfg_j = jax_config(arch, variant="reduced").replace(vocab_size=256)
    cfg = get_config(arch, variant="reduced").replace(vocab_size=256)
    from repro.data.federated import FederatedCorpus as JaxCorpus
    jc = JaxCorpus.build(seed=0, n_devices=4, n_domains=4, vocab=256)
    tc = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4, vocab=256)
    want = jax_train.make_batch(cfg_j, jc, 3, 2, 16)
    got = launch_train.make_batch(cfg, tc, 3, 2, 16, torch.device("cpu"))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == w.dtype.name, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    key = M.frontend_key(cfg)
    if key is not None:
        assert got[key].shape == (2, cfg.frontend_tokens, cfg.d_model)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-small"])
def test_launcher_trains_the_frontend_families(arch, capsys):
    losses = launch_train.main(["--arch", arch, "--variant", "reduced",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "2", "--seq", "32"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert f"{arch} (reduced) on cpu" in capsys.readouterr().out
