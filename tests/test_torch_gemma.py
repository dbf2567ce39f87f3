"""Gemma-2 and PaliGemma in the port against the JAX reference, on the
CPU.

Reduced variants (``models.config.reduced``): gemma2-9b keeps its
local/global pattern with a window of 64, both logit softcaps (50 on
attention scores, 30 on the final logits), post-block norms, the
embedding scale, tanh-GeGLU and the tied head; PaliGemma keeps its
single kv head (GQA 4:1 here), head dim 32, GeGLU, the embedding scale
and 16 stub patch rows that prefix every prompt.  The reference's
weights are converted, f32, and held with the tolerance of
``tests/test_torch_families.py`` (1e-5 + 1e-4 relative); the reference
runs its plain path, the port both of its paths (the kernels' plain
versions on CPU tensors).

* forward logits at every position, gemma2 at S 160, past the window;
* ``loss_fn`` and its metrics, and every gradient (PaliGemma's loss
  with the patch positions dropped);
* both softcaps made to bite: ``wq`` scaled so that attention scores
  reach 100-200, the final norm scaled so that logits reach 60 and
  more, held to ten times that tolerance (``BITE_TOL``: f32 rounding
  of such scores is amplified); the port with either cap set to 0 must
  then fail it;
* a local-only gemma2 ignores tokens beyond two windows;
* prefill + ``decode_step`` against the forward pass and the
  reference's decode, contiguous and paged, gemma2 decoding past the
  window; ``prefill_chunked`` against the reference's;
* ``convert`` round-trips PaliGemma's tree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import model as M

from test_torch_simulation import fast_reference_compiles

TOL = dict(atol=1e-5, rtol=1e-4)
CHUNK_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["gemma2-9b", "paligemma-3b"]


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


def models(arch):
    if arch not in _MODELS:
        cfg_j = jax_config(arch, variant="reduced").replace(use_pallas=False)
        cfg = get_config(arch, variant="reduced")
        pj = JM.init_params(jax.random.PRNGKey(4), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[arch] = (cfg_j, pj, cfg, pt)
    return _MODELS[arch]


def _batch(cfg, B=2, S=None, seed=3):
    """Tokens and labels; for PaliGemma also patches (normal x 0.05, as
    the serving launcher draws them).  gemma2 runs past its window."""
    S = S or (160 if cfg.sliding_window else 40)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.arch_type == "vlm":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)) * 0.05).astype(np.float32)
    return batch


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


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, use_kernels):
    cfg_j, pj, cfg, pt = models(arch)
    batch = _batch(cfg)
    want = _logits_j(pj, cfg_j, batch)
    got = _logits_t(pt, cfg.replace(use_kernels=use_kernels), batch)
    S = batch["tokens"].shape[1] + M.decode_offset(cfg)
    assert got.shape == (2, S, cfg.vocab_size)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, use_kernels):
    cfg_j, pj, cfg, pt = models(arch)
    batch = _batch(cfg, seed=5)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, _jax(batch)), has_aux=True)(pj)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in convert.flatten(pt).items()}
    lt, mt = M.loss_fn(convert.unflatten(leaves),
                       cfg.replace(use_kernels=use_kernels), _torch(batch))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for key in ("nll", "tokens", "accuracy", "aux_loss", "ce_loss"):
        np.testing.assert_allclose(mt[key].item(), float(mj[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    # the loss counts text positions only: the patch rows are dropped
    assert mt["tokens"].item() == batch["labels"].size
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(want) == set(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[k], err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# softcaps that bite
# ---------------------------------------------------------------------------

WQ_SCALE = 40.0          # layer-0 attention scores reach 100-200
FINAL_NORM_SCALE = 80.0  # logits reach 60 and more before the cap of 30
# At these scales an f32 ulp of a score (150: 1.5e-5) or of a raw logit
# (80: 7.6e-6) is amplified by the softmax and the tanh: the port reads
# 3.9-6.5x TOL from the reference (max abs 5.7e-5 to 8.0e-5 on logits of
# at most 30), so the scaled weights are held to ten times TOL.  A cap
# set to 0 reads 17,000x (final) and 92,000x (attention) TOL.
BITE_TOL = dict(atol=1e-4, rtol=1e-3)


def _scaled(tree, leaf, scale):
    """A numpy parameter tree with every leaf under ``leaf`` scaled."""
    return convert.unflatten({
        p: (a * scale).astype(a.dtype) if leaf in p else a
        for p, a in convert.flatten(tree).items()})


def _max_layer0_score(pt, cfg, batch):
    """Largest |q.k| / sqrt(Dh) of the first layer, before any cap."""
    x = M._embed(pt, cfg, torch.as_tensor(batch["tokens"]))
    sub = M._layer(pt["blocks"]["sub0"], 0)
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    q, k, _ = layers.attention_qkv(sub["attn"], cfg,
                                   layers.apply_norm(sub["ln1"], x), pos)
    g = cfg.n_heads // cfg.n_kv_heads
    k = k.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / cfg.resolved_head_dim ** 0.5
    return s.abs().max().item()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("cap", ["attn", "final"])
def test_softcaps_bite(cap, use_kernels):
    """With scores and logits scaled into each cap's range, the port
    matches the reference within BITE_TOL, and the port with that cap
    set to 0 misses it: the comparison sees each cap."""
    cfg_j, _, cfg, _ = models("gemma2-9b")
    base = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(4),
                                                   cfg_j))
    leaf, scale = (("attn/wq", WQ_SCALE) if cap == "attn"
                   else ("final_norm", FINAL_NORM_SCALE))
    tree = _scaled(base, leaf, scale)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = convert.params_from_jax(tree, cfg)
    batch = _batch(cfg, seed=9)
    c = cfg.replace(use_kernels=use_kernels)
    if cap == "attn":
        assert 100 <= _max_layer0_score(pt, c, batch) <= 200
        off = c.replace(attn_logit_softcap=0.0)
    else:
        raw = _logits_t(pt, c.replace(final_logit_softcap=0.0), batch)
        assert np.abs(raw).max() >= 60
        off = c.replace(final_logit_softcap=0.0)
    want = _logits_j(pj, cfg_j, batch)
    np.testing.assert_allclose(_logits_t(pt, c, batch), want, **BITE_TOL)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_logits_t(pt, off, batch), want,
                                   **BITE_TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_local_layers_ignore_tokens_beyond_two_windows(use_kernels):
    """Two local layers (window 64): a change at token 0 reaches no
    position from 128 on, as ``tests/test_models_smoke.py`` holds for
    the reference; with the local/full pattern it reaches the last one."""
    cfg_j, pj, cfg, pt = models("gemma2-9b")
    batch = _inputs(_batch(cfg, B=1, seed=11))
    other = {"tokens": batch["tokens"].copy()}
    other["tokens"][0, 0] = (other["tokens"][0, 0] + 1) % cfg.vocab_size
    c = cfg.replace(use_kernels=use_kernels)
    local = c.replace(n_layers=2, attn_pattern=("local", "local"))
    lp = M.init_params(local, generator=torch.Generator().manual_seed(0))
    w = cfg.sliding_window
    a, b = (M.backbone(lp, local, _torch(x))[0] for x in (batch, other))
    assert (a[:, 1:] - b[:, 1:]).abs().max() > 0
    np.testing.assert_array_equal(a[:, 2 * w:].numpy(), b[:, 2 * w:].numpy())
    a, b = (M.backbone(pt, c, _torch(x))[0] for x in (batch, other))
    assert (a[:, -1] - b[:, -1]).abs().max() > 1e-3


# ---------------------------------------------------------------------------
# prefill, decode and chunked prefill
# ---------------------------------------------------------------------------

def _prompt(arch, P, seed):
    cfg = models(arch)[2]
    return _inputs(_batch(cfg, B=1, S=P, seed=seed))


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_and_reference(arch, layout):
    """Prefill of P tokens (gemma2: 70, past the window of 64), then 4
    teacher-forced decode steps, kernel path: each step's logits equal
    the reference's decode and the full forward's at that position, as
    ``test_vlm_decode_matches_forward`` holds for the reference."""
    cfg_j, pj, cfg, pt = models(arch)
    n, bl = 4, 8
    P = 70 if arch == "gemma2-9b" else 12
    full = _prompt(arch, P + n, seed=13)
    pre = dict(full, tokens=full["tokens"][:, :P])
    off = M.decode_offset(cfg)
    cap = M.decode_capacity(cfg, P, n)
    _, pcj = JM.prefill(pj, cfg_j, _jax(pre))
    _, pct = M.prefill(pt, cfg, _torch(pre))
    bt = None
    if layout == "contiguous":
        cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 1, cap),
                                   pcj)
        ct = M.prefill_into_cache(cfg, M.init_decode_cache(
            cfg, 1, cap, device="cpu"), pct)
    else:
        n_pb, nb = -(-(off + P) // bl), -(-cap // bl)
        ids = list(range(1, n_pb + 1))
        bt = np.arange(1, nb + 1, dtype=np.int32)[None]
        cj = JM.scatter_prefill_paged(
            cfg_j, JM.init_paged_cache(cfg_j, 1, nb + 1, bl),
            JM.prefill_into_cache(cfg_j, JM.init_decode_cache(
                cfg_j, 1, n_pb * bl), pcj), 0, jnp.asarray(ids),
            jnp.ones((n_pb,), bool), block_len=bl)
        ct = M.init_paged_cache(cfg, 1, nb + 1, bl, device="cpu")
        M.scatter_prefill_paged(cfg, ct, M.prefill_into_cache(
            cfg, M.init_decode_cache(cfg, 1, n_pb * bl, device="cpu"), pct),
            0, ids, [True] * n_pb, block_len=bl)
    fwd = _logits_t(pt, cfg, full)[0, off + P - 1:]
    for j in range(n):
        tok = full["tokens"][:, P + j:P + j + 1]
        pos = np.array([M.decode_pos0(cfg, P) + j], np.int32)
        kw = {} if bt is None else {"block_tables": bt}
        lj, cj = JM.decode_step(pj, cfg_j, cj, jnp.asarray(tok),
                                jnp.asarray(pos),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        lt, ct = M.decode_step(pt, cfg, ct, torch.as_tensor(tok),
                               torch.as_tensor(pos),
                               **{k: torch.as_tensor(v)
                                  for k, v in kw.items()})
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        np.testing.assert_allclose(lt[0].numpy(), fwd[j + 1], **TOL)


def _padded(toks, lens, T):
    out = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        out[b, :n] = toks[b, :n]
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunked_matches_reference(arch, layout):
    """Chunks of 16 over the padded input (PaliGemma: the 16 patch rows
    fill the first chunk): the last real token's logits and every cache
    leaf against the reference's; two rows of 75 and 52 tokens in a
    contiguous cache, or one of 75 through a paged table (gemma2's
    chunks past the window read a cut context)."""
    cfg_j, pj, cfg, pt = models(arch)
    C, bl = 16, 8
    off = M.decode_offset(cfg)
    src = _batch(cfg, B=2, S=75, seed=17)
    lens = [75, 52] if layout == "contiguous" else [75]
    T = -(-(off + 75) // C) * C - off
    batch = {"tokens": _padded(src["tokens"], lens, T)[:len(lens)]}
    if "patches" in src:
        batch["patches"] = src["patches"][:len(lens)]
    S = off + T
    if layout == "contiguous":
        cj = JM.init_decode_cache(cfg_j, 2, S + 8)
        ct = M.init_decode_cache(cfg, 2, S + 8, device="cpu")
        tab = {}
    else:
        W = S // bl
        cj = JM.init_paged_cache(cfg_j, 1, W + 2, bl)
        ct = M.init_paged_cache(cfg, 1, W + 2, bl, device="cpu")
        perm = np.random.default_rng(0).permutation(W) + 1
        tab = {"block_tables": perm[None].astype(np.int32)}
    lj, cj = JM.prefill_chunked(pj, cfg_j, cj, _jax(batch),
                                jnp.asarray(lens, jnp.int32), chunk_len=C,
                                **{k: jnp.asarray(v) for k, v in tab.items()})
    lt, ct = M.prefill_chunked(pt, cfg, ct, _torch(batch), lens, chunk_len=C,
                               **{k: torch.as_tensor(v)
                                  for k, v in tab.items()})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **CHUNK_TOL)
    got, want = convert.flatten(ct), convert.flatten(cj)
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        if tab:
            g, w = g[:, 1:], w[:, 1:]     # not the trash block
        np.testing.assert_allclose(g, w, **CHUNK_TOL, err_msg=path)
    # and the one-shot prefill's last logits
    one = {k: v[:1] for k, v in batch.items()}
    one["tokens"] = src["tokens"][:1, :75]
    first, _ = M.prefill(pt, cfg, _torch(one))
    np.testing.assert_allclose(lt[0].numpy(), first[0].numpy(), **CHUNK_TOL)


def test_vlm_tree_round_trips_through_convert():
    cfg_j, pj, cfg, pt = models("paligemma-3b")
    want = convert.flatten(jax.tree.map(np.asarray, pj))
    back = convert.flatten(convert.params_to_jax(pt, cfg))
    assert set(back) == set(want)
    for p, a in want.items():
        np.testing.assert_array_equal(back[p], a, err_msg=p)
    meta = convert.flatten(M.init_params(cfg, generator="meta"))
    assert {p: tuple(t.shape) for p, t in meta.items()} == \
        {p: a.shape for p, a in want.items()}
    # the VLM tree is the dense tree: no frontend leaf (the stub's patches
    # come with each request)
    assert set(want) == set(convert.flatten(JM.init_params(
        jax.random.PRNGKey(0), cfg_j.replace(arch_type="dense",
                                             frontend="",
                                             frontend_tokens=0))))
    bad = dict(want)
    bad["embed"] = bad["embed"][:, :3]
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_jax(convert.unflatten(bad), cfg)


def test_vlm_caches_hold_the_patch_rows():
    """Prefill's cache covers [patches | text]; the decode cache's
    capacity counts the frontend, and decode starts after it."""
    _, _, cfg, pt = models("paligemma-3b")
    P = 9
    _, pc = M.prefill(pt, cfg, _torch(_prompt("paligemma-3b", P, seed=2)))
    assert pc["blocks"]["sub0"]["k"].shape[2] == cfg.frontend_tokens + P
    assert M.decode_capacity(cfg, P, 4) == cfg.frontend_tokens + P + 4
    assert M.decode_pos0(cfg, P) == cfg.frontend_tokens + P
    with pytest.raises(ValueError, match="multiple of chunk_len"):
        M.prefill_chunked(pt, cfg, M.init_decode_cache(cfg, 1, 64,
                                                       device="cpu"),
                          _torch(_prompt("paligemma-3b", 10, seed=2)), 10,
                          chunk_len=16)
