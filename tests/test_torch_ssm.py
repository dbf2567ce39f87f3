"""The port's ssm family (Mamba-2) against the JAX reference.

Reduced ``mamba2-1.3b`` (2 layers, d 128, N 16, P 16, chunk 32, f32),
the reference's weights converted.  Two weight sets: the reference's
init (A = -1, dt about 0.75, so state decays fast) and the same with
``A_log`` and ``dt_bias`` set for slow decay (dt * |A| about 0.003,
exp(cum) over a 32-row chunk about 0.9), where the carried state and the
far pairs of a chunk reach the output.  The reference runs with
``use_pallas`` (the SSD kernel in interpret mode) or without; the port
with ``use_kernels`` (the kernel's plain version on CPU tensors) or
without (``ssd_chunked``).

Tolerance: f32, sums and cumsums in other orders through two layers:
1e-4 absolute and relative on logits, outputs and caches (their largest
values are O(1)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import ssm as jssm
from repro.serve import PagedServeEngine as JaxPaged
from repro.serve import ServeEngine as JaxServe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.serve import PagedServeEngine, ServeEngine

from test_torch_simulation import fast_reference_compiles


TOL = dict(atol=1e-4, rtol=1e-4)


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


def _slow(np_tree):
    """A = -0.05, dt = softplus(proj - 4) (about 0.02) in every layer."""
    mixer = np_tree["blocks"]["mixer"]
    mixer["A_log"] = np.full_like(mixer["A_log"], np.log(0.05))
    mixer["dt_bias"] = np.full_like(mixer["dt_bias"], -4.0)
    return np_tree


@pytest.fixture(scope="module", params=["init", "slow"])
def models(request):
    cfg_j = jax_config("mamba2-1.3b", variant="reduced")
    cfg = get_config("mamba2-1.3b", variant="reduced")
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1),
                                                   cfg_j))
    if request.param == "slow":
        tree = _slow(tree)
    pj = jax.tree.map(jnp.asarray, tree)
    pt = convert.params_from_jax(tree, cfg)
    return cfg_j, pj, cfg, pt


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_tree_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL,
                                   err_msg=k)


def test_reduced_config_matches_reference():
    cfg_j = jax_config("mamba2-1.3b", variant="reduced")
    cfg = get_config("mamba2-1.3b", variant="reduced")
    for f in ("n_layers", "d_model", "ssm_state", "ssm_head_dim",
              "ssm_expand", "ssm_conv", "ssm_chunk", "ssm_groups",
              "vocab_size", "dtype", "tie_embeddings", "arch_type",
              "ssm_compute_dtype"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    full = get_config("mamba2-1.3b")
    assert (full.n_layers, full.d_model, full.ssm_heads, full.ssm_state,
            full.ssm_chunk, full.vocab_size) == (48, 2048, 64, 128, 256,
                                                 50280)


# ---------------------------------------------------------------------------
# one Mamba-2 block
# ---------------------------------------------------------------------------

def _block(pj, pt, layer=0):
    bj = jax.tree.map(lambda a: a[layer], pj["blocks"]["mixer"])
    bt = jax.tree.map(lambda a: a[layer], pt["blocks"]["mixer"])
    return bj, bt


@pytest.mark.parametrize("S", [1, 2, 5, 33, 70])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_block_forward_continuation_and_decode(models, S, use_kernels):
    """``ssm_forward`` with its cache (prompts shorter than K-1 = 3 take
    the padded conv tail), a continuation chunk from that cache (the
    carried conv tail and state), then two ``ssm_decode`` steps."""
    cfg_j, pj, cfg, pt = models
    cfg_j = cfg_j.replace(use_pallas=use_kernels)
    cfg = cfg.replace(use_kernels=use_kernels)
    bj, bt = _block(pj, pt)
    x = np.random.default_rng(S).standard_normal(
        (2, S + 9, cfg.d_model)).astype(np.float32)
    oj, cj = jssm.ssm_forward(bj, cfg_j, jnp.asarray(x[:, :S]),
                              return_cache=True)
    ot, ct = ssm.ssm_forward(bt, cfg, torch.from_numpy(x[:, :S]),
                             return_cache=True)
    np.testing.assert_allclose(_np(ot), _np(oj), **TOL)
    _assert_tree_close(ct, cj)
    assert ct["conv"].shape == (2, cfg.ssm_conv - 1,
                                cfg.d_inner + 2 * cfg.ssm_state)
    # continuation: 7 more rows from the cache
    oj, cj = jssm.ssm_forward(bj, cfg_j, jnp.asarray(x[:, S:S + 7]),
                              conv_cache=cj["conv"], init_state=cj["state"],
                              return_cache=True)
    ot, ct = ssm.ssm_forward(bt, cfg, torch.from_numpy(x[:, S:S + 7]),
                             conv_cache=ct["conv"], init_state=ct["state"],
                             return_cache=True)
    np.testing.assert_allclose(_np(ot), _np(oj), **TOL)
    _assert_tree_close(ct, cj)
    for i in range(S + 7, S + 9):
        oj, cj = jssm.ssm_decode(bj, cfg_j, jnp.asarray(x[:, i:i + 1]), cj)
        ot, ct = ssm.ssm_decode(bt, cfg, torch.from_numpy(x[:, i:i + 1]), ct)
        np.testing.assert_allclose(_np(ot), _np(oj), **TOL)
        _assert_tree_close(ct, cj)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _prefill_pair(models, toks, use_kernels):
    cfg_j, pj, cfg, pt = models
    lj, cj = JM.prefill(pj, cfg_j.replace(use_pallas=use_kernels),
                        {"tokens": jnp.asarray(toks)})
    lt, ct = M.prefill(pt, cfg.replace(use_kernels=use_kernels),
                       {"tokens": torch.as_tensor(toks)})
    return lj, cj, lt, ct


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_logits_and_cache(models, use_kernels):
    cfg = models[2]
    toks = _tokens(cfg, (2, 70))
    lj, cj, lt, ct = _prefill_pair(models, toks, use_kernels)
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    _assert_tree_close(ct["blocks"], cj["blocks"])
    assert ct["blocks"]["state"].shape == (cfg.n_layers, 2, cfg.ssm_heads,
                                           cfg.ssm_head_dim, cfg.ssm_state)


def test_decode_steps_match_reference(models):
    """Prefill into a decode cache, then five ``decode_step``s of given
    tokens: logits and both cache leaves after every step."""
    cfg_j, pj, cfg, pt = models
    toks = _tokens(cfg, (2, 40))
    P = 33
    lj, cj, lt, ct = _prefill_pair(models, toks[:, :P], True)
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 2, 48), cj)
    ct = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 2, 48,
                                                       device="cpu"), ct)
    for i in range(P, P + 5):
        pos = np.full((2,), i, np.int32)
        lj, cj = JM.decode_step(pj, cfg_j, cj, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos))
        lt, ct2 = M.decode_step(pt, cfg, ct, torch.as_tensor(toks[:, i:i + 1]),
                                torch.as_tensor(pos))
        assert ct2 is ct  # updated in place
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
        _assert_tree_close(ct["blocks"], cj["blocks"])


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_then_decode_equals_one_prefill(models, use_kernels):
    """Prefill of the first 30 tokens then decode steps over the next 8
    give the logits that one full-sequence pass gives at those
    positions."""
    _, _, cfg, pt = models
    cfg = cfg.replace(use_kernels=use_kernels)
    toks = torch.as_tensor(_tokens(cfg, (2, 38)))
    h, _, _, _ = M.backbone(pt, cfg, {"tokens": toks})
    full = M._head(pt, cfg, h)
    logits, pc = M.prefill(pt, cfg, {"tokens": toks[:, :30]})
    np.testing.assert_allclose(_np(logits), _np(full[:, 29]), **TOL)
    cache = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 2, 38,
                                                          device="cpu"), pc)
    for i in range(30, 38):
        logits, cache = M.decode_step(pt, cfg, cache, toks[:, i:i + 1],
                                      torch.full((2,), i))
        np.testing.assert_allclose(_np(logits), _np(full[:, i]), **TOL)


def test_paged_layout_is_slot_resident():
    """The ssm cache has no sequence axis: no paged leaves, and the paged
    cache keeps one row per slot with the reference's shapes."""
    cfg_j = jax_config("mamba2-1.3b", variant="reduced")
    cfg = get_config("mamba2-1.3b", variant="reduced")
    assert not M.has_paged_leaves(cfg) and not JM.has_paged_leaves(cfg_j)
    assert M.has_paged_leaves(get_config("tinyllama-1.1b", variant="reduced"))
    want = JM.init_paged_cache(cfg_j, 3, 9, 4)
    got = M.init_paged_cache(cfg, 3, 9, 4, device="cpu")
    for k in ("state", "conv"):
        assert tuple(got["blocks"][k].shape) == want["blocks"][k].shape
        assert str(got["blocks"][k].dtype)[6:] == str(want["blocks"][k].dtype)
    assert M.decode_cache_seq_axes(cfg) == {"blocks": {"state": -1,
                                                       "conv": -1}}
    assert M.decode_cache_batch_axes(cfg) == {"blocks": {"state": 1,
                                                         "conv": 1}}


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

# (prompt length, max_new): lengths around the reduced chunk of 32, one
# shorter than the conv's K-1 = 3; five requests through two slots, so
# reused slots must have their state and conv tail overwritten whole
TRAFFIC = [(2, 6), (5, 4), (31, 5), (33, 3), (70, 7)]


@pytest.fixture(scope="module")
def traffic(models):
    cfg = models[2]
    prompts = [_tokens(cfg, (1, P), seed=20 + i)
               for i, (P, _) in enumerate(TRAFFIC)]
    return prompts, [g for _, g in TRAFFIC]


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_engines_token_identical(models, traffic, engine):
    cfg_j, pj, cfg, pt = models
    prompts, gens = traffic
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    kw = dict(n_slots=2, seg_len=3, max_len=max_len)
    jcls, tcls = ((JaxPaged, PagedServeEngine) if engine == "paged"
                  else (JaxServe, ServeEngine))
    pkw = dict(block_len=4) if engine == "paged" else {}
    jeng = jcls(pj, cfg_j.replace(use_pallas=True), **kw, **pkw)
    teng = tcls(pt, cfg, device="cpu", **kw, **pkw)
    for p, g in zip(prompts, gens):
        jeng.submit({"tokens": jnp.asarray(p)}, max_new=g)
        teng.submit({"tokens": p}, max_new=g)
    want = {u: c.tokens.tolist() for u, c in jeng.run().items()}
    got = {u: c.tokens.tolist() for u, c in teng.run().items()}
    assert got == want
    assert all(len(got[u]) == g for u, g in enumerate(gens))
    if engine == "paged":
        # no paged leaves: no pool, no sharing, no preemption
        assert not teng.lazy and not teng.share_prefix
        assert teng.stats["fresh_blocks"] == teng.stats["shared_blocks"] == 0
        assert teng.stats["preemptions"] == 0
        assert teng.alloc.n_free == teng.n_blocks - 1


def test_admission_overwrites_the_slot_whole(models):
    """A slot's state and conv tail after admission equal a fresh
    prefill's, whatever the slot held before."""
    _, _, cfg, pt = models
    eng = PagedServeEngine(pt, cfg, n_slots=2, max_len=40, device="cpu")
    for t in M.init_paged_cache(cfg, 2, 1, 16, device="cpu")["blocks"]:
        eng.cache["blocks"][t].fill_(7.0)
    toks = _tokens(cfg, (1, 12))
    eng.submit({"tokens": toks}, max_new=3)
    eng._admit()
    slot = int(np.flatnonzero(eng.slot_uid >= 0)[0])
    _, pc = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    for k in ("state", "conv"):
        torch.testing.assert_close(eng.cache["blocks"][k][:, slot],
                                   pc["blocks"][k][:, 0], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# weights, refusals, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip(dtype):
    cfg_j = jax_config("mamba2-1.3b", variant="reduced").replace(dtype=dtype)
    cfg = get_config("mamba2-1.3b", variant="reduced").replace(dtype=dtype)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg_j))
    tp = convert.params_from_jax(tree, cfg)
    flat = convert.flatten(tp)
    for path, t in flat.items():
        f32 = path.rsplit("/", 1)[-1] in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if f32 else getattr(torch, dtype)), \
            path
    assert flat["blocks/mixer/in_proj"].shape == (
        cfg.n_layers, cfg.d_model,
        2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    back = convert.flatten(convert.params_to_jax(tp, cfg))
    want = convert.flatten(tree)
    assert set(back) == set(want)
    for path, a in want.items():
        assert back[path].dtype == a.dtype
        np.testing.assert_array_equal(back[path].view(np.uint8),
                                      a.view(np.uint8))
    port = convert.flatten(M.init_params(cfg, generator=torch.Generator()))
    assert {p: (tuple(t.shape), t.dtype) for p, t in port.items()} == \
        {p: (tuple(t.shape), t.dtype) for p, t in flat.items()}


def test_unported_ssm_paths_raise(models):
    # training and chunked prefill with a carried state are ported
    # (tests/test_torch_ssm_train.py, tests/test_torch_serve_chunked.py),
    # and the chunk body takes every family, the encoder-decoder one the
    # last (tests/test_torch_encdec_serve.py); speculative decode is
    # ported, and the ssm model, which has no MTP head, is refused it
    # with the reference's ValueError
    _, _, cfg, pt = models
    with pytest.raises(ValueError, match="requires an MTP head"):
        PagedServeEngine(pt, cfg, n_slots=1, max_len=8, speculate=2,
                         device="cpu")


@pytest.mark.parametrize("paged", [True, False])
def test_launcher_serves_mamba2_on_the_cpu(paged):
    from repro_torch.launch import serve
    comps = serve.main(["--arch", "mamba2-1.3b", "--device", "cpu",
                        "--mixed", "--requests", "3", "--prompt-len", "12",
                        "--gen", "6"] + (["--paged"] if paged else []))
    assert [len(c.tokens) for _, c in sorted(comps.items())] == [6, 3, 2]
