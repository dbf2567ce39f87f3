"""The port's hybrid family (Zamba2: Mamba-2 blocks with one shared
attention block) against the JAX reference, on the CPU.

Reduced ``zamba2-7b`` (d 128, 4 heads x 32, N 16, P 16, chunk 32, the
shared block every 2 Mamba-2 blocks, f32) with 4 layers (two groups, no
tail) and 5 (two groups and a 1-block tail, as Zamba2-7B's 81 = 13 x 6 +
3 has one), the reference's weights converted.  The reference runs with
``use_pallas=False`` and, for serving, ``mesh=None``; the port on both
of its paths (``use_kernels``: the kernels' plain versions on CPU
tensors).

* logits, loss and every gradient (the shared block's sums its
  applications) against ``jax.grad``, the port with its nested remat on
  the kernel path;
* prefill + decode against one forward, and against the reference's
  ``decode_step`` (logits and every cache leaf); the ``convert`` round
  trip; the cache layouts (contiguous and paged, axes, bytes);
* both engines' greedy tokens against the JAX ``mesh=None`` engines on
  mixed-length, prefix-sharing and preemption traffic; admission
  overwrites a slot's recurrent state whole;
* planted faults that must break these checks: the tail's K/V not folded
  into the decode cache, and a slot's recurrent state not reset on
  admission.

Tolerances, set from readings (f32 sums in other orders through five
blocks): loss 1e-5 relative; gradients within 1e-4 of each leaf's
largest element (readings up to 1.7e-5); logits and caches 1e-4
absolute and relative (readings up to 8e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serve import PagedServeEngine as JaxPaged
from repro.serve import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, ServeEngine
from repro_torch.serve import engine as engine_mod

from test_torch_simulation import fast_reference_compiles, port_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
LAYERS = [4, 5]


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


def models(n_layers):
    """The reference's reduced config with ``n_layers`` and its weights,
    the port's config (kernel path) and the converted weights."""
    if n_layers not in _MODELS:
        cfg_j = jax_config("zamba2-7b", variant="reduced").replace(
            n_layers=n_layers, use_pallas=False)
        cfg = get_config("zamba2-7b", variant="reduced").replace(
            n_layers=n_layers)
        assert cfg == port_cfg(cfg_j).replace(use_kernels=True)
        pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[n_layers] = (cfg_j, pj, cfg, pt)
    return _MODELS[n_layers]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _rel_err(got, want):
    want = _np(want)
    return float(np.abs(_np(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _assert_tree_close(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL,
                                       err_msg=f"{path}/{k}")


def test_config_and_layout_match_reference():
    cfg_j, cfg = jax_config("zamba2-7b"), get_config("zamba2-7b")
    assert cfg == port_cfg(cfg_j).replace(use_kernels=True)
    assert M._hybrid_layout(cfg) == (6, 13, 3)
    assert get_config("zamba2-7b", variant="reduced") == port_cfg(
        jax_config("zamba2-7b", variant="reduced")).replace(use_kernels=True)
    for n in LAYERS:
        cfg_j, pj, cfg, pt = models(n)
        want = convert.flatten(jax.tree.map(np.asarray, pj))
        got = convert.flatten(pt)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert ("mamba_tail/mixer/in_proj" in got) == (n % 2 == 1)
        assert got["mamba_groups/mixer/A_log"].shape == (2, 2,
                                                         cfg.ssm_heads)
    meta = convert.flatten(M.init_params(get_config("zamba2-7b"),
                                         generator="meta"))
    assert sum(t.numel() for t in meta.values()) == 6_636_442_832


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=40, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_logits_loss_and_every_gradient_match_reference(n_layers,
                                                        use_kernels):
    cfg_j, pj, cfg, pt = models(n_layers)
    cfg = cfg.replace(use_kernels=use_kernels, remat=use_kernels)
    batch = _batch(cfg)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    hj, _, _, _ = JM.backbone(pj, cfg_j, bj)
    ht, _, _, _ = M.backbone(pt, cfg, bt)
    np.testing.assert_allclose(_np(M._head(pt, cfg, ht)),
                               _np(JM._head(pj, cfg_j, hj)), **TOL)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, bj), has_aux=True)(pj)
    flat = convert.flatten(pt)
    leaves = [t.requires_grad_(True) for t in flat.values()]
    lt, mt = M.loss_fn(pt, cfg, bt)
    gt = dict(zip(flat, torch.autograd.grad(lt, leaves)))
    for t in leaves:
        t.requires_grad_(False)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(mt["accuracy"]), _np(mj["accuracy"]),
                               rtol=LOSS_RTOL)
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(gt) == set(want)
    for k, w in want.items():
        assert _rel_err(gt[k], w) <= GRAD_REL, k


@pytest.mark.parametrize("n_layers", LAYERS)
def test_stages_match_reference(n_layers):
    """``backbone(collect_stages=True)``: each group's output (n_groups,
    B, S, D), the tail's blocks not among them, as the VAA distiller
    reads them."""
    cfg_j, pj, cfg, pt = models(n_layers)
    toks = _tokens(cfg, (2, 20), seed=5)
    _, _, _, sj = JM.backbone(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                              collect_stages=True)
    _, _, _, st = M.backbone(pt, cfg, {"tokens": torch.as_tensor(toks)},
                             collect_stages=True)
    assert tuple(st.shape) == (2, 2, 20, cfg.d_model)
    np.testing.assert_allclose(_np(st), _np(sj), **TOL)


# ---------------------------------------------------------------------------
# prefill, decode, caches
# ---------------------------------------------------------------------------

def _prefill_decode_vs_forward(cfg, pt, n_decode=6, P=30):
    """Largest |logit| difference of a P-token prefill then ``n_decode``
    decode steps against one full-sequence forward."""
    toks = torch.as_tensor(_tokens(cfg, (2, P + n_decode), seed=7))
    h, _, _, _ = M.backbone(pt, cfg, {"tokens": toks})
    full = M._head(pt, cfg, h)
    logits, pc = M.prefill(pt, cfg, {"tokens": toks[:, :P]})
    err = (logits - full[:, P - 1]).abs().max().item()
    cache = M.prefill_into_cache(cfg, M.init_decode_cache(
        cfg, 2, P + n_decode, device="cpu"), pc)
    for i in range(P, P + n_decode):
        logits, cache = M.decode_step(pt, cfg, cache, toks[:, i:i + 1],
                                      torch.full((2,), i))
        err = max(err, (logits - full[:, i]).abs().max().item())
    return err


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_prefill_then_decode_equals_one_forward(n_layers, use_kernels):
    _, _, cfg, pt = models(n_layers)
    assert _prefill_decode_vs_forward(
        cfg.replace(use_kernels=use_kernels), pt) <= TOL["atol"]


def test_tail_kv_not_folded_breaks_the_check(monkeypatch):
    """The 5-layer model's tail reads the last ``attn`` entry: a graft
    that leaves it empty must break the decode check."""
    _, _, cfg, pt = models(5)
    own = M.prefill_into_cache

    def no_fold(c, dc, pc):
        return own(c, dc, {**pc, "tail_attn": {
            k: torch.zeros_like(v) for k, v in pc["tail_attn"].items()}})
    monkeypatch.setattr(M, "prefill_into_cache", no_fold)
    assert _prefill_decode_vs_forward(cfg, pt) > 100 * TOL["atol"]


@pytest.mark.parametrize("n_layers", LAYERS)
def test_decode_steps_and_caches_match_reference(n_layers):
    """Prefill into a decode cache, then four ``decode_step``s of given
    tokens: logits and every cache leaf after every step."""
    cfg_j, pj, cfg, pt = models(n_layers)
    toks = _tokens(cfg, (2, 30), seed=4)
    P = 25
    lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks[:, :P])})
    lt, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks[:, :P])})
    np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
    assert set(pct) == {k for k, v in pcj.items() if v is not None}
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 2, 32),
                               pcj)
    ct = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 2, 32,
                                                       device="cpu"), pct)
    _assert_tree_close(ct, cj)
    for i in range(P, P + 4):
        pos = np.full((2,), i, np.int32)
        lj, cj = JM.decode_step(pj, cfg_j, cj, jnp.asarray(toks[:, i:i + 1]),
                                jnp.asarray(pos))
        lt, ct2 = M.decode_step(pt, cfg, ct, torch.as_tensor(toks[:, i:i + 1]),
                                torch.as_tensor(pos))
        assert ct2 is ct  # updated in place
        np.testing.assert_allclose(_np(lt), _np(lj), **TOL)
        _assert_tree_close(ct, cj)


@pytest.mark.parametrize("n_layers", LAYERS)
def test_cache_layouts_match_reference(n_layers):
    cfg_j, _, cfg, _ = models(n_layers)

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict)
                else (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in tree.items()}

    assert shapes(M.init_decode_cache(cfg, 3, 12, device="cpu")) == \
        shapes(JM.init_decode_cache(cfg_j, 3, 12))
    assert shapes(M.init_paged_cache(cfg, 3, 9, 4, device="cpu")) == \
        shapes(JM.init_paged_cache(cfg_j, 3, 9, 4))
    assert M.decode_cache_batch_axes(cfg) == JM.decode_cache_batch_axes(cfg_j)
    assert M.decode_cache_seq_axes(cfg) == JM.decode_cache_seq_axes(cfg_j)
    assert M.has_paged_leaves(cfg) and JM.has_paged_leaves(cfg_j)
    assert M.cache_nbytes(cfg, 3, 12) == JM.cache_nbytes(cfg_j, 3, 12)
    assert M.paged_cache_nbytes(cfg, 3, 9, 4) == \
        JM.paged_cache_nbytes(cfg_j, 3, 9, 4)
    n_attn = 2 + n_layers % 2
    assert M.init_decode_cache(cfg, 1, 5, device="meta")["attn"]["k"].shape \
        == (n_attn, 1, 5, cfg.n_kv_heads, cfg.resolved_head_dim)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_convert_round_trip(n_layers, dtype):
    cfg_j = jax_config("zamba2-7b", variant="reduced").replace(
        n_layers=n_layers, dtype=dtype)
    cfg = get_config("zamba2-7b", variant="reduced").replace(
        n_layers=n_layers, dtype=dtype)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg_j))
    back = convert.flatten(convert.params_to_jax(
        convert.params_from_jax(tree, cfg), cfg))
    want = convert.flatten(tree)
    assert set(back) == set(want)
    for path, a in want.items():
        assert back[path].dtype == a.dtype, path
        np.testing.assert_array_equal(back[path].view(np.uint8),
                                      a.view(np.uint8))
    port = convert.flatten(M.init_params(cfg, generator=torch.Generator()))
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in port.items()} == {p: (a.shape, a.dtype.name)
                                          for p, a in want.items()}


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _serve(cls, params, cfg, prompts, gens, **kw):
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    eng = cls(params, cfg, max_len=max_len, **kw)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": jnp.asarray(p) if cls in (JaxPaged, JaxEngine)
                    else p}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


# five requests through two slots, so reused slots must have their
# recurrent state overwritten whole
MIXED = [(6, 4), (9, 6), (6, 5), (13, 7), (4, 2)]


def _mixed(engine, n_layers, port_cls=None):
    cfg_j, pj, cfg, pt = models(n_layers)
    prompts = [_tokens(cfg, (1, P), 10 + i) for i, (P, _) in enumerate(MIXED)]
    gens = [g for _, g in MIXED]
    if engine == "contiguous":
        kw = dict(n_slots=2, seg_len=3)
        jcls, tcls = JaxEngine, ServeEngine
    else:
        kw = dict(n_slots=2, seg_len=3, block_len=4,
                  lazy=engine == "paged")
        jcls, tcls = JaxPaged, PagedServeEngine
    want, _ = _serve(jcls, pj, cfg_j, prompts, gens, **kw)
    got, eng = _serve(port_cls or tcls, pt, cfg, prompts, gens,
                      device="cpu", **kw)
    return got, want, gens, eng


@pytest.mark.parametrize("engine", ["paged", "paged-eager", "contiguous"])
@pytest.mark.parametrize("n_layers", LAYERS)
def test_mixed_traffic_token_identical(n_layers, engine):
    got, want, gens, eng = _mixed(engine, n_layers)
    assert got == want
    assert all(len(got[u]) == g for u, g in enumerate(gens))
    if engine != "contiguous":
        assert eng.stats["fresh_blocks"] > 0
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_stale_recurrent_state_breaks_the_engine_check(engine, monkeypatch):
    """Admission that leaves a reused slot's Mamba-2 state and conv tails
    as the last request left them must change the tokens."""
    if engine == "paged":
        own = M.scatter_prefill_paged

        def keep_state(cfg, cache, sub, slot, ids, mask, *, block_len):
            stale = {k: cache[k] for k in ("mamba", "tail") if k in cache}
            saved = {k: M._map(torch.clone, v) for k, v in stale.items()}
            own(cfg, cache, sub, slot, ids, mask, block_len=block_len)
            for k, v in saved.items():
                M._map(lambda d, s: d.copy_(s), cache[k], v)
            return cache
        monkeypatch.setattr(M, "scatter_prefill_paged", keep_state)
    else:
        def keep_state(cache, sub, slot, axes):
            for k, t in cache["attn"].items():
                ax = axes["attn"][k]
                t.select(ax, slot).copy_(sub["attn"][k].select(ax, 0))
            return cache
        monkeypatch.setattr(engine_mod, "_scatter_slot_row", keep_state)
    got, want, _, _ = _mixed(engine, 5)
    assert got != want


def test_admission_overwrites_the_slot_whole():
    """A slot's Mamba-2 state and conv tails after admission equal a
    fresh prefill's, whatever the slot held before; the other slot's
    stay as they were."""
    _, _, cfg, pt = models(5)
    eng = PagedServeEngine(pt, cfg, n_slots=2, max_len=40, block_len=4,
                           device="cpu")
    for key in ("mamba", "tail"):
        for t in eng.cache[key].values():
            t.fill_(7.0)
    toks = _tokens(cfg, (1, 12), seed=2)
    eng.submit({"tokens": toks}, max_new=3)
    eng._admit()
    slot = int(np.flatnonzero(eng.slot_uid >= 0)[0])
    _, pc = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    for key, bax in (("mamba", 2), ("tail", 1)):
        for k, t in eng.cache[key].items():
            torch.testing.assert_close(t.select(bax, slot),
                                       pc[key][k].select(bax, 0),
                                       atol=0, rtol=0)
            assert bool((t.select(bax, 1 - slot) == 7.0).all())


def test_prefix_sharing_traffic():
    """A shared preamble through a pool too small for worst-case
    admission: the same tokens and block accounting as the reference."""
    cfg_j, pj, cfg, pt = models(5)
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab_size, (1, 8))
    gens = [5, 7, 4, 6, 5, 3]
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (1, 4))],
                              1).astype(np.int32) for _ in gens]
    kw = dict(n_slots=4, seg_len=3, block_len=4, n_blocks=14)
    want, jeng = _serve(JaxPaged, pj, cfg_j, prompts, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, prompts, gens, device="cpu",
                      **kw)
    assert got == want
    assert eng.stats["shared_blocks"] == jeng.stats["shared_blocks"] > 0
    assert eng.stats["peak_live_blocks"] == jeng.stats["peak_live_blocks"]
    assert eng.alloc.n_free == 13


def test_preemption_replays_identically():
    cfg_j, pj, cfg, pt = models(5)
    prompts = [_tokens(cfg, (1, 8), 20 + i) for i in range(3)]
    gens = [12, 12, 12]
    kw = dict(n_slots=3, seg_len=4, block_len=4, n_blocks=11)
    want, jeng = _serve(JaxPaged, pj, cfg_j, prompts, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, prompts, gens, device="cpu",
                      **kw)
    assert got == want
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert eng.alloc.n_free == eng.alloc.n_blocks - 1


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [True, False])
def test_launcher_serves_zamba2_on_the_cpu(paged):
    from repro_torch.launch import serve
    comps = serve.main(["--arch", "zamba2-7b", "--device", "cpu",
                        "--mixed", "--requests", "3", "--prompt-len", "12",
                        "--gen", "6"] + (["--paged"] if paged else []))
    assert [len(c.tokens) for _, c in sorted(comps.items())] == [6, 3, 2]


def test_launcher_trains_zamba2_on_the_cpu():
    from repro_torch.launch import train
    losses = train.main(["--arch", "zamba2-7b", "--variant", "reduced",
                         "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "32"])
    assert len(losses) == 3 and all(np.isfinite(losses))
