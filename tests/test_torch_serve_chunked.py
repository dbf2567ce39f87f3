"""Bucketed chunked admission of the port against the JAX reference.

Reduced configs in f32, the reference's weights converted: tinyllama,
starcoder2 (dense), qwen2-moe and deepseek-moe-16b (MoE, the latter
behind its leading dense layer), mamba2 (ssm) and zamba2 at 5 layers
(hybrid: two groups and a one-block tail).  The reference runs with
``mesh=None`` and ``use_pallas=False``; the port on its kernel path
(``use_kernels``: the kernels' plain versions on CPU tensors; at a
chunk of at most 12 tokens a reduced MoE's capacity max(ceil(T·k/E)·2,
8) >= T holds every assignment, so nothing drops).

* (a) ``serve/bucketing.py`` against the reference's on a hypothesis
  sweep, the never-truncate property and the validation errors;
* (b) ``prefill_chunked``: the last real token's logits and every cache
  leaf against the reference's, contiguous (two rows of different
  lengths) and paged (a rung past the prompt's blocks, so pads write
  into the trash block), at chunk 4 with pads in the last chunk and at
  chunk 12, which does not divide ``ssm_chunk`` 32 (the scan's chunk is
  then the prefill chunk).  Tolerance: 1e-4 absolute and relative, as
  ``tests/test_torch_ssm.py`` (f32 sums in other orders, values O(1));
  the trash block's rows are not compared (duplicate pad writes land
  there in either order);
* (c) bucket pads leave the Mamba-2 state and conv tail bit-identical to
  a run with poisoned pads, at B 2 with two different ``n_valid``, and
  within the tolerance of one-shot prefill; ignoring ``n_valid`` must
  break it;
* (d) both bucketed engines' greedy tokens against the JAX bucketed
  engines and against the port's unbucketed engine, on mixed lengths,
  prefix-shared traffic, preemption, eager blocks, int8 KV and a rung
  past ``max_len``, the pool drained after;
* (e) a reused slot: the second request's admission logits bit-identical
  to a fresh engine's, and skipping the zeroing of the recurrent leaves
  must break it;
* (f) ``launch/serve.py --bucket --chunk-len 4 --check-unbucketed``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serve import PagedServeEngine as JaxPaged
from repro.serve import ServeEngine as JaxEngine
from repro.serve import bucketing as jbk
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.serve import PagedServeEngine, ServeEngine
from repro_torch.serve import bucketing as bk

from test_torch_simulation import fast_reference_compiles, port_cfg

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["tinyllama-1.1b", "starcoder2-3b", "qwen2-moe-a2.7b",
         "deepseek-moe-16b", "mamba2-1.3b", "zamba2-7b"]
RECURRENT = ["mamba2-1.3b", "zamba2-7b"]


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
    """The reference's reduced config (plain path) and weights, the port's
    config (kernel path) and the converted weights; zamba2 at 5 layers."""
    if arch not in _MODELS:
        over = {"n_layers": 5} if arch == "zamba2-7b" else {}
        cfg_j = jax_config(arch, variant="reduced").replace(
            use_pallas=False, **over)
        cfg = get_config(arch, variant="reduced").replace(**over)
        assert cfg == port_cfg(cfg_j).replace(use_kernels=True)
        pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[arch] = (cfg_j, pj, cfg, pt)
    return _MODELS[arch]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _padded(toks, lens, T):
    """Rows of ``toks`` cut to ``lens`` and right-padded with 0 to T."""
    out = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        out[b, :n] = toks[b, :n]
    return out


def _flat(tree):
    return {p: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for p, v in convert.flatten(tree).items()}


def _assert_caches_close(cfg, got, want, paged):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    seq = convert.flatten(M.decode_cache_seq_axes(cfg))
    for path, w in want.items():
        g = got[path]
        if paged and seq[path] >= 0:
            # the pools (stacked, n_blocks, block_len, ...): not the trash
            # block, where pads' duplicate writes land in either order
            g, w = g[:, 1:], w[:, 1:]
        np.testing.assert_allclose(g, w, **TOL, err_msg=path)


# ---------------------------------------------------------------------------
# (a) bucket ladders
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(chunk=st.integers(1, 64), max_len=st.integers(1, 5000),
       length=st.integers(0, 9000),
       ladder=st.lists(st.integers(-3, 40), min_size=0, max_size=6))
def test_bucketing_matches_reference(chunk, max_len, length, ladder):
    default = bk.bucket_ladder(chunk, max_len)
    assert default == jbk.bucket_ladder(chunk, max_len)
    custom = [r * chunk for r in ladder]
    try:
        want = jbk.validate_ladder(custom, chunk)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            bk.validate_ladder(custom, chunk)
        custom = default
    else:
        assert bk.validate_ladder(custom, chunk) == want
        custom = want
    for rungs in (default, custom):
        got = bk.bucket_for(length, rungs, chunk)
        assert got == jbk.bucket_for(length, rungs, chunk)
        assert got >= length and got % chunk == 0   # never truncates
        assert got in rungs or got > max(rungs)


def test_bucketing_errors_match_reference():
    for args, fn in [((0, 8), "bucket_ladder"), (([], 4), "validate_ladder"),
                     (([8, 6], 4), "validate_ladder"),
                     (([0], 4), "validate_ladder"),
                     ((-1, [4], 4), "bucket_for")]:
        with pytest.raises(ValueError) as want:
            getattr(jbk, fn)(*args)
        with pytest.raises(ValueError, match=str(want.value)):
            getattr(bk, fn)(*args)


# ---------------------------------------------------------------------------
# (b) prefill_chunked against the reference's
# ---------------------------------------------------------------------------

def _chunked_pair(arch, layout, C):
    """The reference's and the port's prefill_chunked on one batch: two
    rows of 9 and 6 tokens in a contiguous cache of capacity 16, or one
    row of 9 tokens through a paged table one block wider than the
    prompt's (block_len 4: blocks 3, 6, 1, then the trash block)."""
    cfg_j, pj, cfg, pt = models(arch)
    toks = _tokens(cfg, (2, 9), seed=5)
    if layout == "contiguous":
        lens, T = [9, 6], -(-9 // C) * C
        cj = JM.init_decode_cache(cfg_j, 2, 16)
        ct = M.init_decode_cache(cfg, 2, 16, device="cpu")
        tab = {}
    else:
        lens, T, bl = [9], 16 if C == 4 else 12, 4
        toks = toks[:1]
        cj = JM.init_paged_cache(cfg_j, 1, 8, bl)
        ct = M.init_paged_cache(cfg, 1, 8, bl, device="cpu")
        tab = {"block_tables": np.array([[3, 6, 1, 0][:T // bl]], np.int32)}
    batch = _padded(toks, lens, T)
    lj, cj = JM.prefill_chunked(
        pj, cfg_j, cj, {"tokens": jnp.asarray(batch)},
        jnp.asarray(lens, jnp.int32), chunk_len=C,
        **{k: jnp.asarray(v) for k, v in tab.items()})
    lt, ct = M.prefill_chunked(
        pt, cfg, ct, {"tokens": torch.as_tensor(batch)}, lens, chunk_len=C,
        **{k: torch.as_tensor(v) for k, v in tab.items()})
    return cfg, lj, cj, lt, ct


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("C", [4, 12])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunked_matches_reference(arch, C, layout):
    cfg, lj, cj, lt, ct = _chunked_pair(arch, layout, C)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_caches_close(cfg, ct, cj, paged=layout == "paged")


def test_prefill_chunked_refuses_a_ragged_pad():
    _, _, cfg, pt = models("tinyllama-1.1b")
    with pytest.raises(ValueError, match="multiple of chunk_len 4"):
        M.prefill_chunked(pt, cfg, M.init_decode_cache(cfg, 1, 8,
                                                       device="cpu"),
                          {"tokens": torch.zeros((1, 6), dtype=torch.int32)},
                          5, chunk_len=4)


# ---------------------------------------------------------------------------
# (c) pads freeze the recurrent state
# ---------------------------------------------------------------------------

def _pad_leak(arch):
    """prefill_chunked at B 2 (7 and 5 real tokens, chunk 4, padded to 8)
    with pads 0 and with pads vocab-1: the largest difference of any
    recurrent leaf; and the largest difference of those leaves from
    one-shot prefill's, row by row."""
    _, _, cfg, pt = models(arch)
    lens, toks = [7, 5], _tokens(cfg, (2, 8), seed=9)
    states = []
    for pad in (0, cfg.vocab_size - 1):
        batch = _padded(toks, lens, 8)
        for b, n in enumerate(lens):
            batch[b, n:] = pad
        _, c = M.prefill_chunked(pt, cfg,
                                 M.init_decode_cache(cfg, 2, 8, device="cpu"),
                                 {"tokens": torch.as_tensor(batch)}, lens,
                                 chunk_len=4)
        seq = convert.flatten(M.decode_cache_seq_axes(cfg))
        states.append({p: v for p, v in convert.flatten(c).items()
                       if seq[p] < 0})
    leak = max((a - states[1][p]).abs().max().item()
               for p, a in states[0].items())
    off = 0.0
    bat = convert.flatten(M.decode_cache_batch_axes(cfg))
    for b, n in enumerate(lens):
        _, pc = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks[b:b + 1,
                                                                   :n])})
        one = convert.flatten(M.prefill_into_cache(
            cfg, M.init_decode_cache(cfg, 1, 8, device="cpu"), pc))
        for p, a in states[0].items():
            off = max(off, (a.select(bat[p], b) - one[p].select(bat[p], 0)
                            ).abs().max().item())
    return leak, off


@pytest.mark.parametrize("arch", RECURRENT)
def test_chunked_state_freezes_pads(arch):
    leak, off = _pad_leak(arch)
    assert leak == 0.0
    assert off <= 1e-4


@pytest.mark.parametrize("arch", RECURRENT)
def test_ignoring_n_valid_breaks_the_pad_check(arch, monkeypatch):
    own = ssm.ssm_prefill_chunk
    monkeypatch.setattr(ssm, "ssm_prefill_chunk",
                        lambda p, cfg, x, cache, n_valid=None:
                        own(p, cfg, x, cache))
    leak, off = _pad_leak(arch)
    assert leak > 1e-3 and off > 1e-3


# ---------------------------------------------------------------------------
# (d) the bucketed engines against the JAX bucketed engines
# ---------------------------------------------------------------------------

def _serve(cls, params, cfg, prompts, gens, max_len=None, **kw):
    max_len = max_len or max(p.shape[1] + g for p, g in zip(prompts, gens))
    jax_side = cls in (JaxPaged, JaxEngine)
    if not jax_side:
        kw["device"] = "cpu"
    eng = cls(params, cfg, max_len=max_len, **kw)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": jnp.asarray(p) if jax_side else p}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


def _three_ways(arch, paged, prompts, gens, **kw):
    """Tokens of the JAX bucketed engine, the port's bucketed engine and
    the port's unbucketed engine on one traffic; the port's bucketed
    engine, checked drained."""
    cfg_j, pj, cfg, pt = models(arch)
    jcls, pcls = (JaxPaged, PagedServeEngine) if paged else (JaxEngine,
                                                             ServeEngine)
    bkw = {k: kw.pop(k) for k in ("chunk_len", "buckets") if k in kw}
    want, _ = _serve(jcls, pj, cfg_j, prompts, gens, **bkw, **kw)
    got, eng = _serve(pcls, pt, cfg, prompts, gens, **bkw, **kw)
    plain, _ = _serve(pcls, pt, cfg, prompts, gens, **kw)
    assert eng.chunk_len == bkw["chunk_len"]
    if paged:
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1
        assert not eng._slot_blocks
    assert got == want
    assert got == plain
    assert all(len(got[u]) == g for u, g in enumerate(gens))
    return eng


MIXED = [(6, 4), (9, 6), (6, 5), (13, 7), (4, 2)]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-7b"])
def test_bucketed_engines_match_reference(arch, paged):
    _, _, cfg, _ = models(arch)
    prompts = [_tokens(cfg, (1, P), 10 + i) for i, (P, _) in enumerate(MIXED)]
    gens = [g for _, g in MIXED]
    kw = dict(n_slots=2, seg_len=3, chunk_len=4)
    if paged:
        kw["block_len"] = 4
    eng = _three_ways(arch, paged, prompts, gens, **kw)
    assert eng.buckets == (4, 8, 16, 32)
    # the rungs' all-pad chunks (9 and 13 tokens take rung 16) are not run
    assert eng.stats["prefill_chunks"] == sum(-(-P // 4) for P, _ in MIXED)


def test_prefix_sharing_is_never_rewritten():
    """A shared preamble through a small pool: an admission that reads a
    pooled block writes its rows to the trash block, so the block's bytes
    do not change under it."""
    _, _, cfg, _ = models("tinyllama-1.1b")
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab_size, (1, 8))
    gens = [5, 7, 4, 6, 5, 3]
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (1, 4))],
                              1).astype(np.int32) for _ in gens]
    shared, own = [], M.prefill_chunked

    def watch(params, c, cache, batch, prompt_len, **kw):
        read, write = kw["block_tables"][0], kw["write_tables"][0]
        ids = [r for r, w in zip(read.tolist(), write.tolist()) if r and not w]
        pools = [leaf for leaf in M._leaves(cache) if leaf.dim() == 5]
        before = [p[:, ids].clone() for p in pools]
        out = own(params, c, cache, batch, prompt_len, **kw)
        assert all(torch.equal(p[:, ids], b) for p, b in zip(pools, before))
        shared.extend(ids)
        return out
    M.prefill_chunked = watch
    try:
        eng = _three_ways("tinyllama-1.1b", True, prompts, gens, n_slots=4,
                          seg_len=3, block_len=4, n_blocks=14, chunk_len=4)
    finally:
        M.prefill_chunked = own
    assert eng.stats["shared_blocks"] == len(shared) > 0


@pytest.mark.parametrize("case", ["preemption", "eager", "int8"])
def test_bucketed_paged_engine_cases(case):
    _, _, cfg, _ = models("tinyllama-1.1b")
    if case == "preemption":
        prompts = [_tokens(cfg, (1, 8), 20 + i) for i in range(3)]
        gens = [12, 12, 12]
        kw = dict(n_slots=3, seg_len=4, block_len=4, n_blocks=11)
    else:
        prompts = [_tokens(cfg, (1, P), 10 + i)
                   for i, (P, _) in enumerate(MIXED)]
        gens = [g for _, g in MIXED]
        kw = dict(n_slots=2, seg_len=3, block_len=4,
                  **({"lazy": False} if case == "eager"
                     else {"kv_dtype": "int8"}))
    eng = _three_ways("tinyllama-1.1b", True, prompts, gens, chunk_len=4,
                      **kw)
    if case == "preemption":
        assert eng.stats["preemptions"] > 0
    if case == "int8":
        assert eng.cache["blocks"]["sub0"]["k"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b"])
def test_rung_past_max_len(arch):
    """A 9-token prompt with 3 new tokens in a contiguous cache of 12
    rows, chunk 8: the rung, 16, passes max_len, and the pads past it
    are not written."""
    _, _, cfg, _ = models(arch)
    prompts = [_tokens(cfg, (1, 9), 31), _tokens(cfg, (1, 5), 32)]
    eng = _three_ways(arch, False, prompts, [3, 4], n_slots=1, seg_len=2,
                      chunk_len=8)
    assert eng.max_len == 12 and eng._bucket_rung(9) == 16


def test_bucketed_engine_rejects_oversized_request():
    _, _, cfg, pt = models("tinyllama-1.1b")
    eng = ServeEngine(pt, cfg, n_slots=1, max_len=16, chunk_len=4,
                      device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        eng.submit({"tokens": np.zeros((1, 12), np.int32)}, max_new=8)


# ---------------------------------------------------------------------------
# (e) a reused slot's stale state
# ---------------------------------------------------------------------------

def _second_admission_logits(arch, paged):
    """Admission logits of request 1 served after request 0 through one
    slot, and of request 1 alone in a fresh engine."""
    _, _, cfg, pt = models(arch)
    prompts = [_tokens(cfg, (1, 11), 40), _tokens(cfg, (1, 6), 41)]
    logits, own = [], M.prefill_chunked

    def record(*a, **kw):
        out = own(*a, **kw)
        logits.append(out[0].clone())
        return out
    M.prefill_chunked = record
    try:
        for ps in (prompts, prompts[1:]):
            _serve(PagedServeEngine if paged else ServeEngine, pt, cfg, ps,
                   [3] * len(ps), max_len=16, n_slots=1, seg_len=2,
                   chunk_len=4)
    finally:
        M.prefill_chunked = own
    return logits[1], logits[2]


@pytest.mark.parametrize("arch,paged", [("mamba2-1.3b", False),
                                        ("zamba2-7b", True)])
def test_reused_slot_starts_clean(arch, paged):
    reused, fresh = _second_admission_logits(arch, paged)
    assert torch.equal(reused, fresh)


@pytest.mark.parametrize("arch,paged", [("mamba2-1.3b", False),
                                        ("zamba2-7b", True)])
def test_skipping_the_zeroing_breaks_the_reuse_check(arch, paged,
                                                     monkeypatch):
    monkeypatch.setattr(M, "_zero_recurrent", lambda cfg, cache: None)
    reused, fresh = _second_admission_logits(arch, paged)
    assert (reused - fresh).abs().max().item() > 1e-3


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,paged", [("tinyllama-1.1b", True),
                                        ("tinyllama-1.1b", False),
                                        ("mamba2-1.3b", False)])
def test_launcher_bucketed_check_unbucketed(arch, paged, capsys):
    from repro_torch.launch import serve
    comps = serve.main(["--arch", arch, "--device", "cpu", "--mixed",
                        "--requests", "3", "--prompt-len", "12", "--gen",
                        "6", "--bucket", "--chunk-len", "4",
                        "--check-unbucketed"]
                       + (["--paged"] if paged else []))
    assert [len(c.tokens) for _, c in sorted(comps.items())] == [6, 3, 2]
    out = capsys.readouterr().out
    assert "bucketed: chunk_len=4 ladder=[4, 8, 16, 32]" in out
    assert "check-unbucketed: completions match" in out
