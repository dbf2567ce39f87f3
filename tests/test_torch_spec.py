"""Speculative MTP decode in the port against the JAX reference, on the
CPU.

The reference's SPEC_CASES, reduced and in f32 with the reference's
weights converted: DeepSeek-V3 as shipped (MLA, MoE, its own MTP head),
TinyLlama with ``n_mtp=1`` (GQA: the draft block through kernel 1 at
S 1 and the verify chunk through kernel 2 at C = k+1, their plain
versions here) and Qwen2-MoE with ``n_mtp=1`` (the verify chunk's MoE
routing under its live mask; at top-2 of 4 experts the capacity
max(ceil(T·k/E)·2, 8) >= T, so nothing drops).  The reference runs with
``mesh=None`` and ``use_pallas=False``, the port on its kernel path.

* ``generate(speculate=k)``, k in {1, 3}: ``tokens``, ``valid``,
  ``next_tok``, ``pos``, ``remaining`` and ``done`` equal the
  reference's exactly; ``h_spec`` and every cache leaf within
  ``SPEC_TOL`` (the C-wide verify chunk sums in other shapes than the
  reference's); rows past each slot's frontier exactly zero, contiguous
  and paged, and on an int8 pool its scales too;
* ``_mtp_draft`` chained to depth 3, its logits and hidden within
  ``SPEC_TOL`` of the reference's on the same inputs (greedy
  verification would hide a wrong drafter in the tokens); a swapped
  concat, a missing ``norm`` and ``final_norm`` before the head each
  break it;
* ``prefill(return_hidden=True)``; the acceptance-length properties;
  the full-capacity overshoot (``_spec_spare``); the warm and cold
  ``h_spec`` at admission;
* the port's speculative engines (both, unbucketed and bucketed) equal
  its plain engines token for token on the three cases, and the JAX
  speculative engines on one case each; an oracle drafter accepting
  every draft; reduced PaliGemma with ``n_mtp=1`` (loss, MTP loss and
  every gradient; speculative serving); the launcher's
  ``--speculate --check-unspeculated``; the ``ValueError`` without an
  MTP head.
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
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine, ServeEngine

from test_torch_simulation import fast_reference_compiles

# speculative against the reference's speculative decode: the same
# function summed in other shapes (the verify chunk's C rows), f32
SPEC_TOL = dict(atol=1e-4, rtol=1e-3)
SPEC_CASES = [
    ("deepseek-v3-671b", {}),
    ("tinyllama-1.1b", {"n_mtp": 1}),
    ("qwen2-moe-a2.7b", {"n_mtp": 1}),
]
IDS = [a for a, _ in SPEC_CASES]


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


def models(arch, over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        cfg_j = jax_config(arch, variant="reduced").replace(
            use_pallas=False, **over)
        cfg = get_config(arch, variant="reduced").replace(**over)
        pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[key] = (cfg_j, pj, cfg, pt)
    return _MODELS[key]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _emitted(res):
    t, v = np.asarray(res["tokens"]), np.asarray(res["valid"])
    return [t[b][v[b]].tolist() for b in range(t.shape[0])]


def _pool_leaves(cfg, cache):
    """(path, leaf) of every leaf with a sequence axis."""
    seq = convert.flatten(M.decode_cache_seq_axes(
        cfg, M.quant.policy_of(cache)))
    return [(p, leaf) for p, leaf in convert.flatten(cache).items()
            if seq[p] >= 0]


def _assert_zero_past(cfg, cache, fpos, tables=None, bl=None):
    """Every row of every sequence leaf past each slot's frontier is
    exactly zero (contiguous: (stack, B, S, ...); paged: through the
    slot's table)."""
    for path, leaf in _pool_leaves(cfg, cache):
        for b, p in enumerate(fpos):
            if tables is None:
                rows = leaf[:, b]
            else:
                rows = leaf[:, tables[b]].flatten(1, 2)
            assert not rows[:, p + 1:].any(), (path, b, p)


# ---------------------------------------------------------------------------
# generate: the reference's speculative decode, contiguous and paged
# ---------------------------------------------------------------------------

B, P, MAX_NEW, STEPS = 2, 6, 24, 12
REM = np.array([15, 9], np.int32)   # the second slot finishes mid-run


def _prefilled(arch, over):
    cfg_j, pj, cfg, pt = models(arch, over)
    toks = _tokens(cfg, (B, P), seed=2)
    lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    _, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    tok0 = np.argmax(np.asarray(lj), -1).astype(np.int32)
    pos0 = np.full((B,), M.decode_pos0(cfg, P), np.int32)
    return pcj, pct, tok0, pos0


def _compare(res_t, res_j):
    assert _emitted(res_t) == _emitted(res_j)
    for key in ("tokens", "valid", "next_tok", "pos", "remaining", "done"):
        np.testing.assert_array_equal(res_t[key].numpy(),
                                      np.asarray(res_j[key]), err_msg=key)
    np.testing.assert_allclose(res_t["h_spec"].numpy(),
                               np.asarray(res_j["h_spec"]), **SPEC_TOL)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("arch,over", SPEC_CASES, ids=IDS)
def test_spec_generate_matches_reference_contiguous(arch, over, k):
    cfg_j, pj, cfg, pt = models(arch, over)
    pcj, pct, tok0, pos0 = _prefilled(arch, over)
    cap = M.decode_capacity(cfg, P, MAX_NEW)
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, B, cap),
                               pcj)
    ct = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, B, cap,
                                                       device="cpu"), pct)
    rj = JM.generate(pj, cfg_j, cj, jnp.asarray(tok0), jnp.asarray(pos0),
                     steps=STEPS, remaining=jnp.asarray(REM), speculate=k)
    rt = M.generate(pt, cfg, ct, torch.as_tensor(tok0),
                    torch.as_tensor(pos0), steps=STEPS,
                    remaining=torch.as_tensor(REM), speculate=k)
    _compare(rt, rj)
    assert rt["tokens"].shape == (B, STEPS * (k + 1))
    got, want = convert.flatten(rt["cache"]), convert.flatten(rj["cache"])
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].numpy(), np.asarray(w),
                                   err_msg=path, **SPEC_TOL)
    _assert_zero_past(cfg, rt["cache"], rt["pos"].tolist())


def _paged(cfg, pc, n_blocks, tables, bl, *, jax_side, policy=None):
    """A paged cache holding the B prefilled rows through ``tables``."""
    n_pb = -(-M.decode_pos0(cfg, P) // bl)
    if jax_side:
        sub = JM.prefill_into_cache(cfg, JM.init_decode_cache(
            cfg, B, n_pb * bl), pc)
        bat = JM.decode_cache_batch_axes(cfg)
        c = JM.init_paged_cache(cfg, B, n_blocks, bl)
        for b in range(B):
            sub_b = jax.tree.map(
                lambda x, ax: jax.lax.index_in_dim(x, b, ax, keepdims=True),
                sub, bat)
            c = JM.scatter_prefill_paged(
                cfg, c, sub_b, b, jnp.asarray(tables[b][:n_pb]),
                jnp.ones((n_pb,), jnp.bool_), block_len=bl)
        return c
    c = M.init_paged_cache(cfg, B, n_blocks, bl, device="cpu", policy=policy)
    for b in range(B):
        sub = M.prefill_into_cache(cfg, M.init_decode_cache(
            cfg, 1, n_pb * bl, device="cpu"),
            M._map(lambda x: x[:, b:b + 1], pc))
        M.scatter_prefill_paged(cfg, c, sub, b, tables[b][:n_pb].tolist(),
                                [True] * n_pb, block_len=bl)
    return c


BL, W = 4, 10


def _tables():
    return np.stack([np.arange(1 + W * b, 1 + W * (b + 1), dtype=np.int32)
                     for b in range(B)])


@pytest.mark.parametrize("arch,over", SPEC_CASES, ids=IDS)
def test_spec_generate_matches_reference_paged(arch, over):
    cfg_j, pj, cfg, pt = models(arch, over)
    pcj, pct, tok0, pos0 = _prefilled(arch, over)
    tables = _tables()
    cj = _paged(cfg_j, pcj, 1 + B * W, tables, BL, jax_side=True)
    ct = _paged(cfg, pct, 1 + B * W, tables, BL, jax_side=False)
    rj = JM.generate(pj, cfg_j, cj, jnp.asarray(tok0), jnp.asarray(pos0),
                     steps=STEPS, remaining=jnp.asarray(REM), speculate=3,
                     block_tables=jnp.asarray(tables))
    rt = M.generate(pt, cfg, ct, torch.as_tensor(tok0),
                    torch.as_tensor(pos0), steps=STEPS,
                    remaining=torch.as_tensor(REM), speculate=3,
                    block_tables=torch.as_tensor(tables))
    _compare(rt, rj)
    got, want = convert.flatten(rt["cache"]), convert.flatten(rj["cache"])
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        if path in dict(_pool_leaves(cfg, rt["cache"])):
            g, w = g[:, 1:], w[:, 1:]     # not the trash block
        np.testing.assert_allclose(g, w, err_msg=path, **SPEC_TOL)
    _assert_zero_past(cfg, rt["cache"], rt["pos"].tolist(), tables, BL)


def test_spec_scrubs_an_int8_pool():
    """On an int8 pool the rows and the scales past the frontier are
    zero, and the speculative tokens equal plain decode's on the same
    pool."""
    arch, over = SPEC_CASES[1]
    _, _, cfg, pt = models(arch, over)
    _, pct, tok0, pos0 = _prefilled(arch, over)
    tables = _tables()
    pol = M.quant.CachePolicy("int8")
    runs = []
    for k in (0, 3):
        c = _paged(cfg, pct, 1 + B * W, tables, BL, jax_side=False,
                   policy=pol)
        runs.append(M.generate(pt, cfg, c, torch.as_tensor(tok0),
                               torch.as_tensor(pos0), steps=STEPS,
                               remaining=torch.as_tensor(REM), speculate=k,
                               block_tables=torch.as_tensor(tables)))
    assert _emitted(runs[1]) == _emitted(runs[0])
    assert {p for p, _ in _pool_leaves(cfg, runs[1]["cache"])} == {
        "blocks/sub0/" + n for n in ("k", "v", "k_scale", "v_scale")}
    _assert_zero_past(cfg, runs[1]["cache"], runs[1]["pos"].tolist(),
                      tables, BL)


def test_prefill_return_hidden_matches_reference():
    arch, over = SPEC_CASES[0]
    cfg_j, pj, cfg, pt = models(arch, over)
    toks = _tokens(cfg, (B, P), seed=2)
    (lj, hj), _ = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                             return_hidden=True)
    (lt, ht), _ = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)},
                            return_hidden=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **SPEC_TOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **SPEC_TOL)
    plain, _ = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    assert torch.equal(plain, lt)


# ---------------------------------------------------------------------------
# the drafter: one MTP block at one position, chained
# ---------------------------------------------------------------------------

DRAFT_POS = np.array([5, 9], np.int32)


def _faulty_draft(fault):
    """The port's drafter with one planted fault."""
    def draft(params, cfg, h, tok, pos):
        mp = params["mtp"]
        hn = (h[:, None] if fault == "no_norm"
              else M.layers.apply_norm(mp["norm"], h[:, None]))
        emb = M._embed(params, cfg, tok[:, None]).to(h.dtype)
        hin = M.layers.mm(torch.cat([emb, hn] if fault == "concat_swapped"
                                    else [hn, emb], dim=-1), mp["proj"])
        hout, _, _ = M._block_full(mp["block"], cfg, hin, pos[:, None],
                                   kind="full")
        if fault == "final_norm":
            hout = M.layers.apply_norm(params["final_norm"], hout)
        return M._head(params, cfg, hout)[:, 0], hout[:, 0]
    return draft


_DRAFT_REF = {}


def _draft_reference(arch, over, k=3):
    """The reference's chain from a seeded hidden and token: per depth
    (the token fed, the position, logits, hidden); each depth feeds its
    greedy draft to the next, as ``_generate_spec`` chains."""
    if arch not in _DRAFT_REF:
        cfg_j, pj, cfg, _ = models(arch, over)
        h = jnp.asarray(_draft_h0(cfg))
        tok = jnp.asarray(_tokens(cfg, (B,), seed=5))
        chain = []
        for j in range(k):
            pos = jnp.asarray(np.maximum(DRAFT_POS - 1 + j, 0))
            logits, h_next = JM._mtp_draft(pj, cfg_j, h, tok, pos)
            chain.append((np.array(tok), np.array(pos),
                          np.asarray(logits), np.asarray(h_next)))
            h, tok = h_next, jnp.argmax(logits, -1).astype(jnp.int32)
        _DRAFT_REF[arch] = chain
    return _DRAFT_REF[arch]


def _draft_h0(cfg):
    return np.random.default_rng(4).standard_normal(
        (B, cfg.d_model)).astype(np.float32)


def _check_draft_chain(draft, arch, over):
    _, _, cfg, pt = models(arch, over)
    h = torch.as_tensor(_draft_h0(cfg))
    for tok, pos, want_l, want_h in _draft_reference(arch, over):
        logits, h = draft(pt, cfg, h, torch.as_tensor(tok),
                          torch.as_tensor(pos))
        np.testing.assert_allclose(logits.numpy(), want_l, **SPEC_TOL)
        np.testing.assert_allclose(h.numpy(), want_h, **SPEC_TOL)


@pytest.mark.parametrize("arch,over", SPEC_CASES, ids=IDS)
def test_mtp_draft_matches_reference(arch, over):
    _check_draft_chain(M._mtp_draft, arch, over)


@pytest.mark.parametrize("fault", ["concat_swapped", "no_norm",
                                   "final_norm"])
@pytest.mark.parametrize("arch,over", SPEC_CASES, ids=IDS)
def test_mtp_draft_faults_break_the_check(arch, over, fault):
    with pytest.raises(AssertionError):
        _check_draft_chain(_faulty_draft(fault), arch, over)


@pytest.mark.parametrize("k", [2, 4])
def test_acceptance_length_properties(k):
    arch, over = SPEC_CASES[0]
    _, _, cfg, pt = models(arch, over)
    _, pct, tok0, pos0 = _prefilled(arch, over)
    rem = np.array([21, 7], np.int32)
    cache = M.prefill_into_cache(cfg, M.init_decode_cache(
        cfg, B, M.decode_capacity(cfg, P, MAX_NEW), device="cpu"), pct)
    res = M.generate(pt, cfg, cache, torch.as_tensor(tok0),
                     torch.as_tensor(pos0), steps=STEPS,
                     remaining=torch.as_tensor(rem), speculate=k)
    valid = res["valid"].numpy()
    C = k + 1
    for b in range(B):
        per_step = valid[b].reshape(-1, C)
        alive = per_step.sum(1) > 0
        assert all(per_step[alive, 0]) and per_step.sum(1).max() <= C
        first_dead = np.argmin(alive) if not alive.all() else len(alive)
        assert not per_step[first_dead:].any()
        if not alive.all():
            assert valid[b].sum() == rem[b]
        else:
            assert valid[b].sum() < rem[b]


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

TRAFFIC = [(6, 8), (9, 12), (7, 10), (11, 6)]


def _batches(cfg, traffic=TRAFFIC, seed=10):
    out = []
    for i, (p, _) in enumerate(traffic):
        rng = np.random.default_rng(seed + i)
        b = {"tokens": rng.integers(0, cfg.vocab_size, (1, p)).astype(
            np.int32)}
        if cfg.arch_type == "vlm":
            b["patches"] = (rng.standard_normal(
                (1, cfg.frontend_tokens, cfg.d_model)) * 0.05).astype(
                np.float32)
        out.append(b)
    return out


def _serve(cls, params, cfg, batches, traffic=TRAFFIC, jax_side=False,
           **kw):
    max_len = max(M.decode_capacity(cfg, p, g) for p, g in traffic)
    if jax_side:
        eng = cls(params, cfg, n_slots=2, max_len=max_len, seg_len=3, **kw)
        batches = [{k: jnp.asarray(v) for k, v in b.items()}
                   for b in batches]
    else:
        eng = cls(params, cfg, n_slots=2, max_len=max_len, seg_len=3,
                  device="cpu", **kw)
        batches = [{k: torch.as_tensor(v) if k != "tokens" else v
                    for k, v in b.items()} for b in batches]
    for b, (_, g) in zip(batches, traffic):
        eng.submit(b, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


@pytest.mark.parametrize("arch,over", SPEC_CASES, ids=IDS)
def test_spec_engines_match_plain(arch, over):
    _, _, cfg, pt = models(arch, over)
    batches = _batches(cfg)
    plain, _ = _serve(ServeEngine, pt, cfg, batches)
    runs = [_serve(ServeEngine, pt, cfg, batches, speculate=3),
            _serve(ServeEngine, pt, cfg, batches, speculate=3, chunk_len=4),
            _serve(PagedServeEngine, pt, cfg, batches, speculate=3,
                   block_len=4),
            _serve(PagedServeEngine, pt, cfg, batches, speculate=3,
                   block_len=4, chunk_len=4)]
    for got, eng in runs:
        assert got == plain
        assert eng.stats["spec_steps"] > 0
        assert 0.0 <= eng.spec_acceptance() <= 1.0
        assert eng.stats["slot_steps"] == 2 * 3 * 4 * eng.stats["segments"]


@pytest.mark.parametrize("cls", ["contiguous", "paged"])
def test_jax_spec_engines_match_the_port(cls):
    arch, over = SPEC_CASES[1]
    cfg_j, pj, cfg, pt = models(arch, over)
    batches = _batches(cfg)
    kw = {"block_len": 4} if cls == "paged" else {}
    jcls, pcls = ((JaxPaged, PagedServeEngine) if cls == "paged"
                  else (JaxEngine, ServeEngine))
    want, jeng = _serve(jcls, pj, cfg_j, batches, jax_side=True, speculate=3,
                        **kw)
    got, eng = _serve(pcls, pt, cfg, batches, speculate=3, **kw)
    assert got == want
    assert (eng.stats["spec_steps"], eng.stats["spec_extra_tokens"]) == (
        jeng.stats["spec_steps"], jeng.stats["spec_extra_tokens"])


def test_spec_engine_full_capacity_overshoot():
    """A request generating to its capacity: the last verify chunks
    overshoot its blocks, into the spare trash columns."""
    arch, over = SPEC_CASES[0]
    _, _, cfg, pt = models(arch, over)
    traffic = [(6, 10)]
    batches = _batches(cfg, traffic, seed=3)
    plain, _ = _serve(ServeEngine, pt, cfg, batches, traffic)
    got, eng = _serve(PagedServeEngine, pt, cfg, batches, traffic,
                      block_len=4, speculate=6)
    assert got == plain
    assert eng._spec_spare == 2
    assert eng.block_tables.shape[1] == eng.max_blocks + 2


def test_spec_admission_seeds_the_draft_hidden():
    """Unbucketed admission starts ``h_spec`` from the prefill's last
    hidden; bucketed admission starts it at zero."""
    arch, over = SPEC_CASES[0]
    _, _, cfg, pt = models(arch, over)
    batch = _batches(cfg, [(6, 8)], seed=0)[0]
    warm = ServeEngine(pt, cfg, n_slots=2, max_len=32, seg_len=3,
                       speculate=3, device="cpu")
    warm.submit(batch, max_new=8)
    warm._admit()
    (_, h0), _ = M.prefill(pt, cfg, {"tokens": torch.as_tensor(
        batch["tokens"])}, return_hidden=True)
    assert warm.h_spec[0].abs().sum() > 0
    assert torch.equal(warm.h_spec[0], h0[0])
    cold = ServeEngine(pt, cfg, n_slots=2, max_len=64, seg_len=3,
                       speculate=3, chunk_len=4, device="cpu")
    cold.submit(batch, max_new=8)
    cold._admit()
    assert not cold.h_spec[0].abs().sum()


def _oracle(eng, plain, wrong_lane=None):
    """A drafter proposing each request's plain tokens: a draft called at
    position p proposes the token at p + 2.  With ``wrong_lane`` the
    draft of that chain depth is off by one."""
    calls = []

    def draft(params, cfg, h, tok, pos):
        j = len(calls) % eng.speculate
        calls.append(j)
        logits = torch.zeros((tok.shape[0], cfg.vocab_size))
        for s, uid in enumerate(eng.slot_uid):
            seq = plain.get(int(uid))
            i = int(pos[s]) + 2 - eng._pos0[int(uid)] if seq else -1
            t = seq[i] if 0 <= i < len(seq) else 0
            if j == wrong_lane:
                t = (t + 1) % cfg.vocab_size
            logits[s, t] = 1.0
        return logits, h

    return draft


@pytest.mark.parametrize("wrong_lane", [None, 1])
def test_oracle_drafter_is_accepted(monkeypatch, wrong_lane):
    """Drafts equal to the plain tokens are all accepted (acceptance 1.0,
    k+1 tokens a live step where the budget allows); one wrong chain
    depth gives an acceptance strictly between 0 and 1.  The tokens equal
    plain decode's either way."""
    arch, over = SPEC_CASES[1]
    _, _, cfg, pt = models(arch, over)
    traffic = [(6, 9), (9, 13)]      # 8 and 12 decode emissions: k+1 = 4
    batches = _batches(cfg, traffic)
    plain, _ = _serve(ServeEngine, pt, cfg, batches, traffic)
    max_len = max(M.decode_capacity(cfg, p, g) for p, g in traffic)
    eng = ServeEngine(pt, cfg, n_slots=2, max_len=max_len, seg_len=3,
                      speculate=3, device="cpu")
    eng._pos0 = {}
    for uid, (b, (p, g)) in enumerate(zip(batches, traffic)):
        eng.submit(b, max_new=g)
        eng._pos0[uid] = M.decode_pos0(cfg, p)
    monkeypatch.setattr(M, "_mtp_draft", _oracle(eng, plain, wrong_lane))
    got = {u: c.tokens.tolist() for u, c in eng.run().items()}
    assert got == plain
    if wrong_lane is None:
        assert eng.spec_acceptance() == 1.0
        assert eng.stats["spec_steps"] == sum(
            (g - 1) // 4 for _, g in traffic)
    else:
        assert 0.0 < eng.spec_acceptance() < 1.0


def test_spec_requires_an_mtp_head():
    _, _, cfg, pt = models("tinyllama-1.1b", {})
    for cls in (ServeEngine, PagedServeEngine):
        with pytest.raises(ValueError, match="MTP"):
            cls(pt, cfg, max_len=32, speculate=3, device="cpu")
    one = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="MTP head"):
        M.generate(pt, cfg, {}, one, one, steps=1, speculate=2)


# ---------------------------------------------------------------------------
# the VLM family with an MTP head
# ---------------------------------------------------------------------------

VLM = ("paligemma-3b", {"n_mtp": 1})


def test_vlm_mtp_loss_and_gradients_match_reference():
    cfg_j, pj, cfg, pt = models(*VLM)
    assert "mtp" in pt
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "patches": (rng.standard_normal((2, cfg.frontend_tokens,
                                              cfg.d_model)) * 0.05
                         ).astype(np.float32)}
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, {k: jnp.asarray(v) for k, v in
                                        batch.items()}), has_aux=True)(pj)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in convert.flatten(pt).items()}
    lt, mt = M.loss_fn(convert.unflatten(leaves), cfg,
                       {k: torch.as_tensor(v) for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    np.testing.assert_allclose(mt["mtp_loss"].item(), float(mj["mtp_loss"]),
                               rtol=1e-5)
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(want) == set(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[k], err_msg=k,
                                   atol=1e-5, rtol=1e-4)


def test_vlm_serves_speculatively():
    _, _, cfg, pt = models(*VLM)
    batches = _batches(cfg)
    plain, _ = _serve(PagedServeEngine, pt, cfg, batches, block_len=4)
    for kw in ({}, {"chunk_len": 8}):
        got, eng = _serve(PagedServeEngine, pt, cfg, batches, block_len=4,
                          speculate=3, **kw)
        assert got == plain and eng.stats["spec_steps"] > 0


def test_launcher_checks_unspeculated(capsys):
    launch_serve.main(["--arch", "deepseek-v3-671b", "--device", "cpu",
                       "--paged", "--speculate", "--n-draft", "3",
                       "--check-unspeculated", "--requests", "3",
                       "--prompt-len", "12", "--gen", "6", "--mixed"])
    out = capsys.readouterr().out
    assert "speculative: n_draft=3 acceptance=" in out
    assert "check-unspeculated: completions match" in out
