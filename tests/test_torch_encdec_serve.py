"""Serving Whisper (the encoder-decoder family) in the port against the JAX
reference, on the CPU.

Reduced ``whisper-small`` (2 encoder and 2 decoder layers, d_model 128,
16 stub frames), f32, the reference's weights converted, held to
``TOL`` (1e-4 absolute and relative).  The reference runs with
``mesh=None`` and ``use_pallas=False``, the port on its kernel path (the
kernels' plain versions on CPU tensors).

* prefill, then teacher-forced ``decode_step``s, contiguous and paged:
  the logits against the reference's decode and the full forward's, and
  the three cache entries (``self`` grafted, ``cross`` and ``memory``
  adopted, both without a sequence axis and slot-resident when paged);
* ``prefill_chunked``: the last real token's logits and every cache
  leaf against the reference's, contiguous and paged, and against the
  one-shot prefill; the encoder runs once, not a chunk;
* both engines' greedy tokens equal the JAX ``mesh=None`` engines' on
  mixed traffic in '', bf16, int8 and fp8 pools (``cross`` and
  ``memory`` stay in the model's dtype), bucketed and not, on
  prefix-sharing traffic (requests with equal frames share their full
  prompt blocks, other frames none) and on preemption traffic;
* zeroed frames break the prefill's logits; ``submit`` refuses frames of the
  wrong shape and a request without frames; the launcher serves the
  arch with stub frames.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import quant as jquant
from repro.serve import PagedServeEngine as JaxPaged
from repro.serve import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import model as M
from repro_torch.models import quant
from repro_torch.serve import PagedServeEngine, ServeEngine

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
        cfg_j = jax_config(ARCH, variant="reduced").replace(use_pallas=False)
        cfg = get_config(ARCH, variant="reduced")
        pj = JM.init_params(jax.random.PRNGKey(11), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS["m"] = (cfg_j, pj, cfg, pt)
    return _MODELS["m"]


def _frames(cfg, seed):
    return (np.random.default_rng(seed).standard_normal(
        (1, cfg.frontend_tokens, cfg.d_model)) * 0.05).astype(np.float32)


def _request(cfg, P, seed, frames=None):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (1, P)).astype(
        np.int32), "frames": _frames(cfg, seed + 1000) if frames is None
        else frames}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# prefill, decode and the caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_matches_forward_and_reference(layout):
    """Prefill of 9 tokens, then 4 teacher-forced decode steps on the
    kernel path: each step's logits equal the reference's decode and the
    full forward's at that position; ``cross`` and ``memory`` are the
    prefill's, unchanged by decode."""
    cfg_j, pj, cfg, pt = models()
    P, n, bl = 9, 4, 4
    full = _request(cfg, P + n, seed=13)
    pre = dict(full, tokens=full["tokens"][:, :P])
    cap = M.decode_capacity(cfg, P, n)
    assert (M.decode_offset(cfg), M.decode_pos0(cfg, P), cap) == (0, P,
                                                                   P + n)
    _, pcj = JM.prefill(pj, cfg_j, _jax(pre))
    _, pct = M.prefill(pt, cfg, _torch(pre))
    L, Ta, KH, Dh = (cfg.n_layers, cfg.frontend_tokens, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    assert set(pct) == {"self", "cross", "memory"}
    assert pct["self"]["k"].shape == (L, 1, P, KH, Dh)
    assert pct["cross"]["v"].shape == (L, 1, Ta, KH, Dh)
    assert pct["memory"].shape == (1, Ta, cfg.d_model)
    for path, w in convert.flatten(jax.tree.map(np.asarray, pcj)).items():
        np.testing.assert_allclose(convert.flatten(pct)[path].numpy(), w,
                                   err_msg=path, **TOL)
    bt = None
    if layout == "contiguous":
        cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 1, cap),
                                   pcj)
        ct = M.prefill_into_cache(cfg, M.init_decode_cache(
            cfg, 1, cap, device="cpu"), pct)
    else:
        n_pb, nb = -(-P // bl), -(-cap // bl)
        ids = list(range(1, n_pb + 1))
        bt = np.arange(1, nb + 1, dtype=np.int32)[None]
        # two slots: the request lands in slot 1's cross/memory rows
        cj = JM.scatter_prefill_paged(
            cfg_j, JM.init_paged_cache(cfg_j, 2, nb + 1, bl),
            JM.prefill_into_cache(cfg_j, JM.init_decode_cache(
                cfg_j, 1, n_pb * bl), pcj), 1, jnp.asarray(ids),
            jnp.ones((n_pb,), bool), block_len=bl)
        ct = M.init_paged_cache(cfg, 2, nb + 1, bl, device="cpu")
        assert ct["self"]["k"].shape == (L, nb + 1, bl, KH, Dh)
        assert ct["cross"]["k"].shape == (L, 2, Ta, KH, Dh)
        assert ct["memory"].shape == (2, Ta, cfg.d_model)
        M.scatter_prefill_paged(cfg, ct, M.prefill_into_cache(
            cfg, M.init_decode_cache(cfg, 1, n_pb * bl, device="cpu"), pct),
            1, ids, [True] * n_pb, block_len=bl)
        assert not ct["memory"][0].any()
        bt = np.concatenate([np.zeros_like(bt), bt])   # slot 0: trash
    ht = M.backbone(pt, cfg, _torch(full))[0]
    fwd = M._head(pt, cfg, ht)[0, P - 1:].numpy()
    row = 0 if bt is None else 1
    for j in range(n):
        tok = full["tokens"][:, P + j:P + j + 1]
        pos = np.array([P + j], np.int32)
        kw = {}
        if bt is not None:
            tok, pos = np.concatenate([tok, tok]), np.concatenate([pos, pos])
            kw = {"block_tables": bt}
        lj, cj = JM.decode_step(pj, cfg_j, cj, jnp.asarray(tok),
                                jnp.asarray(pos),
                                **{k: jnp.asarray(v) for k, v in kw.items()})
        lt, ct = M.decode_step(pt, cfg, ct, torch.as_tensor(tok),
                               torch.as_tensor(pos),
                               **{k: torch.as_tensor(v)
                                  for k, v in kw.items()})
        np.testing.assert_allclose(lt[row].numpy(), np.asarray(lj)[row],
                                   **TOL)
        np.testing.assert_allclose(lt[row].numpy(), fwd[j + 1], **TOL)
    np.testing.assert_array_equal(ct["memory"][row].numpy(),
                                  pct["memory"][0].numpy())
    np.testing.assert_array_equal(ct["cross"]["k"][:, row].numpy(),
                                  pct["cross"]["k"][:, 0].numpy())


@pytest.mark.parametrize("kv", ["", "int8", "fp8"])
def test_cache_layout_and_bytes(kv):
    """``self`` follows the policy; ``cross`` and ``memory`` stay in the
    model's dtype with no scale and no sequence axis; the byte counts
    are the leaves' and the reference's."""
    cfg_j, _, cfg, _ = models()
    pol = quant.CachePolicy(kv)
    c = M.init_decode_cache(cfg, 2, 8, device="meta", policy=pol)
    cj = JM.init_decode_cache(cfg_j, 2, 8, policy=jquant.CachePolicy(kv))
    got, want = convert.flatten(c), convert.flatten(cj)
    assert {p: (tuple(t.shape), t.element_size()) for p, t in got.items()} \
        == {p: (a.shape, a.dtype.itemsize) for p, a in want.items()}
    assert c["cross"]["k"].dtype == c["memory"].dtype == torch.float32
    assert ("k_scale" in c["self"]) == (kv in ("int8", "fp8"))
    assert "k_scale" not in c["cross"]
    seq = M.decode_cache_seq_axes(cfg, pol)
    bat = M.decode_cache_batch_axes(cfg, pol)
    assert seq["self"]["k"] == 2 and seq["cross"]["k"] == -1 \
        and seq["memory"] == -1
    assert bat["self"]["k"] == bat["cross"]["k"] == 1 and bat["memory"] == 0
    per_slot = (M.cache_nbytes(cfg, 2, 8, pol) - M.cache_nbytes(cfg, 1, 8,
                                                                pol))
    Ta = cfg.frontend_tokens
    self_row = M.cache_nbytes(cfg, 1, 9, pol) - M.cache_nbytes(cfg, 1, 8,
                                                               pol)
    assert per_slot == 8 * self_row + 4 * (
        2 * cfg.n_layers * Ta * cfg.n_kv_heads * cfg.resolved_head_dim
        + Ta * cfg.d_model)
    assert M.paged_cache_nbytes(cfg, 3, 5, 4, pol) == sum(
        t.numel() * t.element_size() for t in convert.flatten(
            M.init_paged_cache(cfg, 3, 5, 4, device="meta",
                               policy=pol)).values())


def _padded(toks, lens, T):
    out = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        out[b, :n] = toks[b, :n]
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_chunked_matches_reference(layout):
    """Chunks of 8 over prompts of 21 and 13 tokens (contiguous) or 21
    (paged, a permuted table): the last real token's logits and every
    cache leaf against the reference's, and the one-shot prefill's
    logits; the encoder ran once (its flash call count)."""
    cfg_j, pj, cfg, pt = models()
    C, bl = 8, 4
    lens = [21, 13] if layout == "contiguous" else [21]
    reqs = [_request(cfg, 21, 60 + i) for i in range(len(lens))]
    T = -(-21 // C) * C
    batch = {"tokens": _padded(np.concatenate([r["tokens"] for r in reqs]),
                               lens, T),
             "frames": np.concatenate([r["frames"] for r in reqs])}
    if layout == "contiguous":
        cj = JM.init_decode_cache(cfg_j, 2, T + 4)
        ct = M.init_decode_cache(cfg, 2, T + 4, device="cpu")
        # stale state from an earlier request must not leak
        ct["memory"].fill_(3.0)
        ct["cross"]["k"].fill_(3.0)
        tab = {}
    else:
        W = T // bl
        cj = JM.init_paged_cache(cfg_j, 1, W + 2, bl)
        ct = M.init_paged_cache(cfg, 1, W + 2, bl, device="cpu")
        perm = np.random.default_rng(0).permutation(W) + 1
        tab = {"block_tables": perm[None].astype(np.int32)}
    lj, cj = JM.prefill_chunked(pj, cfg_j, cj, _jax(batch),
                                jnp.asarray(lens, jnp.int32), chunk_len=C,
                                **{k: jnp.asarray(v) for k, v in tab.items()})
    from repro_torch.kernels.flash_attention import ops as fa_ops
    n0 = fa_ops.LAUNCHES
    calls = []
    orig = M._encode

    def spy(*a):
        calls.append(1)
        return orig(*a)

    M._encode = spy
    try:
        lt, ct = M.prefill_chunked(pt, cfg, ct, _torch(batch), lens,
                                   chunk_len=C,
                                   **{k: torch.as_tensor(v)
                                      for k, v in tab.items()})
    finally:
        M._encode = orig
    assert calls == [1] and fa_ops.LAUNCHES == n0   # CPU: no launch
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    got, want = convert.flatten(ct), convert.flatten(cj)
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        if tab and path.startswith("self/"):
            g, w = g[:, 1:], w[:, 1:]     # not the trash block
        np.testing.assert_allclose(g, w, err_msg=path, **TOL)
    for b, n in enumerate(lens):
        one = {"tokens": reqs[b]["tokens"][:, :n],
               "frames": reqs[b]["frames"]}
        first, _ = M.prefill(pt, cfg, _torch(one))
        np.testing.assert_allclose(lt[b].numpy(), first[0].numpy(), **TOL)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _serve(cls, params, cfg, batches, gens, **kw):
    """Greedy completions {uid: tokens} of ``cls`` on the batches."""
    max_len = max(M.decode_capacity(cfg, b["tokens"].shape[1], g)
                  for b, g in zip(batches, gens))
    jax_side = cls in (JaxPaged, JaxEngine)
    if not jax_side:
        kw["device"] = "cpu"
    eng = cls(params, cfg, max_len=max_len, **kw)
    for b, g in zip(batches, gens):
        eng.submit(_jax(b) if jax_side else b, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


MIXED = [(11, 6), (5, 4), (17, 7), (8, 3)]


def _mixed():
    _, _, cfg, _ = models()
    return ([_request(cfg, P, 30 + i) for i, (P, _) in enumerate(MIXED)],
            [g for _, g in MIXED])


@pytest.mark.parametrize("kv", ["", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_mixed_traffic_token_identical(engine, kv):
    cfg_j, pj, cfg, pt = models()
    batches, gens = _mixed()
    kw = dict(n_slots=2, seg_len=3, kv_dtype=kv)
    jcls, pcls = JaxEngine, ServeEngine
    if engine == "paged":
        kw["block_len"] = 4
        jcls, pcls = JaxPaged, PagedServeEngine
    want, _ = _serve(jcls, pj, cfg_j, batches, gens, **kw)
    got, eng = _serve(pcls, pt, cfg, batches, gens, **kw)
    assert got == want
    assert [len(got[u]) for u in range(len(gens))] == gens
    assert eng.cache["self"]["k"].dtype == quant.CachePolicy(
        kv).storage_dtype(torch.float32)
    assert eng.cache["cross"]["k"].dtype == eng.cache["memory"].dtype \
        == torch.float32
    if engine == "paged":
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_bucketed_engines_match_reference(engine, kv):
    """Bucketed chunked admission (chunks of 4): the JAX bucketed engine's
    tokens, and the port's unbucketed engine's."""
    cfg_j, pj, cfg, pt = models()
    batches, gens = _mixed()
    kw = dict(n_slots=2, seg_len=3, kv_dtype=kv)
    jcls, pcls = JaxEngine, ServeEngine
    if engine == "paged":
        kw["block_len"] = 4
        jcls, pcls = JaxPaged, PagedServeEngine
    want, _ = _serve(jcls, pj, cfg_j, batches, gens, chunk_len=4, **kw)
    got, eng = _serve(pcls, pt, cfg, batches, gens, chunk_len=4, **kw)
    plain, _ = _serve(pcls, pt, cfg, batches, gens, **kw)
    assert eng.stats["prefill_chunks"] == sum(-(-P // 4) for P, _ in MIXED)
    assert got == want
    assert got == plain


def test_prefix_sharing_is_keyed_by_the_frames():
    """Four requests of one 12-token prompt and one set of frames, two of
    the same prompt with other frames: the four share every full prompt
    block, the two share none of theirs; the tokens and the block
    accounting are the reference's."""
    cfg_j, pj, cfg, pt = models()
    text = _request(cfg, 12, 40)["tokens"]
    f1, f2, f3 = (_frames(cfg, s) for s in (41, 42, 43))
    batches = [{"tokens": text, "frames": f} for f in (f1, f1, f1, f1, f2,
                                                       f3)]
    gens = [5, 5, 4, 6, 5, 5]
    kw = dict(n_slots=6, seg_len=3, block_len=4)
    want, jeng = _serve(JaxPaged, pj, cfg_j, batches, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, batches, gens, **kw)
    assert got == want
    assert got[0] == got[1][:5] and got[0][:4] == got[2]
    n_full = 12 // 4
    assert eng.stats["shared_blocks"] == jeng.stats["shared_blocks"] \
        == 3 * n_full
    eng = PagedServeEngine(pt, cfg, n_slots=6, max_len=24, block_len=4,
                           device="cpu")
    for b in batches:
        eng.submit(b, max_new=5)
    eng._admit()
    held = [eng._slot_blocks[u][:n_full] for u in range(6)]
    assert held[0] == held[1] == held[2] == held[3]
    assert not set(held[4]) & set(held[0])
    assert not set(held[5]) & (set(held[0]) | set(held[4]))


def test_preemption_replays_with_its_frames():
    cfg_j, pj, cfg, pt = models()
    batches = [_request(cfg, 8, 50 + i) for i in range(3)]
    gens = [12, 12, 12]
    kw = dict(n_slots=3, seg_len=4, block_len=4, n_blocks=11)
    want, jeng = _serve(JaxPaged, pj, cfg_j, batches, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, batches, gens, **kw)
    assert got == want
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert eng.alloc.n_free == eng.alloc.n_blocks - 1


def test_zeroed_frames_break_the_prefill_logits():
    """The frames reach what serving reads: the prefill's logits with the
    frames zeroed miss the reference's by far more than ``TOL``."""
    cfg_j, pj, cfg, pt = models()
    req = _request(cfg, 9, 70)
    want, _ = JM.prefill(pj, cfg_j, _jax(req))
    got, _ = M.prefill(pt, cfg, _torch(req))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    zeroed, _ = M.prefill(pt, cfg, _torch(dict(
        req, frames=np.zeros_like(req["frames"]))))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(zeroed.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cls", [ServeEngine, PagedServeEngine])
def test_submit_checks_the_frames(cls):
    _, _, cfg, pt = models()
    eng = cls(pt, cfg, n_slots=1, max_len=16, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    Ta, D = cfg.frontend_tokens, cfg.d_model
    for shape in ((1, Ta - 1, D), (2, Ta, D), (1, Ta, D + 1), (Ta, D)):
        with pytest.raises(ValueError, match="frames must have shape"):
            eng.submit({"tokens": toks, "frames": np.zeros(shape)},
                       max_new=2)
    with pytest.raises(ValueError, match="frames"):
        eng.submit({"tokens": toks}, max_new=2)
    with pytest.raises(ValueError, match="frames"):
        eng.submit({"tokens": toks, "patches": np.zeros((1, Ta, D))},
                   max_new=2)
    eng.submit({"tokens": toks, "frames": np.zeros((1, Ta, D))}, max_new=2)
    assert eng.queue[0].batch["frames"].dtype == torch.float32


def test_launcher_serves_the_arch(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--paged",
                       "--mixed", "--kv-dtype", "int8", "--bucket",
                       "--chunk-len", "4", "--check-unbucketed",
                       "--requests", "3", "--prompt-len", "12", "--gen",
                       "4"])
    assert "check-unbucketed: completions match" in capsys.readouterr().out
    cfg = get_config(ARCH, variant="reduced").replace(dtype="bfloat16")
    batch = launch_serve.prompt_batch(cfg, np.random.default_rng(0), 5)
    assert set(batch) == {"tokens", "frames"}
    assert batch["frames"].shape == (1, cfg.frontend_tokens, cfg.d_model)
    assert batch["frames"].dtype == torch.bfloat16
    assert 0.03 < batch["frames"].float().std().item() < 0.07
