"""Serving DeepSeek-V3 (MLA's latent cache) in the port against the JAX
reference, on the CPU.

Reduced ``deepseek-v3-671b`` (one leading dense layer, one MoE layer of
4 experts top-2 with one shared expert, MLA ranks 32/16/32/32 over 4
heads, an MTP head that serving does not use), f32, the reference's
weights converted.  The reference runs with ``mesh=None`` and
``use_pallas=False`` (its Pallas MoE dispatch needs ``pl.load``, which
the installed JAX lacks), the port on its kernel path (the kernels'
plain versions on CPU tensors; at most 12 rows a step or chunk, so the
capacity max(ceil(T·k/E)·2, 8) >= T holds every assignment).  MLA never
takes the paged kernel: its pools are read through the block-table
gather.

* ``decode_step`` with a dead row in ``live``, contiguous and paged,
  both port paths: logits within 1e-5 + 1e-4 relative (the tolerance of
  ``tests/test_torch_moe.py``);
* ``prefill_chunked``: the last real token's logits and every latent
  cache leaf against the reference's, contiguous and paged, chunks 4
  and 12, within 1e-4 absolute and relative (as
  ``tests/test_torch_serve_chunked.py``; the trash block not compared);
* both engines' greedy tokens equal the JAX ``mesh=None`` engines' on
  mixed-length traffic in full-precision, bf16, int8 and fp8 latent
  pools, on prefix-sharing and preemption traffic, and with bucketed
  admission (also equal to the port's unbucketed engine);
* both speculative engines equal the plain ones; the launcher serves
  the arch.
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
from repro_torch.models import quant
from repro_torch.serve import PagedServeEngine, ServeEngine

from test_torch_simulation import fast_reference_compiles, port_cfg

TOL = dict(atol=1e-5, rtol=1e-4)
CHUNK_TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek-v3-671b"


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
        assert cfg == port_cfg(cfg_j).replace(use_kernels=True)
        pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS["m"] = (cfg_j, pj, cfg, pt)
    return _MODELS["m"]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# decode_step with a dead row
# ---------------------------------------------------------------------------

LIVE = np.array([True, False, True])


def _contiguous_state(P=7, S=12):
    cfg_j, pj, cfg, pt = models()
    toks = _tokens(cfg, (3, P), seed=4)
    lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 3, S), pcj)
    _, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    ct = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 3, S,
                                                       device="cpu"), pct)
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    return cj, ct, None, tok, np.full((3,), P, np.int32)


def _paged_state(bl=4):
    """Requests of 9 and 6 tokens admitted into slots 0 and 2 of a 3-slot
    paged cache in both packages; slot 1 a freed lane on the trash
    block."""
    cfg_j, pj, cfg, pt = models()
    cj = JM.init_paged_cache(cfg_j, 3, 12, bl)
    ct = M.init_paged_cache(cfg, 3, 12, bl, device="cpu")
    tok, pos = np.zeros((3, 1), np.int32), np.zeros((3,), np.int32)
    bt = np.zeros((3, 5), np.int32)
    for slot, P, ids, seed in ((0, 9, [1, 2, 3], 5), (2, 6, [4, 5], 6)):
        toks = _tokens(cfg, (1, P), seed)
        n_pb = -(-P // bl)
        mask = [True] * n_pb
        lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)})
        subj = JM.prefill_into_cache(
            cfg_j, JM.init_decode_cache(cfg_j, 1, n_pb * bl), pcj)
        cj = JM.scatter_prefill_paged(cfg_j, cj, subj, slot,
                                      jnp.asarray(ids), jnp.asarray(mask),
                                      block_len=bl)
        _, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
        subt = M.prefill_into_cache(cfg, M.init_decode_cache(
            cfg, 1, n_pb * bl, device="cpu"), pct)
        M.scatter_prefill_paged(cfg, ct, subt, slot, ids, mask, block_len=bl)
        bt[slot, :n_pb] = ids
        bt[slot, n_pb] = 6 + slot          # the decode write's block
        tok[slot, 0] = int(np.argmax(np.asarray(lj)))
        pos[slot] = P
    return cj, ct, bt, tok, pos


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_decode_step_with_a_dead_row_matches_reference(layout, use_kernels):
    cfg_j, pj, cfg, pt = models()
    cj, ct, bt, tok, pos = (_paged_state if layout == "paged"
                            else _contiguous_state)()
    bt_kw = {} if bt is None else {"block_tables": bt}
    lj, cj = JM.decode_step(pj, cfg_j, cj, jnp.asarray(tok), jnp.asarray(pos),
                            live=jnp.asarray(LIVE),
                            **{k: jnp.asarray(v) for k, v in bt_kw.items()})
    lt, ct = M.decode_step(pt, cfg.replace(use_kernels=use_kernels), ct,
                           torch.as_tensor(tok), torch.as_tensor(pos),
                           live=torch.as_tensor(LIVE),
                           **{k: torch.as_tensor(v)
                              for k, v in bt_kw.items()})
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for path, leaf in convert.flatten(ct).items():
        want = np.asarray(convert.flatten(cj)[path])
        if bt is not None:
            leaf, want = leaf[:, 1:], want[:, 1:]   # not the trash block
        np.testing.assert_allclose(leaf.numpy(), want, **TOL, err_msg=path)


# ---------------------------------------------------------------------------
# prefill_chunked
# ---------------------------------------------------------------------------

def _padded(toks, lens, T):
    out = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        out[b, :n] = toks[b, :n]
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("C", [4, 12])
def test_prefill_chunked_matches_reference(C, layout):
    """Two rows of 9 and 6 tokens in a contiguous cache of capacity 16, or
    one row of 9 through a paged table one block wider than the prompt's
    (block_len 4: blocks 3, 6, 1, then the trash block)."""
    cfg_j, pj, cfg, pt = models()
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
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **CHUNK_TOL)
    got, want = convert.flatten(ct), convert.flatten(cj)
    assert set(got) == set(want) == {f"{s}/sub0/{k}" for s in (
        "blocks", "dense_blocks") for k in ("ckv", "kr")}
    for path, w in want.items():
        g, w = got[path].numpy(), np.asarray(w)
        if tab:
            g, w = g[:, 1:], w[:, 1:]
        np.testing.assert_allclose(g, w, **CHUNK_TOL, err_msg=path)
    # one-shot prefill's last logits too
    one, _ = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks[:1, :9])})
    np.testing.assert_allclose(lt[0].numpy(), one[0].numpy(), **CHUNK_TOL)


# ---------------------------------------------------------------------------
# both engines against the JAX mesh=None engines
# ---------------------------------------------------------------------------

def _serve(cls, params, cfg, prompts, gens, **kw):
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    jax_side = cls in (JaxPaged, JaxEngine)
    if not jax_side:
        kw["device"] = "cpu"
    eng = cls(params, cfg, max_len=max_len, **kw)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": jnp.asarray(p) if jax_side else p}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


MIXED = [(6, 4), (9, 6), (6, 5), (13, 7), (4, 2)]


def _mixed():
    _, _, cfg, _ = models()
    prompts = [_tokens(cfg, (1, P), 10 + i) for i, (P, _) in enumerate(MIXED)]
    return prompts, [g for _, g in MIXED]


@pytest.mark.parametrize("kv", ["", "bf16", "int8", "fp8"])
@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_mixed_traffic_token_identical(engine, kv):
    cfg_j, pj, cfg, pt = models()
    prompts, gens = _mixed()
    kw = dict(n_slots=2, seg_len=3, kv_dtype=kv)
    jcls, pcls = JaxEngine, ServeEngine
    if engine == "paged":
        kw.update(block_len=4, lazy=kv != "bf16")
        jcls, pcls = JaxPaged, PagedServeEngine
    want, _ = _serve(jcls, pj, cfg_j, prompts, gens, **kw)
    got, eng = _serve(pcls, pt, cfg, prompts, gens, **kw)
    assert got == want
    assert all(len(got[u]) == g for u, g in enumerate(gens))
    leaf = eng.cache["blocks"]["sub0"]["ckv"]
    assert leaf.dtype == quant.CachePolicy(kv).storage_dtype(torch.float32)
    assert ("ckv_scale" in eng.cache["blocks"]["sub0"]) == (kv in ("int8",
                                                                   "fp8"))
    if engine == "paged":
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1


def test_prefix_sharing_traffic():
    """A shared preamble through a pool too small for worst-case
    admission: the same tokens and block accounting as the reference's,
    ``dense_blocks`` pooled with ``blocks``."""
    cfg_j, pj, cfg, pt = models()
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab_size, (1, 8))
    gens = [5, 7, 4, 6, 5, 3]
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (1, 4))],
                              1).astype(np.int32) for _ in gens]
    kw = dict(n_slots=4, seg_len=3, block_len=4, n_blocks=14)
    want, jeng = _serve(JaxPaged, pj, cfg_j, prompts, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, prompts, gens, **kw)
    assert got == want
    assert eng.stats["shared_blocks"] == jeng.stats["shared_blocks"] > 0
    assert eng.stats["peak_live_blocks"] == jeng.stats["peak_live_blocks"]
    assert eng.alloc.n_free == 13


def test_preemption_replays_identically():
    cfg_j, pj, cfg, pt = models()
    prompts = [_tokens(cfg, (1, 8), 20 + i) for i in range(3)]
    gens = [12, 12, 12]
    kw = dict(n_slots=3, seg_len=4, block_len=4, n_blocks=11)
    want, jeng = _serve(JaxPaged, pj, cfg_j, prompts, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, prompts, gens, **kw)
    assert got == want
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert eng.alloc.n_free == eng.alloc.n_blocks - 1


@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_bucketed_engines_match_reference(engine, kv):
    """Bucketed chunked admission (chunks of 4): the JAX bucketed engine's
    tokens, and the port's unbucketed engine's."""
    cfg_j, pj, cfg, pt = models()
    prompts, gens = _mixed()
    kw = dict(n_slots=2, seg_len=3, kv_dtype=kv)
    jcls, pcls = JaxEngine, ServeEngine
    if engine == "paged":
        kw["block_len"] = 4
        jcls, pcls = JaxPaged, PagedServeEngine
    want, _ = _serve(jcls, pj, cfg_j, prompts, gens, chunk_len=4, **kw)
    got, eng = _serve(pcls, pt, cfg, prompts, gens, chunk_len=4, **kw)
    plain, _ = _serve(pcls, pt, cfg, prompts, gens, **kw)
    assert eng.chunk_len == 4
    assert eng.stats["prefill_chunks"] == sum(-(-P // 4) for P, _ in MIXED)
    assert got == want
    assert got == plain


def test_speculate_stays_refused():
    """Speculative decode is ported (``tests/test_torch_spec.py``): both
    engines serve DeepSeek-V3 speculatively through its MTP head, from
    a full-precision and an int8 latent pool, with the plain engines'
    tokens."""
    _, _, cfg, pt = models()
    prompts, gens = _mixed()
    for cls, kw in ((ServeEngine, {}), (PagedServeEngine, {"block_len": 4})):
        for kv in ("", "int8"):
            plain, _ = _serve(cls, pt, cfg, prompts, gens, n_slots=2,
                              seg_len=3, kv_dtype=kv, **kw)
            got, eng = _serve(cls, pt, cfg, prompts, gens, n_slots=2,
                              seg_len=3, kv_dtype=kv, speculate=2, **kw)
            assert got == plain and eng.stats["spec_steps"] > 0


def test_launcher_serves_the_arch(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--paged",
                       "--kv-dtype", "int8", "--bucket", "--chunk-len", "4",
                       "--check-unbucketed", "--requests", "3",
                       "--prompt-len", "12", "--gen", "4"])
    out = capsys.readouterr().out
    assert "check-unbucketed: completions match" in out
    assert "read path: gather" in out
