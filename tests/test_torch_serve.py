"""The port's serving engines against the JAX reference's paged engine.

Reduced TinyLlama, the reference's weights converted, greedy sampling.
The reference runs ``PagedServeEngine`` with ``use_pallas=True`` (Pallas
in interpret mode); the port's ``PagedServeEngine`` and ``ServeEngine``
run on the CPU and must emit the same tokens, request for request, on
mixed-length, prefix-sharing and preemption traffic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.serve import PagedServeEngine as JaxPaged
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serve import (PagedAllocator, PagedServeEngine,
                               ServeEngine)
from repro_torch.serve import paged as pg


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced").replace(
        use_pallas=True)
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
    return cfg_j, pj, cfg, pt


def _run_jax(models, prompts, gens, **kw):
    cfg_j, pj, _, _ = models
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    eng = JaxPaged(pj, cfg_j, max_len=max_len, **kw)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": jnp.asarray(p)}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


def _run_port(models, cls, prompts, gens, **kw):
    _, _, cfg, pt = models
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    eng = cls(pt, cfg, max_len=max_len, device="cpu", **kw)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": p}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


def _prompt(cfg, P, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, P)).astype(np.int32)


MIXED = [(6, 4), (9, 6), (6, 5), (13, 7), (4, 2)]


@pytest.fixture(scope="module")
def mixed(models):
    cfg = models[2]
    prompts = [_prompt(cfg, P, 10 + i) for i, (P, _) in enumerate(MIXED)]
    gens = [g for _, g in MIXED]
    want, _ = _run_jax(models, prompts, gens, n_slots=2, seg_len=3,
                       block_len=4)
    return prompts, gens, want


@pytest.mark.parametrize("engine", ["paged", "paged-eager", "contiguous"])
def test_mixed_traffic_token_identical(models, mixed, engine):
    prompts, gens, want = mixed
    if engine == "contiguous":
        got, eng = _run_port(models, ServeEngine, prompts, gens, n_slots=2,
                             seg_len=3)
    else:
        got, eng = _run_port(models, PagedServeEngine, prompts, gens,
                             n_slots=2, seg_len=3, block_len=4,
                             lazy=engine == "paged")
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1
        assert not eng._slot_blocks
    assert got == want
    assert all(len(got[u]) == g for u, g in enumerate(gens))


def test_prefix_sharing_traffic(models):
    """The reference's shared-preamble traffic through a pool too small
    for worst-case admission: same tokens, same block accounting."""
    cfg = models[2]
    rng = np.random.default_rng(0)
    pre = rng.integers(0, cfg.vocab_size, (1, 8))  # 2 full blocks @ bl=4
    gens = [5, 7, 4, 6, 5, 3]
    prompts = [np.concatenate([pre, rng.integers(0, cfg.vocab_size, (1, 4))],
                              1).astype(np.int32) for _ in gens]
    kw = dict(n_slots=4, seg_len=3, block_len=4, n_blocks=14)
    want, jeng = _run_jax(models, prompts, gens, **kw)
    got, eng = _run_port(models, PagedServeEngine, prompts, gens, **kw)
    assert got == want
    assert eng.stats["shared_blocks"] == jeng.stats["shared_blocks"] > 0
    assert eng.stats["peak_live_blocks"] == jeng.stats["peak_live_blocks"]
    assert eng.stats["peak_live_blocks"] <= 13
    assert eng.alloc.n_free == 13
    assert not eng.alloc._bid_of and not eng.alloc._key_of


def test_preemption_replays_identically(models):
    """10 allocatable blocks < 3 * ceil(20/4): the youngest request is
    preempted and replayed, and every completion still matches."""
    cfg = models[2]
    prompts = [_prompt(cfg, 8, 20 + i) for i in range(3)]
    gens = [12, 12, 12]
    kw = dict(n_slots=3, seg_len=4, block_len=4, n_blocks=11)
    want, jeng = _run_jax(models, prompts, gens, **kw)
    got, eng = _run_port(models, PagedServeEngine, prompts, gens, **kw)
    assert got == want
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert eng.alloc.n_free == eng.alloc.n_blocks - 1


def test_request_larger_than_pool_rejected(models):
    _, _, cfg, pt = models
    eng = PagedServeEngine(pt, cfg, n_slots=1, max_len=32, block_len=4,
                           n_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        eng.submit({"tokens": np.zeros((1, 10), np.int32)}, max_new=8)


def test_completion_timing_and_stats(models):
    prompts, gens = [_prompt(models[2], 5, 1)], [3]
    got, eng = _run_port(models, PagedServeEngine, prompts, gens, n_slots=1,
                         seg_len=2, block_len=4)
    comp = eng.completions[0]
    assert comp.ttft_s >= 0 and comp.n_segments == 1
    assert eng.stats["decode_s"] > 0 and eng.stats["admit_s"] > 0


# ---------------------------------------------------------------------------
# allocator properties (the port's copy)
# ---------------------------------------------------------------------------

def test_allocator_refcounts_and_double_free():
    al = PagedAllocator(6, 4)  # blocks 1..5
    assert al.n_free == 5 and pg.TRASH == 0
    a, fresh_a = al.acquire(("k", 1))
    b, fresh_b = al.acquire(("k", 1))
    assert a == b and fresh_a and not fresh_b and al.refcount[a] == 2
    c = al.alloc()
    assert c != a and al.refcount[c] == 1
    al.release(a)
    assert al.refcount[a] == 1 and al.lookup(("k", 1)) == a
    al.release(a)  # refcount 0 <=> no holder left: key evicted, block freed
    assert al.refcount[a] == 0 and al.lookup(("k", 1)) is None
    assert a in al.free_ids()
    with pytest.raises(ValueError, match="double free"):
        al.release(a)
    with pytest.raises(ValueError, match="trash"):
        al.release(pg.TRASH)
    al.release(c)
    assert al.n_free == 5 and al.n_live == 0


def test_allocator_exhaustion_and_key_reuse():
    al = PagedAllocator(3, 4)  # 2 allocatable
    x = al.alloc()
    y, _ = al.acquire(("p",))
    with pytest.raises(RuntimeError, match="exhausted"):
        al.alloc()
    y2, fresh = al.acquire(("p",))  # a shared hit needs no free block
    assert y2 == y and not fresh
    al.release(y)
    al.release(y2)
    al.release(x)
    z, fresh = al.acquire(("p",))
    assert fresh and al.n_free == 1 and z in (x, y)


def test_prefix_keys_match_reference():
    from repro.serve import paged as jpg
    toks = {"tokens": np.arange(13)[None]}
    assert pg.prefix_keys(toks, 3, 4, 0) == jpg.prefix_keys(toks, 3, 4, 0)
    assert len(set(pg.prefix_keys(toks, 3, 4, 0))) == 3
