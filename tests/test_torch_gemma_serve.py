"""Serving Gemma-2 and PaliGemma in the port against the JAX reference,
on the CPU.

Reduced ``gemma2-9b`` (window 64, both softcaps) and ``paligemma-3b``
(16 stub patch rows before every prompt), f32, the reference's weights
converted.  The reference's engines run with ``mesh=None``, the port's
on their kernel path (the kernels' plain versions on CPU tensors).

* both engines, unbucketed and bucketed (chunks of 8), emit the JAX
  engines' greedy tokens on mixed traffic (gemma2's longer prompts
  decode past the window), and the bucketed port engine its own
  unbucketed engine's;
* paged prefix sharing is keyed by the patches: equal patches and
  equal text share their full blocks, other patches share none, not
  even the frontend-only blocks; a preempted request's replay carries
  its patches;
* ``submit`` refuses patches of the wrong shape, a VLM request without
  patches and patches on a model without a frontend; the launcher
  serves PaliGemma with stub patches.
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
from repro_torch.serve import paged as pg

from test_torch_simulation import fast_reference_compiles

ARCHS = ["gemma2-9b", "paligemma-3b"]
CHUNK = 8


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
        pj = JM.init_params(jax.random.PRNGKey(6), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[arch] = (cfg_j, pj, cfg, pt)
    return _MODELS[arch]


def _request(cfg, P, seed, patches=None):
    """A host batch of P tokens; a VLM request gets ``patches`` or its
    own draw (normal x 0.05, f32)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, P)).astype(
        np.int32)}
    if cfg.arch_type == "vlm":
        batch["patches"] = patches if patches is not None else (
            rng.standard_normal((1, cfg.frontend_tokens, cfg.d_model))
            * 0.05).astype(np.float32)
    return batch


def _serve(cls, params, cfg, batches, gens, **kw):
    """Greedy completions {uid: tokens} of ``cls`` on the batches."""
    max_len = max(M.decode_capacity(cfg, b["tokens"].shape[1], g)
                  for b, g in zip(batches, gens))
    jax_side = cls in (JaxPaged, JaxEngine)
    if not jax_side:
        kw["device"] = "cpu"
    eng = cls(params, cfg, max_len=max_len, **kw)
    for b, g in zip(batches, gens):
        eng.submit({k: jnp.asarray(v) for k, v in b.items()} if jax_side
                   else b, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


# gemma2: three prompts past the window of 64 or decoding across it
MIXED = {"gemma2-9b": [(70, 6), (40, 5), (61, 8), (20, 3)],
         "paligemma-3b": [(6, 4), (12, 6), (9, 5), (4, 2)]}


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("engine", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engines_match_reference(arch, engine, bucketed):
    cfg_j, pj, cfg, pt = models(arch)
    batches = [_request(cfg, P, 30 + i) for i, (P, _) in
               enumerate(MIXED[arch])]
    gens = [g for _, g in MIXED[arch]]
    kw = dict(n_slots=2, seg_len=3)
    jcls, pcls = JaxEngine, ServeEngine
    if engine == "paged":
        kw["block_len"] = 4
        jcls, pcls = JaxPaged, PagedServeEngine
    if bucketed:
        kw["chunk_len"] = CHUNK
    want, _ = _serve(jcls, pj, cfg_j, batches, gens, **kw)
    got, eng = _serve(pcls, pt, cfg, batches, gens, **kw)
    assert got == want
    assert [len(got[u]) for u in range(len(gens))] == gens
    if bucketed:
        off = M.decode_offset(cfg)
        assert eng.stats["prefill_chunks"] == sum(
            -(-(off + P) // CHUNK) for P, _ in MIXED[arch])
        kw.pop("chunk_len")
        plain, _ = _serve(pcls, pt, cfg, batches, gens, **kw)
        assert got == plain
    if engine == "paged":
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1


def _patches(cfg, seed):
    return (np.random.default_rng(seed).standard_normal(
        (1, cfg.frontend_tokens, cfg.d_model)) * 0.05).astype(np.float32)


def test_prefix_sharing_is_keyed_by_the_patches():
    """Three requests of one text: A and B with the same patches, C with
    other patches.  B shares every full block of A's prompt; C shares
    none, not even the four blocks that hold only patch rows.  The
    tokens and the block accounting are the reference's."""
    cfg_j, pj, cfg, pt = models("paligemma-3b")
    text = _request(cfg, 11, 40)["tokens"]
    p1, p2 = _patches(cfg, 41), _patches(cfg, 42)
    batches = [{"tokens": text, "patches": p} for p in (p1, p1, p2)]
    gens = [5, 5, 5]
    kw = dict(n_slots=3, seg_len=3, block_len=4)
    want, jeng = _serve(JaxPaged, pj, cfg_j, batches, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, batches, gens, **kw)
    assert got == want
    assert got[0] == got[1]
    n_full = (cfg.frontend_tokens + 11) // 4            # 6 full blocks
    assert eng.stats["shared_blocks"] == jeng.stats["shared_blocks"] == n_full
    # by hand: admission alone, then the blocks each slot holds
    eng = PagedServeEngine(pt, cfg, n_slots=3, max_len=64, block_len=4,
                           device="cpu")
    for b in batches:
        eng.submit(b, max_new=5)
    eng._admit()
    a, b, c = (eng._slot_blocks[u][:n_full] for u in range(3))
    assert a == b
    assert not set(a) & set(c)


def test_preemption_replays_with_its_patches():
    cfg_j, pj, cfg, pt = models("paligemma-3b")
    batches = [_request(cfg, 8, 50 + i) for i in range(3)]
    gens = [12, 12, 12]
    kw = dict(n_slots=3, seg_len=4, block_len=4, n_blocks=21)
    want, jeng = _serve(JaxPaged, pj, cfg_j, batches, gens, **kw)
    got, eng = _serve(PagedServeEngine, pt, cfg, batches, gens, **kw)
    assert got == want
    assert eng.stats["preemptions"] == jeng.stats["preemptions"] > 0
    assert eng.alloc.n_free == eng.alloc.n_blocks - 1


def test_prompt_digest_reads_tensor_bytes():
    """Equal patches digest equally whether f32 numpy or a bf16 tensor
    (which has no numpy view) is given; one changed element, another
    dtype or another shape gives another digest."""
    p = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(0))
    bf = p.bfloat16()
    d = pg.prompt_digest({"tokens": None, "patches": bf})
    assert d == pg.prompt_digest({"tokens": None, "patches": bf.clone()})
    other = bf.clone()
    other[0, 3, 7] += 1
    assert d != pg.prompt_digest({"tokens": None, "patches": other})
    assert d != pg.prompt_digest({"tokens": None, "patches": p})
    assert d != pg.prompt_digest({"tokens": None,
                                  "patches": bf.reshape(1, 8, 4)})
    assert pg.prompt_digest({"tokens": None, "patches": p.numpy()}) == \
        pg.prompt_digest({"tokens": None, "patches": p.numpy().copy()})
    assert pg.prompt_digest({"tokens": np.zeros((1, 3))}) == b""


@pytest.mark.parametrize("cls", [ServeEngine, PagedServeEngine])
def test_submit_checks_the_patches(cls):
    _, _, cfg, pt = models("paligemma-3b")
    eng = cls(pt, cfg, n_slots=1, max_len=64, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    P, D = cfg.frontend_tokens, cfg.d_model
    for shape in ((1, P - 1, D), (2, P, D), (1, P, D + 1), (P, D)):
        with pytest.raises(ValueError, match="patches must have shape"):
            eng.submit({"tokens": toks, "patches": np.zeros(shape)},
                       max_new=2)
    with pytest.raises(ValueError, match="patches"):
        eng.submit({"tokens": toks}, max_new=2)
    eng.submit({"tokens": toks, "patches": np.zeros((1, P, D))}, max_new=2)
    assert eng.queue[0].batch["patches"].dtype == torch.float32
    _, _, gcfg, gpt = models("gemma2-9b")
    with pytest.raises(ValueError, match=r"\['tokens'\]"):
        cls(gpt, gcfg, n_slots=1, max_len=64, device="cpu").submit(
            {"tokens": toks, "patches": np.zeros((1, P, D))}, max_new=2)


def test_launcher_serves_paligemma(capsys):
    launch_serve.main(["--arch", "paligemma-3b", "--device", "cpu",
                       "--paged", "--mixed", "--bucket", "--chunk-len", "8",
                       "--check-unbucketed", "--requests", "3",
                       "--prompt-len", "12", "--gen", "4"])
    assert "check-unbucketed: completions match" in capsys.readouterr().out
    cfg = get_config("paligemma-3b", variant="reduced").replace(
        dtype="bfloat16")
    batch = launch_serve.prompt_batch(cfg, np.random.default_rng(0), 5)
    assert batch["patches"].shape == (1, cfg.frontend_tokens, cfg.d_model)
    assert batch["patches"].dtype == torch.bfloat16
    assert 0.03 < batch["patches"].float().std().item() < 0.07
