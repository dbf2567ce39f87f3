"""MoE serving of the port against the JAX reference, on the CPU.

Reduced ``qwen2-moe-a2.7b`` (4 experts, top-2, one shared expert) and
reduced ``deepseek-moe-16b`` (the same, behind one leading dense layer,
``dense_blocks``), f32, the reference's weights converted.  The
reference runs with ``mesh=None`` and ``use_pallas=False`` (its Pallas
dispatch kernel needs ``pl.load``/``pl.store``, which the installed JAX
lacks; its 1-device mesh engine emits other tokens for qwen2-moe, a
fault of the reference), so it takes the dropless all-experts path.
The port runs that path (``use_kernels=False``) and its kernel path
(``moe_ffn``'s capacity buffers over the kernels' plain versions on the
CPU): at top-2 of 4 experts the capacity max(ceil(T·k/E)·2, 8) ≥ T
holds every assignment an expert can receive, so nothing drops and
both paths compute the reference's function.

* ``decode_step`` with dead rows in ``live``, contiguous and paged:
  logits within 1e-5 + 1e-4 relative (the tolerance of
  ``tests/test_torch_moe.py``);
* both engines' greedy tokens equal the JAX ``mesh=None`` engines' on
  mixed-length, prefix-sharing and preemption traffic;
* the kernel path against the plain path, with the drop count 0;
* dead lanes: the reference's freed-slot rig on ``mesh=None``: dead
  rows' routed output exactly 0, live rows bitwise invariant to what
  the dead lanes hold, and ignoring ``live`` breaks it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serve import PagedServeEngine as JaxPaged
from repro.serve import ServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.moe_dispatch.ops import capacity_positions
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.serve import PagedServeEngine, ServeEngine

from test_torch_simulation import fast_reference_compiles, port_cfg

TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b"]


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
    """The reference's reduced config (plain path) and weights, the
    port's config (kernel path) and the converted weights."""
    if arch not in _MODELS:
        cfg_j = jax_config(arch, variant="reduced").replace(use_pallas=False)
        cfg = get_config(arch, variant="reduced")
        assert cfg == port_cfg(cfg_j).replace(use_kernels=True)
        pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[arch] = (cfg_j, pj, cfg, pt)
    return _MODELS[arch]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_deepseek_reduced_keeps_a_leading_dense_layer():
    _, _, cfg, pt = models("deepseek-moe-16b")
    assert (cfg.first_dense_layers, cfg.n_experts, cfg.top_k,
            cfg.n_shared_experts) == (1, 4, 2, 1)
    assert set(pt["dense_blocks"]["sub0"]) == {"ln1", "ln2", "attn", "mlp"}
    assert pt["dense_blocks"]["sub0"]["mlp"]["wi_gate"].shape == (
        1, cfg.d_model, cfg.d_ff)
    assert pt["blocks"]["sub0"]["moe"]["wi_gate"].shape[0] == 1


# ---------------------------------------------------------------------------
# decode_step with dead rows
# ---------------------------------------------------------------------------

LIVE = np.array([True, False, True])


def _contiguous_state(arch, P=7, S=12):
    """Three rows prefilled at B=3 into a contiguous cache of capacity S,
    in both packages; row 1 will be dead."""
    cfg_j, pj, cfg, pt = models(arch)
    toks = _tokens(cfg, (3, P), seed=4)
    lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 3, S), pcj)
    _, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    ct = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 3, S,
                                                       device="cpu"), pct)
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    return cj, ct, None, tok, np.full((3,), P, np.int32)


def _paged_state(arch, bl=4):
    """Requests of 9 and 6 tokens prefilled into slots 0 and 2 of a
    3-slot paged cache through the reference's admission path, in both
    packages; slot 1 is a freed lane on the trash block."""
    cfg_j, pj, cfg, pt = models(arch)
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
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_with_dead_rows_matches_reference(arch, layout,
                                                      use_kernels):
    cfg_j, pj, cfg, pt = models(arch)
    cj, ct, bt, tok, pos = (_paged_state if layout == "paged"
                            else _contiguous_state)(arch)
    bt_kw = {} if bt is None else {"block_tables": bt}
    lj, _ = JM.decode_step(pj, cfg_j, cj, jnp.asarray(tok), jnp.asarray(pos),
                           live=jnp.asarray(LIVE),
                           **{k: jnp.asarray(v) for k, v in bt_kw.items()})
    lt, _ = M.decode_step(pt, cfg.replace(use_kernels=use_kernels), ct,
                          torch.as_tensor(tok), torch.as_tensor(pos),
                          live=torch.as_tensor(LIVE),
                          **{k: torch.as_tensor(v) for k, v in bt_kw.items()})
    # every row, the dead one too: its routed output is 0 in both
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    if "dense_blocks" in pt:
        # the leading dense layer's cache took this step's writes as well
        got = ct["dense_blocks"]["sub0"]["k"]
        assert bool((got != 0).any())


# ---------------------------------------------------------------------------
# both engines against the JAX mesh=None engines
# ---------------------------------------------------------------------------

def _serve(cls, params, cfg, prompts, gens, **kw):
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    eng = cls(params, cfg, max_len=max_len, **kw)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": jnp.asarray(p) if cls in (JaxPaged, JaxEngine)
                    else p}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


MIXED = [(6, 4), (9, 6), (6, 5), (13, 7), (4, 2)]


@pytest.mark.parametrize("engine", ["paged", "paged-eager", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_traffic_token_identical(arch, engine):
    cfg_j, pj, cfg, pt = models(arch)
    prompts = [_tokens(cfg, (1, P), 10 + i) for i, (P, _) in enumerate(MIXED)]
    gens = [g for _, g in MIXED]
    if engine == "contiguous":
        want, _ = _serve(JaxEngine, pj, cfg_j, prompts, gens, n_slots=2,
                         seg_len=3)
        got, eng = _serve(ServeEngine, pt, cfg, prompts, gens, n_slots=2,
                          seg_len=3, device="cpu")
    else:
        kw = dict(n_slots=2, seg_len=3, block_len=4,
                  lazy=engine == "paged")
        want, _ = _serve(JaxPaged, pj, cfg_j, prompts, gens, **kw)
        got, eng = _serve(PagedServeEngine, pt, cfg, prompts, gens,
                          device="cpu", **kw)
        assert eng.alloc.n_free == eng.alloc.n_blocks - 1
    assert eng.cfg.moe_dropless and not cfg.moe_dropless
    assert got == want
    assert all(len(got[u]) == g for u, g in enumerate(gens))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefix_sharing_traffic(arch):
    """A shared preamble through a pool too small for worst-case
    admission: same tokens and block accounting, ``dense_blocks`` pooled
    with ``blocks``."""
    cfg_j, pj, cfg, pt = models(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_preemption_replays_identically(arch):
    cfg_j, pj, cfg, pt = models(arch)
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
# kernel path against plain path, nothing dropped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_matches_plain_path_and_drops_nothing(arch, what,
                                                          monkeypatch):
    _, _, cfg, pt = models(arch)
    choices, own_route = [], moe.route

    def recording_route(p, c, x, live=None):
        w, idx, aux = own_route(p, c, x, live)
        if c.use_kernels:
            choices.append(idx)
        return w, idx, aux
    monkeypatch.setattr(moe, "route", recording_route)

    def run(use_kernels):
        c = cfg.replace(use_kernels=use_kernels)
        toks = torch.as_tensor(_tokens(cfg, (3, 11), seed=8))
        logits, pc = M.prefill(pt, c, {"tokens": toks})
        if what == "prefill":
            return logits
        cache = M.prefill_into_cache(c, M.init_decode_cache(
            c, 3, 16, device="cpu"), pc)
        res = M.generate(pt, c, cache, torch.argmax(logits, -1),
                         torch.full((3,), 11), steps=4,
                         remaining=torch.tensor([4, 2, 0]),
                         return_logits=True)
        return res["logits"][res["valid"]]
    got, want = run(True), run(False)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(choices) == n_moe * (1 if what == "prefill" else 5)
    dropped = sum(int((~capacity_positions(
        i.reshape(-1), max(-(-i.shape[0] * i.shape[1] // cfg.n_experts) * 2,
                           8))[1]).sum()) for i in choices)
    assert dropped == 0
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# dead lanes on mesh=None (the reference's freed-slot rig)
# ---------------------------------------------------------------------------

def _rig():
    """The reference's ``tests/test_serve_sharded.py`` rig on one device:
    16 rows, an identity router (feature j -> expert j), 12 live rows
    preferring expert 0, rows 0-3 freed; no shared expert, so a row's
    output is its routed output alone."""
    cfg_j = jax_config("qwen2-moe-a2.7b", variant="reduced").replace(
        n_shared_experts=0, router_aux_coef=0.0, use_pallas=False)
    E, D, Fh = cfg_j.n_experts, cfg_j.d_model, cfg_j.moe_d_ff
    router = np.zeros((D, E), np.float32)
    for e in range(E):
        router[e, e] = 10.0
    rng = np.random.default_rng(5)
    p = {"router": router,
         "wi_gate": (rng.standard_normal((E, D, Fh)) * 0.1).astype(np.float32),
         "wi_up": (rng.standard_normal((E, D, Fh)) * 0.1).astype(np.float32),
         "wo": (rng.standard_normal((E, Fh, D)) * 0.1).astype(np.float32)}
    x = np.zeros((16, 1, D), np.float32)
    x[4:, 0, 0] = 5.0
    x[4:, 0, E:] = (np.arange(12)[:, None] + 1) * 0.01
    live = np.ones((16, 1), bool)
    live[:4] = False
    return cfg_j, p, x, live


def _garbage(x, cfg, experts):
    """Rows 0-3 filled with wild but finite garbage routing to
    ``experts``."""
    xg = x.copy()
    for e in experts:
        xg[:4, 0, e] = 5.0
    xg[:4, 0, cfg.n_experts:] += 100.0
    return xg


def _dead_lane_outputs(use_kernels):
    cfg_j, p, x, live = _rig()
    cfg = port_cfg(cfg_j).replace(use_kernels=use_kernels)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    outs = [moe.apply_moe(pt, cfg, torch.from_numpy(_garbage(x, cfg, g)),
                          live=torch.from_numpy(live))[0].numpy()
            for g in ((0, 1), (2, 3))]
    want = np.asarray(jmoe.apply_moe(
        jax.tree.map(jnp.asarray, p), cfg_j,
        jnp.asarray(_garbage(x, cfg, (0, 1))), mesh=None,
        live=jnp.asarray(live))[0])
    return outs, want


def _assert_dead_lanes_invisible(outs):
    a, b = outs
    assert np.all(np.isfinite(a))
    np.testing.assert_array_equal(a[4:], b[4:])
    np.testing.assert_array_equal(a[:4], np.zeros_like(a[:4]))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_freed_slot_routes_nowhere(use_kernels):
    """Dead rows' routed output is exactly 0 and live rows are bitwise
    invariant to what the dead lanes hold, as the reference's mesh=None
    path gives (held to it within the tolerance)."""
    outs, want = _dead_lane_outputs(use_kernels)
    _assert_dead_lanes_invisible(outs)
    np.testing.assert_allclose(outs[0], want, **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_ignoring_live_breaks_the_dead_lane_check(use_kernels, monkeypatch):
    own_route = moe.route
    monkeypatch.setattr(moe, "route",
                        lambda p, c, x, live=None: own_route(p, c, x))
    outs, _ = _dead_lane_outputs(use_kernels)
    with pytest.raises(AssertionError):
        _assert_dead_lanes_invisible(outs)


def test_engine_frees_a_finished_slot_out_of_routing(monkeypatch):
    """The engine's segments pass ``live = ~done`` into every decode
    step: a request that finishes early leaves a lane whose rows are
    dead in every later step of the segment."""
    _, _, cfg, pt = models("qwen2-moe-a2.7b")
    seen, own = [], moe.apply_moe

    def recording(p, c, x, mesh=None, live=None):
        if x.shape[1] == 1:
            seen.append(None if live is None else live[:, 0].tolist())
        return own(p, c, x, mesh, live)
    monkeypatch.setattr(moe, "apply_moe", recording)
    eng = PagedServeEngine(pt, cfg, n_slots=2, seg_len=4, block_len=4,
                           max_len=16, device="cpu")
    eng.submit({"tokens": _tokens(cfg, (1, 5), 1)}, max_new=2)
    eng.submit({"tokens": _tokens(cfg, (1, 6), 2)}, max_new=5)
    done = eng.run()
    assert [len(done[u].tokens) for u in (0, 1)] == [2, 5]
    n_moe = cfg.n_layers - cfg.first_dense_layers
    steps = [seen[i] for i in range(0, len(seen), n_moe)]
    assert steps == [[True, True], [False, True], [False, True],
                     [False, True]]
