"""The port's quantized (int8/fp8) KV cache against the JAX reference.

On the CPU, at reduced sizes, inputs drawn with numpy and handed to
both packages (weights initialised by JAX and converted):

* ``models.quant``: codes and scales bit-equal to ``repro.models.quant``
  (zero rows and exact rounding ties included), the policy helpers;
* the paged plain version with scales against the reference's
  interpreted Pallas kernel and its plain version (2e-5 in f32, the
  reference's own tolerance), and the wrapper's refusals;
* cache structure and byte counts for every ``kv_dtype``; recurrent
  state opting out;
* greedy tokens of both port engines against both JAX engines, and the
  int8 engine against the unquantized one; reduced Mamba2 under int8;
* ``launch/serve.py --kv-dtype int8 --check-unquantized``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.paged_attn import ops as jops
from repro.kernels.paged_attn import ref as jref
from repro.models import model as JM
from repro.models import quant as jq
from repro.serve import PagedServeEngine as JaxPaged
from repro.serve import ServeEngine as JaxServe
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attn import ops as pa
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.models import model as M
from repro_torch.models import quant
from repro_torch.serve import PagedServeEngine, ServeEngine
from repro_torch.serve import paged as pg

from test_torch_simulation import fast_reference_compiles

QUANT = ("int8", "fp8")
TOL = dict(atol=2e-5, rtol=2e-5)


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


def _codes(q):
    """Stored codes as numpy, fp8 as its bytes: comparable bit for bit."""
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == quant.FP8 else q).numpy()
    a = np.asarray(q)
    return a if a.dtype == np.int8 else a.view(np.uint8)


def _quant_inputs():
    """Rows at magnitudes 1e-3..1e2, a zero row, and rows built so that
    x / scale lands on exact ties: amax 127 (scale 1 for int8) with
    k + 0.5 entries, and amax 448 (scale 1 for fp8) with entries halfway
    between neighbouring e4m3 values."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 3, 16)).astype(np.float32)
    x *= 10.0 ** rng.integers(-3, 3, (6, 1, 1, 1))
    x[0, 0, 0] = 0.0
    x[1, 0, 0] = 0.0
    x[1, 0, 0, 0] = 127.0
    x[1, 0, 0, 1:9] = np.arange(8) - 3.5
    x[1, 0, 1] = 0.0
    x[1, 0, 1, 0] = 448.0
    x[1, 0, 1, 1:7] = [1.0625, 1.1875, 17.0, -19.0, 0.5 + 1 / 32, 3.25]
    return x


@pytest.mark.parametrize("kv", QUANT)
def test_quantize_bit_equal_to_reference(kv):
    x = _quant_inputs()
    qj, sj = jq.quantize(jnp.asarray(x), kv)
    qt, st = quant.quantize(torch.from_numpy(x), kv)
    assert qt.dtype == quant.CachePolicy(kv).storage_dtype(torch.float32)
    np.testing.assert_array_equal(_codes(qt), _codes(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    # the zero row dequantizes to exact zeros
    assert (quant.dequantize(qt, st)[0, 0, 0] == 0).all()


@pytest.mark.parametrize("kv", QUANT)
def test_dequantize_bit_equal_to_reference(kv):
    x = _quant_inputs()
    qj, sj = jq.quantize(jnp.asarray(x), kv)
    qt, st = quant.quantize(torch.from_numpy(x), kv)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jq.dequantize(qj, sj, jd).astype(jnp.float32))
        got = quant.dequantize(qt, st, td).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kv", quant.KV_DTYPES)
def test_policy_helpers_match_reference(kv):
    pol, jpol = quant.CachePolicy(kv), jq.CachePolicy(kv)
    assert pol.quantized == jpol.quantized
    if pol.quantized:
        assert pol.qmax == jpol.qmax
    for pd, jd in ((torch.float32, jnp.float32),
                   (torch.bfloat16, jnp.bfloat16)):
        assert str(pol.storage_dtype(pd)) == \
            f"torch.{jnp.dtype(jpol.storage_dtype(jd)).name}"
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced")
    cache = M.init_decode_cache(cfg, 2, 8, device="cpu", policy=pol)
    jcache = JM.init_decode_cache(cfg_j, 2, 8, policy=jpol)
    assert quant.policy_of(cache) == quant.CachePolicy(
        jq.policy_of(jcache).kv_dtype)
    assert quant.kv_dtype_of_leaf(cache["blocks"]["sub0"]["k"]) == \
        jq.kv_dtype_of_leaf(jcache["blocks"]["sub0"]["k"])
    assert quant.scale_name("k") == jq.scale_name("k") == "k_scale"
    assert quant.is_scale_key("v_scale") and not quant.is_scale_key("v")
    with pytest.raises(ValueError, match="kv_dtype"):
        quant.CachePolicy("int4")


# ---------------------------------------------------------------------------
# paged attention over quantized pools
# ---------------------------------------------------------------------------

PAGED_CASES = {                     # (B, C, H, KH, D, nb, bl, nbt), w, cap
    "gqa_decode": ((3, 1, 8, 4, 32, 10, 4, 4), 0, 0.0),
    "mha_softcap": ((2, 1, 4, 4, 16, 8, 8, 3), 0, 30.0),
    "window": ((4, 1, 8, 2, 32, 12, 4, 5), 6, 0.0),
    "chunk_c3": ((2, 3, 8, 4, 24, 10, 4, 4), 0, 0.0),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("kv", QUANT)
def test_quantized_paged_ref_matches_reference(kv, case):
    """The port's plain version (what the wrapper runs on the CPU) with
    scales that vary by row and head, against the reference's Pallas
    kernel (interpreted) and its plain version."""
    (B, C, H, KH, D, nb, bl, nbt), window, softcap = PAGED_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    spread = 2.0 ** rng.uniform(-4, 4, size=(2, nb, bl, KH, 1))
    kp = (rng.normal(size=(nb, bl, KH, D)) * spread[0]).astype(np.float32)
    vp = (rng.normal(size=(nb, bl, KH, D)) * spread[1]).astype(np.float32)
    bt = rng.integers(0, nb, size=(B, nbt)).astype(np.int32)
    pos = rng.integers(0, nbt * bl - C + 1, size=(B,)).astype(np.int32)
    kq, ks = jq.quantize(jnp.asarray(kp), kv)
    vq, vs = jq.quantize(jnp.asarray(vp), kv)
    kw = dict(window=window, softcap=softcap)
    jin = (jnp.asarray(q), kq, vq, jnp.asarray(bt), jnp.asarray(pos))
    want_kernel = np.asarray(jops.paged_decode_attention(
        *jin, k_scale=ks, v_scale=vs, out_dtype=jnp.float32, **kw))
    want_ref = np.asarray(jref.paged_attention_ref(
        *jin, k_scale=ks, v_scale=vs, out_dtype=jnp.float32, **kw))
    kt, kst = quant.quantize(torch.from_numpy(kp), kv)
    vt, vst = quant.quantize(torch.from_numpy(vp), kv)
    tin = (torch.from_numpy(q), kt, vt, torch.from_numpy(bt),
           torch.from_numpy(pos))
    got = paged_attention_ref(*tin, k_scale=kst, v_scale=vst,
                              out_dtype=torch.float32, **kw)
    via_wrapper = pa.paged_decode_attention(*tin, k_scale=kst, v_scale=vst,
                                            out_dtype=torch.float32, **kw)
    assert torch.equal(via_wrapper, got)
    np.testing.assert_allclose(got.numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, **TOL)
    # the scales reach the output: permuted ones move it far
    perm = rng.permutation(kst.numel())
    moved = paged_attention_ref(*tin, k_scale=kst,
                                v_scale=vst.reshape(-1)[perm].reshape(
                                    vst.shape),
                                out_dtype=torch.float32, **kw)
    assert (moved - got).abs().max() > 100 * TOL["atol"]


def test_paged_wrapper_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 1, 2, 8)
    kp = torch.zeros(4, 4, 2, 8, dtype=torch.int8)
    s = torch.ones(4, 4, 2)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_scale"):
        pa.paged_decode_attention(q, kp, kp, bt, pos, k_scale=s)
    with pytest.raises(ValueError, match="out_dtype"):
        pa.paged_decode_attention(q, kp, kp, bt, pos, k_scale=s, v_scale=s)
    with pytest.raises(ValueError, match="float32 of shape"):
        pa.paged_decode_attention(q, kp, kp, bt, pos, k_scale=s[:, :2],
                                  v_scale=s, out_dtype=torch.float32)
    with pytest.raises(TypeError, match="int8 or float8"):
        pa.paged_decode_attention(q, q.expand(4, 4, 2, 8).contiguous(),
                                  q.expand(4, 4, 2, 8).contiguous(), bt, pos,
                                  k_scale=s, v_scale=s,
                                  out_dtype=torch.float32)
    with pytest.raises(TypeError, match="without scales"):
        pa.paged_decode_attention(q, kp, kp, bt, pos)
    with pytest.raises(ValueError, match="one device"):
        pa.paged_decode_attention(q, kp, kp, bt, pos, k_scale=s,
                                  v_scale=s.to("meta"),
                                  out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# cache structure and bytes
# ---------------------------------------------------------------------------

def _struct(tree):
    """{path: (shape, dtype name)} of a torch or JAX cache tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            name = str(t.dtype).split(".")[-1]
            out["/".join(path)] = (tuple(t.shape), name)
    walk(tree, ())
    return out


@pytest.mark.parametrize("kv", quant.KV_DTYPES)
def test_cache_structure_and_bytes_match_reference(kv):
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced")
    pol, jpol = quant.CachePolicy(kv), jq.CachePolicy(kv)
    assert _struct(M.init_decode_cache(cfg, 2, 12, device="meta",
                                       policy=pol)) == \
        _struct(JM.init_decode_cache(cfg_j, 2, 12, policy=jpol))
    assert _struct(M.init_paged_cache(cfg, 3, 9, 4, device="meta",
                                      policy=pol)) == \
        _struct(JM.init_paged_cache(cfg_j, 3, 9, 4, policy=jpol))
    assert M.cache_nbytes(cfg, 2, 12, policy=pol) == \
        JM.cache_nbytes(cfg_j, 2, 12, policy=jpol)
    assert M.paged_cache_nbytes(cfg, 3, 9, 4, policy=pol) == \
        JM.paged_cache_nbytes(cfg_j, 3, 9, 4, policy=jpol)
    axes = M.decode_cache_seq_axes(cfg, policy=pol)["blocks"]["sub0"]
    assert axes == {k: 2 for k in axes}


def test_recurrent_cache_opts_out_of_quantization():
    cfg = get_config("mamba2-1.3b", variant="reduced")
    cfg_j = jax_config("mamba2-1.3b", variant="reduced")
    pol = quant.CachePolicy("int8")
    cache = M.init_decode_cache(cfg, 2, 16, device="meta", policy=pol)
    assert quant.policy_of(cache).kv_dtype == ""
    assert cache["blocks"]["state"].dtype == torch.float32
    assert _struct(cache) == _struct(JM.init_decode_cache(
        cfg_j, 2, 16, policy=jq.CachePolicy("int8")))
    assert M.cache_nbytes(cfg, 2, 16, policy=pol) == \
        M.cache_nbytes(cfg, 2, 16) == JM.cache_nbytes(cfg_j, 2, 16)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced")
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
    return cfg_j, pj, cfg, pt


@pytest.fixture(scope="module")
def traffic(models):
    """Mixed lengths; three prompts share an 8-token preamble (two full
    blocks at block_len 4); a 9-block pool makes the paged engines
    preempt once."""
    V = models[2].vocab_size
    rng = np.random.default_rng(5)
    pre = rng.integers(0, V, (1, 8))

    def r(n):
        return rng.integers(0, V, (1, n))
    prompts = [np.concatenate([pre, r(4)], 1), np.concatenate([pre, r(4)], 1),
               r(5), np.concatenate([pre, r(1)], 1), r(13)]
    return [p.astype(np.int32) for p in prompts], [6, 9, 4, 7, 5]


PAGED_KW = dict(n_slots=3, seg_len=3, block_len=4, n_blocks=9)
CONTIG_KW = dict(n_slots=3, seg_len=3)
_JAX_RUNS = {}


def _jax_tokens(models, traffic, kv, engine):
    key = (kv, engine)
    if key not in _JAX_RUNS:
        cfg_j, pj, _, _ = models
        prompts, gens = traffic
        max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
        if engine == "paged":
            eng = JaxPaged(pj, cfg_j.replace(use_pallas=True),
                           max_len=max_len, kv_dtype=kv, **PAGED_KW)
        else:
            eng = JaxServe(pj, cfg_j, max_len=max_len, kv_dtype=kv,
                           **CONTIG_KW)
        for p, g in zip(prompts, gens):
            eng.submit({"tokens": jnp.asarray(p)}, max_new=g)
        _JAX_RUNS[key] = ({u: c.tokens.tolist() for u, c in eng.run().items()},
                          eng.stats)
    return _JAX_RUNS[key]


def _port_run(models, traffic, kv, engine):
    _, _, cfg, pt = models
    prompts, gens = traffic
    max_len = max(p.shape[1] + g for p, g in zip(prompts, gens))
    if engine == "paged":
        eng = PagedServeEngine(pt, cfg, max_len=max_len, kv_dtype=kv,
                               device="cpu", **PAGED_KW)
    else:
        eng = ServeEngine(pt, cfg, max_len=max_len, kv_dtype=kv,
                          device="cpu", **CONTIG_KW)
    for p, g in zip(prompts, gens):
        eng.submit({"tokens": p}, max_new=g)
    return {u: c.tokens.tolist() for u, c in eng.run().items()}, eng


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
@pytest.mark.parametrize("kv", ["int8", "fp8", "bf16", "fp32"])
def test_engines_match_both_jax_engines(models, traffic, kv, engine):
    got, eng = _port_run(models, traffic, kv, engine)
    want_paged, jstats = _jax_tokens(models, traffic, kv, "paged")
    want_contig, _ = _jax_tokens(models, traffic, kv, "contiguous")
    assert got == want_paged == want_contig
    assert all(len(got[u]) == g for u, g in enumerate(traffic[1]))
    leaf = eng.cache["blocks"]["sub0"]["k"]
    assert leaf.dtype == quant.CachePolicy(kv).storage_dtype(torch.float32)
    assert ("k_scale" in eng.cache["blocks"]["sub0"]) == (kv in QUANT)
    if engine == "paged":
        assert eng.stats["preemptions"] == jstats["preemptions"] == 1
        assert eng.stats["shared_blocks"] == jstats["shared_blocks"] > 0
        assert eng.alloc.n_free == eng.n_blocks - 1


def test_paged_engine_int8_matches_unquantized_greedy(models):
    """The port's counterpart of the reference's
    ``test_paged_engine_int8_matches_fp32_greedy``: same weights, same
    prompts, same engine settings."""
    _, _, cfg, pt = models
    lengths = [(6, 4), (9, 6), (6, 5)]
    prompts = [np.array(jax.random.randint(jax.random.PRNGKey(10 + i),
                                             (1, p), 0, cfg.vocab_size),
                          np.int32) for i, (p, _) in enumerate(lengths)]
    max_len = max(M.decode_capacity(cfg, p, g) for p, g in lengths)
    outs = {}
    for kv in ("", "int8"):
        eng = PagedServeEngine(pt, cfg, n_slots=2, max_len=max_len,
                               seg_len=3, block_len=4, kv_dtype=kv,
                               device="cpu")
        for p, (_, g) in zip(prompts, lengths):
            eng.submit({"tokens": p}, max_new=g)
        outs[kv] = {u: c.tokens.tolist() for u, c in eng.run().items()}
    assert outs["int8"] == outs[""]


def test_quantized_blocks_depend_on_tokens_only(models):
    """Admission quantizes the full-precision graft once: a shared
    prompt block written by two requests of different lengths holds the
    same bytes, and prefix keys carry the policy."""
    _, _, cfg, pt = models
    rng = np.random.default_rng(3)
    pre = rng.integers(0, cfg.vocab_size, (1, 8))
    a = np.concatenate([pre, rng.integers(0, cfg.vocab_size, (1, 5))], 1)
    pools = []
    for prompt in (pre, a):
        eng = PagedServeEngine(pt, cfg, n_slots=1, max_len=16, block_len=4,
                               kv_dtype="int8", device="cpu")
        eng.submit({"tokens": prompt.astype(np.int32)}, max_new=2)
        eng.step()
        ids = eng.block_tables[0, :2]
        c = eng.cache["blocks"]["sub0"]
        pools.append({k: c[k][:, ids].clone() for k in c})
    for k in pools[0]:
        assert torch.equal(pools[0][k], pools[1][k]), k
    keys = {kv: pg.prefix_keys({"tokens": pre}, 2, 4, 0, policy=kv)
            for kv in ("", "int8")}
    assert not set(keys[""]) & set(keys["int8"])


@pytest.mark.parametrize("engine", ["paged", "contiguous"])
def test_mamba2_int8_keeps_f32_state_and_jax_tokens(engine):
    cfg_j = jax_config("mamba2-1.3b", variant="reduced")
    cfg = get_config("mamba2-1.3b", variant="reduced")
    pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (1, P)).astype(np.int32)
               for P in (5, 12, 3)]
    gens = [4, 6, 5]
    kw = dict(n_slots=2, seg_len=3, max_len=20, kv_dtype="int8")
    pkw = dict(block_len=4) if engine == "paged" else {}
    jcls, tcls = ((JaxPaged, PagedServeEngine) if engine == "paged"
                  else (JaxServe, ServeEngine))
    jeng = jcls(pj, cfg_j.replace(use_pallas=True), **kw, **pkw)
    teng = tcls(pt, cfg, device="cpu", **kw, **pkw)
    for p, g in zip(prompts, gens):
        jeng.submit({"tokens": jnp.asarray(p)}, max_new=g)
        teng.submit({"tokens": p}, max_new=g)
    want = {u: c.tokens.tolist() for u, c in jeng.run().items()}
    got = {u: c.tokens.tolist() for u, c in teng.run().items()}
    assert got == want
    assert teng.cache["blocks"]["state"].dtype == torch.float32
    assert quant.policy_of(teng.cache).kv_dtype == ""


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_launcher_kv_dtype_check_unquantized(paged, capsys):
    from repro_torch.launch import serve
    comps = serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                        "--kv-dtype", "int8", "--check-unquantized",
                        "--requests", "3", "--prompt-len", "12", "--gen",
                        "6", "--mixed"] + (["--paged"] if paged else []))
    assert len(comps) == 3
    out = capsys.readouterr().out
    assert "kv-dtype: int8 cache_bytes=" in out
    assert "check-unquantized: int8 completions match" in out


def test_launcher_check_unquantized_needs_a_quantized_cache():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                    "--kv-dtype", "bf16", "--check-unquantized"])
