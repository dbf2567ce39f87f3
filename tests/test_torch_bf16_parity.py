"""bf16 model parity on the CPU: the port's bf16 rounding against the
reference's.

The f32 parity tests hold the port to the reference to 1e-4, but in bf16
the two packages round at different points (``F.silu`` rounds once where
XLA's CPU silu rounds twice; tanh-GELU likewise), so their bf16 logits
differ by as much as each differs from its own f32 model, and a bf16
fault in the port (a dropped f32 upcast, a term rounded to bf16) could
hide in that drift.  The checks, on reduced ``tinyllama-1.1b`` and
``mamba2-1.3b`` (blocks also of ``gemma2-9b`` and ``whisper-small``),
the same converted weights in f32 and in bf16 (the bf16 tree is the f32
one rounded, ``A_log``, ``D`` and ``dt_bias`` kept in f32 as both
packages keep them).  Mamba2's ``D`` is drawn from U(0.5, 2):
the init's D = 1 makes D * x exact in bf16, so no fault of the D term
could show.  The port takes its kernels' plain versions (CPU tensors),
the reference its plain path.

1. Model drift.  The relative RMS over every position's logits of the
   bf16 model against the same package's f32 model; the port's must stay
   within ``FACTOR[arch]`` of the reference's.  Readings (weight seeds 1
   and 2): TinyLlama 1.005 and 1.001, Mamba2 0.943 and 0.936 (its
   activations round once, the reference's twice).  Each factor is about
   5% over its own architecture's worst reading.  Planted faults:
   TinyLlama's RMSNorm without its f32 upcast (1.177, 1.090) and
   Mamba2's D zeroed (100.3, 85.6) break it.  One extra bf16 rounding
   (D * x in bf16) moves Mamba2's model drift by 3-5% (0.993, 0.969),
   about its spread across weights: check 2 is the one that sees it.
2. One Mamba-2 block, rounding point by rounding point.  With the
   reference's silu made to round once, as the port's does (the one
   deliberate difference), every rounding point is the same in both, so
   the port's bf16 block output must lie within ``BLOCK_LIMIT`` of the
   reference's bf16 output, measured in units of the reference's own
   bf16-vs-f32 distance.  Readings (seeds 1, 2; layers 0, 1): 0.347,
   0.335, 0.370, 0.348 (summation orders differ); D * x rounded to bf16
   before it is added reads 0.593, 0.560, 0.553, 0.551.  ``BLOCK_LIMIT``
   is 0.45, about midway.
3. One TinyLlama block (attention and gated MLP), the same way: with
   the reference's silu rounding once, the port's bf16 block output
   lies within ``DENSE_BLOCK_LIMIT`` of the reference's, in units of the
   reference's own bf16-vs-f32 distance.  Readings (seeds 1, 2; layers
   0, 1): 0.030, 0.024, 0.108, 0.085 (the port's flash plain version;
   0.035-0.106 through its chunked attention).  One extra bf16 rounding
   breaks it: RoPE without its f32 upcast (in the attention) reads
   0.720-0.736, the MLP's down projection summed as two bf16-rounded
   halves 0.413-0.426.  ``DENSE_BLOCK_LIMIT`` is 0.25, about midway
   between the worst reading and the mildest fault.
4. One gemma2 block (reduced ``gemma2-9b``'s first sub-layer: a local
   layer whose window of 64 masks at S 128, the attention softcap,
   post-block norms, tanh-GELU rounding once in both), held to the same
   ``DENSE_BLOCK_LIMIT``.  Readings (seeds 1, 2; layers 0, 1): 0.042,
   0.051, 0.161, 0.129.  The two post-block norms computed in bf16
   (their f32 upcast dropped) read 0.711-0.738.
5. One whisper encoder block (reduced ``whisper-small``'s: bidirectional
   attention, LayerNorm, ungated tanh-GELU rounding once in both), held
   to the same ``DENSE_BLOCK_LIMIT``.  Readings (seeds 1, 2; layers 0,
   1): 0.103, 0.063, 0.060, 0.142.  Its LayerNorms computed in bf16
   (their f32 upcast dropped) read 0.986-1.000.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import ssm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # one thread a test process, so that parallel test workers do not
    # oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FACTOR = {"tinyllama-1.1b": 1.05, "mamba2-1.3b": 0.99}
BLOCK_LIMIT = 0.45
DENSE_BLOCK_LIMIT = 0.25
KEEP_F32 = ("A_log", "D", "dt_bias")   # f32 leaves of a bf16 model
ARCHS = ["tinyllama-1.1b", "mamba2-1.3b"]
SEEDS = [1, 2]


def _rel_rms(a, b):
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


@pytest.fixture(scope="module")
def runs():
    """(arch, seed) -> the reference's drift, the port's f32 logits, the
    bf16 weights as the port's tree and its bf16 config, the tokens."""
    out = {}

    def make(arch, seed):
        cfg_j = jax_config(arch, variant="reduced").replace(
            dtype="float32", use_pallas=False)
        cfg = get_config(arch, variant="reduced").replace(dtype="float32")
        tree, btree = _trees(cfg_j, seed)
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32)

        def ref_logits(tr, c):
            p = jax.tree.map(jnp.asarray, tr)
            h = JM.backbone(p, c, {"tokens": jnp.asarray(toks)})[0]
            return np.asarray(JM._head(p, c, h), np.float32)
        d_ref = _rel_rms(ref_logits(btree, cfg_j.replace(dtype="bfloat16")),
                         ref_logits(tree, cfg_j))
        cfg_bf = cfg.replace(dtype="bfloat16")
        return (d_ref, port_logits(convert.params_from_jax(tree, cfg), cfg,
                                   toks),
                convert.params_from_jax(btree, cfg_bf), cfg_bf, toks)

    def get(arch, seed):
        if (arch, seed) not in out:
            out[arch, seed] = make(arch, seed)
        return out[arch, seed]
    return get


def _trees(cfg_j, seed):
    """The reference's init at ``seed`` as numpy (Mamba2's D drawn from
    U(0.5, 2)), and its bf16 copy."""
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed),
                                                   cfg_j))
    flat = convert.flatten(tree)
    rng = np.random.default_rng(seed)
    for p, a in flat.items():
        if p.endswith("/D"):
            flat[p] = rng.uniform(0.5, 2.0, a.shape).astype(a.dtype)
    tree = convert.unflatten(flat)
    btree = convert.unflatten({
        p: a if p.rsplit("/", 1)[-1] in KEEP_F32 else a.astype(jnp.bfloat16)
        for p, a in flat.items()})
    return tree, btree


def port_logits(params, cfg, toks):
    h = M.backbone(params, cfg, {"tokens": torch.as_tensor(toks)})[0]
    return M._head(params, cfg, h).float().numpy()


def _ratio(runs, arch, seed, params=None):
    d_ref, f32, p_bf, cfg_bf, toks = runs(arch, seed)
    got = port_logits(p_bf if params is None else params, cfg_bf, toks)
    return _rel_rms(got, f32) / d_ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_drift_within_factor_of_reference(runs, arch, seed):
    ratio = _ratio(runs, arch, seed)
    assert ratio <= FACTOR[arch], f"bf16 drift {ratio:.3f}x the reference's"


@pytest.mark.parametrize("seed", SEEDS)
def test_dropped_norm_upcast_breaks_the_factor(runs, monkeypatch, seed):
    """RMSNorm computed in bf16 (no f32 upcast) drifts beyond FACTOR."""
    def norm_in_bf16(p, x, eps=1e-6):
        ms = (x * x).mean(-1, keepdim=True)
        return (x * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)
    monkeypatch.setattr(layers, "apply_norm", norm_in_bf16)
    ratio = _ratio(runs, "tinyllama-1.1b", seed)
    assert ratio > FACTOR["tinyllama-1.1b"], f"only {ratio:.3f}x the reference's drift"


@pytest.mark.parametrize("seed", SEEDS)
def test_dropped_d_term_breaks_the_factor(runs, seed):
    """Mamba2's skip term D * x dropped from the bf16 model."""
    _, _, p_bf, _, _ = runs("mamba2-1.3b", seed)
    faulty = convert.unflatten({
        p: torch.zeros_like(t) if p.endswith("/D") else t
        for p, t in convert.flatten(p_bf).items()})
    ratio = _ratio(runs, "mamba2-1.3b", seed, faulty)
    assert ratio > FACTOR["mamba2-1.3b"], f"only {ratio:.3f}x the reference's drift"


# ---------------------------------------------------------------------------
# one Mamba-2 block, with the reference's silu rounding once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blocks():
    """(seed, layer) -> the reference's f32 and bf16 block outputs (its
    silu rounding once), the port's f32 output, its bf16 block weights,
    its bf16 config and the bf16 input."""
    out = {}
    silu = jax.nn.silu

    def silu_once(x):
        return silu(x.astype(jnp.float32)).astype(x.dtype)

    def make(seed, layer):
        cfg_j = jax_config("mamba2-1.3b", variant="reduced").replace(
            dtype="float32", use_pallas=False)
        cfg = get_config("mamba2-1.3b", variant="reduced").replace(
            dtype="float32")
        tree, btree = _trees(cfg_j, seed)
        cfg_bf = cfg.replace(dtype="bfloat16")

        def mixer(t):
            return jax.tree.map(lambda a: a[layer], t["blocks"]["mixer"])
        x = np.random.default_rng(seed + 10).standard_normal(
            (4, 128, cfg.d_model)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        jax.nn.silu = silu_once
        try:
            ref = [np.asarray(jssm.ssm_forward(
                jax.tree.map(jnp.asarray, mixer(t)), c, xi), np.float32)
                for t, c, xi in ((tree, cfg_j, jnp.asarray(x)),
                                 (btree, cfg_j.replace(dtype="bfloat16"),
                                  xb))]
        finally:
            jax.nn.silu = silu
        f32 = ssm.ssm_forward(mixer(convert.params_from_jax(tree, cfg)), cfg,
                              torch.from_numpy(x)).numpy()
        return (*ref, f32, mixer(convert.params_from_jax(btree, cfg_bf)),
                cfg_bf, torch.from_numpy(np.asarray(xb, np.float32)
                                         ).bfloat16())

    def get(seed, layer):
        if (seed, layer) not in out:
            out[seed, layer] = make(seed, layer)
        return out[seed, layer]
    return get


def _block_distance(blocks, seed, layer):
    """The port's bf16 block output's distance to the reference's, over
    the reference's own bf16-vs-f32 distance; the port's f32 output is
    held to the reference's on the way."""
    ref_f32, ref_bf, f32, p_bf, cfg_bf, xb = blocks(seed, layer)
    np.testing.assert_allclose(f32, ref_f32, atol=1e-4, rtol=1e-4)
    got = ssm.ssm_forward(p_bf, cfg_bf, xb).float().numpy()
    return _rel_rms(got, ref_bf) / _rel_rms(ref_bf, ref_f32)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_mamba2_block_rounds_where_the_reference_does(blocks, seed, layer):
    d = _block_distance(blocks, seed, layer)
    assert d <= BLOCK_LIMIT, f"{d:.3f} of the reference's bf16 drift"


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_d_term_in_bf16_breaks_the_block_check(blocks, monkeypatch, seed,
                                               layer):
    """D * x rounded to bf16 before it is added (the cast to f32 dropped
    from the skip term)."""
    def skip_in_bf16(y, xs, D):
        return y + (xs * D.to(xs.dtype)[:, None]).float()
    monkeypatch.setattr(ssm, "skip", skip_in_bf16)
    d = _block_distance(blocks, seed, layer)
    assert d > BLOCK_LIMIT, f"only {d:.3f} of the reference's bf16 drift"


# ---------------------------------------------------------------------------
# one TinyLlama block (attention + gated MLP), the reference's silu once
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense_blocks():
    """(seed, layer[, arch]) -> the reference's f32 and bf16 outputs of
    one sub-layer of TinyLlama (or of ``arch``: gemma2's first, a local
    one; whisper's encoder block, bidirectional) with its silu and
    tanh-GELU rounding once, the port's f32
    output, its bf16 sub-layer weights, its bf16 config, the bf16 input
    and the positions."""
    out = {}
    silu, gelu = jax.nn.silu, jax.nn.gelu

    def silu_once(x):
        return silu(x.astype(jnp.float32)).astype(x.dtype)

    def gelu_once(x, approximate=True):
        return gelu(x.astype(jnp.float32), approximate).astype(x.dtype)

    def make(seed, layer, arch):
        cfg_j = jax_config(arch, variant="reduced").replace(
            dtype="float32", use_pallas=False)
        cfg = get_config(arch, variant="reduced").replace(dtype="float32")
        kind = cfg.attn_pattern[0]
        tree, btree = _trees(cfg_j, seed)
        cfg_bf = cfg.replace(dtype="bfloat16")
        causal = _causal(cfg)

        def stack(t):
            return t["enc_blocks"] if not causal else t["blocks"]["sub0"]

        def sub(t):
            return jax.tree.map(lambda a: a[layer], stack(t))
        x = np.random.default_rng(seed + 10).standard_normal(
            (4, 128, cfg.d_model)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        pos = np.broadcast_to(np.arange(128, dtype=np.int32)[None], (4, 128))
        jax.nn.silu, jax.nn.gelu = silu_once, gelu_once
        try:
            ref = [np.asarray(JM._block_full(
                jax.tree.map(jnp.asarray, sub(t)), c, xi, jnp.asarray(pos),
                kind=kind, mesh=None, causal=causal)[0], np.float32)
                for t, c, xi in ((tree, cfg_j, jnp.asarray(x)),
                                 (btree, cfg_j.replace(dtype="bfloat16"),
                                  xb))]
        finally:
            jax.nn.silu, jax.nn.gelu = silu, gelu
        post = torch.from_numpy(pos.copy())
        f32 = M._block_full(M._layer(stack(convert.params_from_jax(
            tree, cfg)), layer), cfg, torch.from_numpy(x), post, kind=kind,
            causal=causal)[0].numpy()
        return (*ref, f32, M._layer(stack(convert.params_from_jax(
            btree, cfg_bf)), layer), cfg_bf,
            torch.from_numpy(np.asarray(xb, np.float32)).bfloat16(), post)

    def get(seed, layer, arch="tinyllama-1.1b"):
        if (seed, layer, arch) not in out:
            out[seed, layer, arch] = make(seed, layer, arch)
        return out[seed, layer, arch]
    return get


def _causal(cfg):
    """The whisper block is an encoder block: bidirectional."""
    return cfg.arch_type != "encdec"


def _dense_block_distance(dense_blocks, seed, layer, arch="tinyllama-1.1b"):
    """As ``_block_distance``, for one TinyLlama (or ``arch``) sub-layer."""
    ref_f32, ref_bf, f32, p_bf, cfg_bf, xb, pos = dense_blocks(seed, layer,
                                                               arch)
    np.testing.assert_allclose(f32, ref_f32, atol=1e-4, rtol=1e-4)
    got = M._block_full(p_bf, cfg_bf, xb, pos, kind=cfg_bf.attn_pattern[0],
                        causal=_causal(cfg_bf))[0]
    return _rel_rms(got.float().numpy(), ref_bf) / _rel_rms(ref_bf, ref_f32)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_tinyllama_block_rounds_where_the_reference_does(dense_blocks, seed,
                                                         layer):
    d = _dense_block_distance(dense_blocks, seed, layer)
    assert d <= DENSE_BLOCK_LIMIT, f"{d:.3f} of the reference's bf16 drift"


def _rope_in_bf16(x, positions, theta: float):
    """RoPE with its products in x's dtype (the f32 upcast dropped)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32)
                      * (math.log(theta) / half))
    angles = positions.float()[..., None] * freqs
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mlp_split_down(p, cfg, x):
    """The gated MLP with its down projection summed as two halves, each
    rounded to bf16 before they are added."""
    h = layers._act(cfg, layers.mm(x, p["wi_gate"])) * layers.mm(
        x, p["wi_up"])
    half = h.shape[-1] // 2
    return (layers.mm(h[..., :half], p["wo"][:half])
            + layers.mm(h[..., half:], p["wo"][half:]))


@pytest.mark.parametrize("fault", ["rope", "mlp"])
@pytest.mark.parametrize("seed", SEEDS)
def test_extra_rounding_breaks_the_tinyllama_block_check(dense_blocks,
                                                         monkeypatch, seed,
                                                         fault):
    dense_blocks(seed, 0)   # the f32 reading is taken without the fault
    if fault == "rope":
        monkeypatch.setattr(layers, "apply_rope", _rope_in_bf16)
    else:
        monkeypatch.setattr(layers, "apply_mlp", _mlp_split_down)
    d = _dense_block_distance(dense_blocks, seed, 0)
    assert d > DENSE_BLOCK_LIMIT, f"only {d:.3f} of the reference's bf16 drift"


# ---------------------------------------------------------------------------
# one gemma2 block (local window, softcap, post-block norms, tanh-GELU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_gemma2_block_rounds_where_the_reference_does(dense_blocks, seed,
                                                      layer):
    d = _dense_block_distance(dense_blocks, seed, layer, "gemma2-9b")
    assert d <= DENSE_BLOCK_LIMIT, f"{d:.3f} of the reference's bf16 drift"


@pytest.mark.parametrize("seed", SEEDS)
def test_post_block_norms_in_bf16_break_the_gemma2_block_check(
        dense_blocks, monkeypatch, seed):
    """The two post-block norms (``ln1_post``, ``ln2_post``) computed in
    bf16, without their f32 upcast; every other norm as it is."""
    sub = dense_blocks(seed, 0, "gemma2-9b")[3]
    post = (sub["ln1_post"], sub["ln2_post"])
    norm = layers.apply_norm

    def post_norms_in_bf16(p, x, eps=1e-6):
        if not any(p is q for q in post):
            return norm(p, x, eps)
        ms = (x * x).mean(-1, keepdim=True)
        return (x * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)
    monkeypatch.setattr(layers, "apply_norm", post_norms_in_bf16)
    d = _dense_block_distance(dense_blocks, seed, 0, "gemma2-9b")
    assert d > DENSE_BLOCK_LIMIT, f"only {d:.3f} of the reference's bf16 drift"


# ---------------------------------------------------------------------------
# one whisper encoder block (bidirectional, LayerNorm, ungated tanh-GELU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_whisper_encoder_block_rounds_where_the_reference_does(
        dense_blocks, seed, layer):
    d = _dense_block_distance(dense_blocks, seed, layer, "whisper-small")
    assert d <= DENSE_BLOCK_LIMIT, f"{d:.3f} of the reference's bf16 drift"


@pytest.mark.parametrize("seed", SEEDS)
def test_layernorm_in_bf16_breaks_the_whisper_block_check(
        dense_blocks, monkeypatch, seed):
    """Every LayerNorm of the block computed in bf16, without its f32
    upcast."""
    dense_blocks(seed, 0, "whisper-small")
    norm = layers.apply_norm

    def layernorm_in_bf16(p, x, eps=1e-6):
        if "bias" not in p:
            return norm(p, x, eps)
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + eps) * p["scale"]
                + p["bias"]).to(x.dtype)
    monkeypatch.setattr(layers, "apply_norm", layernorm_in_bf16)
    d = _dense_block_distance(dense_blocks, seed, 0, "whisper-small")
    assert d > DENSE_BLOCK_LIMIT, f"only {d:.3f} of the reference's bf16 drift"
