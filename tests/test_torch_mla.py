"""DeepSeek-V3's multi-head latent attention (MLA) and multi-token
prediction (MTP) head in the port against the JAX reference, on the CPU.

Reduced ``deepseek-v3-671b`` (``models.config.reduced``): one leading
dense layer and one MoE layer (4 experts, top-2, one shared), MLA ranks
q_lora 32, kv_lora 32, rope 16, nope 32, v 32 over 4 heads, one MTP
head.  f32, the reference's weights converted; the reference runs its
plain path (``use_pallas=False``: its Pallas MoE dispatch needs
``pl.load``, which the installed JAX lacks), the port both of its paths
(at 48 tokens the kernel path's capacity max(ceil(T·k/E)·2, 8) >= T
holds every assignment, so nothing drops).  Tolerance 1e-5 + 1e-4
relative, as ``tests/test_torch_moe.py`` (f32 sums in other orders).

* ``mla_latent``, ``mla_full`` and ``mla_decode`` (contiguous, paged,
  int8 and fp8 latent caches, C 1 and a 3-token chunk) against the
  reference's functions, with and without the query's low-rank path;
* prefill + decode against the full forward, as
  ``tests/test_models_smoke.py`` does for the reference;
* ``loss_fn`` with its ``mtp_loss`` and every gradient;
  ``mtp_chain_loss`` at depth 1 and 3;
* the parameter layout through ``convert`` and the cache layouts;
* planted faults that must break these checks: RoPE on the nope half
  of the query, ``kv_norm`` skipped, the MTP's token roll off by one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers, quant
from repro_torch.models import model as M

from test_torch_simulation import fast_reference_compiles, port_cfg

TOL = dict(atol=1e-5, rtol=1e-4)
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
    """The reference's reduced config (plain path) and weights, the port's
    config (kernel path) and the converted weights."""
    if not _MODELS:
        cfg_j = jax_config(ARCH, variant="reduced").replace(use_pallas=False)
        cfg = get_config(ARCH, variant="reduced")
        assert cfg == port_cfg(cfg_j).replace(use_kernels=True)
        pj = JM.init_params(jax.random.PRNGKey(2), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS["m"] = (cfg_j, pj, cfg, pt)
    return _MODELS["m"]


def _batch(cfg, B=2, S=24, seed=3):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_config_matches_reference(variant):
    cfg = get_config(ARCH, variant=variant)
    assert cfg == port_cfg(jax_config(ARCH, variant=variant)).replace(
        use_kernels=True)
    assert cfg.attn_type == "mla" and cfg.n_mtp == 1
    ranks = (cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim,
             cfg.nope_head_dim, cfg.v_head_dim)
    assert ranks == ((1536, 512, 64, 128, 128) if variant == "full"
                     else (32, 32, 16, 32, 32))


# ---------------------------------------------------------------------------
# one MLA layer against the reference's functions
# ---------------------------------------------------------------------------

def _layer(q_lora: bool):
    """One MLA layer's parameters from the reference's ``init_mla`` in both
    packages, the configs, and a (2, 9, D) input at positions 0..8."""
    cfg_j = jax_config(ARCH, variant="reduced").replace(use_pallas=False)
    if not q_lora:
        cfg_j = cfg_j.replace(q_lora_rank=0)
    cfg = port_cfg(cfg_j)
    pj = JL.init_mla(jax.random.PRNGKey(7), cfg_j, jnp.float32)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    x = np.random.default_rng(8).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    return cfg_j, pj, cfg, pt, x, pos


def _check_full(q_lora: bool):
    cfg_j, pj, cfg, pt, x, pos = _layer(q_lora)
    ckv_j, kr_j = JL.mla_latent(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
    ckv, kr = layers.mla_latent(pt, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    assert ckv.shape == (2, 9, cfg.kv_lora_rank)
    assert kr.shape == (2, 9, cfg.rope_head_dim)
    np.testing.assert_allclose(ckv.numpy(), np.asarray(ckv_j), **TOL)
    np.testing.assert_allclose(kr.numpy(), np.asarray(kr_j), **TOL)
    out_j, _ = JL.mla_full(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos))
    out, (ckv2, kr2) = layers.mla_full(pt, cfg, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    assert torch.equal(ckv2, ckv) and torch.equal(kr2, kr)


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
def test_mla_latent_and_full_match_reference(q_lora):
    _check_full(q_lora)


LAYOUTS = ["contiguous", "paged", "contiguous-int8", "paged-int8",
           "contiguous-fp8", "paged-fp8"]


def _decode_pair(layout, C, q_lora=True):
    """Both packages' ``mla_decode`` at one step: the first 9 - C latents
    written by earlier calls (in both), then C queries at positions
    9 - C .. 8.  Paged: block_len 4, slot 0 on blocks 2, 5, 1 and slot 1
    on blocks 3, 4, 6.  Returns (out_j, cache_j, out_t, cache_t)."""
    cfg_j, pj, cfg, pt, x, pos = _layer(q_lora)
    kv_dtype = layout.split("-")[1] if "-" in layout else ""
    pol_j = JM.quant.CachePolicy(kv_dtype)
    pol = quant.CachePolicy(kv_dtype)
    paged = layout.startswith("paged")
    S = 12
    if paged:
        cj = JM._attn_cache_struct(cfg_j, 8, 4, jnp.float32, pol_j)
        ct = M._attn_cache_struct(cfg, (), 8, 4, device="cpu", policy=pol)
        bt = np.array([[2, 5, 1], [3, 4, 6]], np.int32)
        tab_j = dict(block_table=jnp.asarray(bt))
        tab_t = dict(block_table=torch.from_numpy(bt))
    else:
        cj = JM._attn_cache_struct(cfg_j, 2, S, jnp.float32, pol_j)
        ct = M._attn_cache_struct(cfg, (), 2, S, device="cpu", policy=pol)
        tab_j, tab_t = {}, {}
    for lo, hi in ((0, 9 - C), (9 - C, 9)):
        if hi == lo:
            continue
        xs, ps = x[:, lo:hi], np.ascontiguousarray(pos[:, lo:hi])
        out_j, cj = JL.mla_decode(pj, cfg_j, jnp.asarray(xs), jnp.asarray(ps),
                                  cj, **tab_j)
        out_t, ct = layers.mla_decode(pt, cfg, torch.from_numpy(xs),
                                      torch.from_numpy(ps), ct, **tab_t)
    return out_j, cj, out_t, ct


def _check_decode(layout, C):
    out_j, cj, out_t, ct = _decode_pair(layout, C)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    assert set(ct) == set(cj)
    for key, leaf in ct.items():
        want = np.asarray(cj[key])
        if leaf.dtype in (torch.int8, quant.FP8):
            # codes: the reference's division and rounding, bit for bit
            np.testing.assert_array_equal(leaf.float().numpy(),
                                          want.astype(np.float32),
                                          err_msg=key)
        else:
            np.testing.assert_allclose(leaf.numpy(), want, **TOL,
                                       err_msg=key)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_mla_decode_matches_reference(layout, C):
    _check_decode(layout, C)


def test_mla_decode_absorbs_like_the_full_layer():
    """The absorbed-matrix decode over a cache equals ``mla_full``'s rows
    (W_UK folded into the query, W_UV after the softmax)."""
    _, _, cfg, pt, x, pos = _layer(True)
    want, _ = layers.mla_full(pt, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos.copy()))
    cache = M._attn_cache_struct(cfg, (), 2, 9, device="cpu")
    got, _ = layers.mla_decode(pt, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()), cache)
    torch.testing.assert_close(got, want, **TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _check_decode_continues_forward(cfg_over=None):
    """prefill(x[:S-1]) + decode(x[S-1]) and prefill_chunked + decode,
    each equal to the full forward's last logits, and to the
    reference's decode step."""
    cfg_j, pj, cfg, pt = models()
    S = 16
    toks = _batch(cfg, B=2, S=S, seed=9)["tokens"]
    h = M.backbone(pt, cfg, {"tokens": torch.as_tensor(toks)})[0]
    want = M._head(pt, cfg, h[:, -1:])[:, 0]
    hj = JM.backbone(pj, cfg_j, {"tokens": jnp.asarray(toks)})[0]
    np.testing.assert_allclose(
        want.numpy(), np.asarray(JM._head(pj, cfg_j, hj[:, -1:])[:, 0]),
        **TOL)
    _, pc = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks[:, :-1])})
    cache = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 2, S,
                                                          device="cpu"), pc)
    pos = torch.full((2,), S - 1, dtype=torch.int32)
    got, _ = M.decode_step(pt, cfg, cache, torch.as_tensor(toks[:, -1:]), pos)
    torch.testing.assert_close(got, want, **TOL)
    _, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks[:, :-1])})
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 2, S), pcj)
    lj, _ = JM.decode_step(pj, cfg_j, cj, jnp.asarray(toks[:, -1:]),
                           jnp.asarray(pos.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(lj), **TOL)


def test_decode_continues_the_full_forward():
    _check_decode_continues_forward()


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_logits_match_reference(use_kernels):
    cfg_j, pj, cfg, pt = models()
    batch = _batch(cfg)
    hj = JM.backbone(pj, cfg_j, {"tokens": jnp.asarray(batch["tokens"])})[0]
    want = np.asarray(JM._head(pj, cfg_j, hj))
    c = cfg.replace(use_kernels=use_kernels)
    ht = M.backbone(pt, c, {"tokens": torch.as_tensor(batch["tokens"])})[0]
    np.testing.assert_allclose(M._head(pt, c, ht).numpy(), want, **TOL)


def _check_loss(use_kernels, grads=True):
    cfg_j, pj, cfg, pt = models()
    batch = _batch(cfg, seed=5)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, _jax_batch(batch)), has_aux=True)(pj)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in convert.flatten(pt).items()}
    lt, mt = M.loss_fn(convert.unflatten(leaves),
                       cfg.replace(use_kernels=use_kernels),
                       _torch_batch(batch))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert set(mt) == set(mj) and "mtp_loss" in mt
    for key in mj:
        np.testing.assert_allclose(mt[key].item(), float(mj[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    if not grads:
        return
    lt.backward()
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(want) == set(leaves)
    assert any(k.startswith("mtp/") for k in want)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_loss_with_mtp_and_gradients_match_reference(use_kernels):
    _check_loss(use_kernels)


def _check_chain(depth):
    cfg_j, pj, cfg, pt = models()
    batch = _batch(cfg, seed=11)
    want = JM.mtp_chain_loss(pj, cfg_j, _jax_batch(batch), depth=depth)
    got = M.mtp_chain_loss(pt, cfg, _torch_batch(batch), depth=depth)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    return got, batch


@pytest.mark.parametrize("depth", [1, 3])
def test_mtp_chain_loss_matches_reference(depth):
    got, batch = _check_chain(depth)
    if depth == 1:
        # depth 1 is the loss term's head exactly
        _, _, cfg, pt = models()
        h = M.backbone(pt, cfg, _torch_batch(batch))[0]
        assert got.item() == M._mtp_loss(pt, cfg, h,
                                         _torch_batch(batch)).item()


# ---------------------------------------------------------------------------
# planted faults
# ---------------------------------------------------------------------------

def _rope_on_nope_half(p, cfg, x, positions):
    """RoPE on the first ``rope_head_dim`` features of each query head
    (inside the nope part) instead of the last."""
    B, S, _ = x.shape
    H, nd, pr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = layers.mm(layers.apply_norm(p["q_norm"], layers.mm(x, p["wq_a"])),
                  p["wq_b"]).reshape(B, S, H, nd + pr)
    q = torch.cat([layers.apply_rope(q[..., :pr], positions, cfg.rope_theta),
                   q[..., pr:]], -1)
    return q[..., :nd], q[..., nd:]


def _kv_norm_skipped(p, cfg, x, positions):
    r = cfg.kv_lora_rank
    kv = layers.mm(x, p["wkv_a"])
    k_rope = layers.apply_rope(kv[..., None, r:], positions,
                               cfg.rope_theta)[..., 0, :]
    return kv[..., :r], k_rope


def _mtp_roll_off_by_one(params, cfg, h, tokens, labels, j):
    return own_mtp_step(params, cfg, h, torch.roll(tokens, -1, 1), labels, j)


own_mtp_step = M._mtp_step
FAULTS = {
    "rope_on_nope_half": (layers, "_mla_queries", _rope_on_nope_half),
    "kv_norm_skipped": (layers, "mla_latent", _kv_norm_skipped),
    "mtp_roll_off_by_one": (M, "_mtp_step", _mtp_roll_off_by_one),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_break_the_checks(fault, monkeypatch):
    mod, name, fn = FAULTS[fault]
    monkeypatch.setattr(mod, name, fn)
    if fault == "mtp_roll_off_by_one":
        checks = [lambda: _check_chain(1), lambda: _check_loss(False, False)]
    else:
        checks = [lambda: _check_full(True),
                  lambda: _check_decode("paged", 3),
                  lambda: _check_decode_continues_forward()]
    for check in checks:
        with pytest.raises(AssertionError):
            check()


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def test_parameter_layout_round_trips_through_convert():
    cfg_j, pj, cfg, pt = models()
    want = convert.flatten(jax.tree.map(np.asarray, pj))
    back = convert.flatten(convert.params_to_jax(pt, cfg))
    assert set(back) == set(want)
    for p, a in want.items():
        np.testing.assert_array_equal(back[p], a, err_msg=p)
    meta = convert.flatten(M.init_params(cfg, generator="meta"))
    assert {p: tuple(t.shape) for p, t in meta.items()} == \
        {p: a.shape for p, a in want.items()}
    assert {"mtp/proj", "mtp/norm/scale", "mtp/block/mlp/wi_gate",
            "blocks/sub0/attn/wk_b", "dense_blocks/sub0/attn/wq_a",
            "blocks/sub0/attn/kv_norm/scale"} <= set(meta)


@pytest.mark.parametrize("kv_dtype", ["", "int8", "fp8"])
def test_latent_cache_layouts_match_reference(kv_dtype):
    """Contiguous and paged caches, their axis maps and byte counts
    against the reference's, at the reduced and the full config."""
    for variant in ("reduced", "full"):
        cfg_j = jax_config(ARCH, variant=variant)
        cfg = get_config(ARCH, variant=variant)
        pol_j = JM.quant.CachePolicy(kv_dtype)
        pol = quant.CachePolicy(kv_dtype)
        got = convert.flatten(M.init_decode_cache(cfg, 2, 8, device="meta",
                                                  policy=pol))
        want = convert.flatten(jax.eval_shape(
            lambda: JM.init_decode_cache(cfg_j, 2, 8, policy=pol_j)))
        assert {p: tuple(t.shape) for p, t in got.items()} == \
            {p: tuple(a.shape) for p, a in want.items()}
        assert set(got) == {f"{s}/sub0/{k}" for s in ("blocks",
                                                      "dense_blocks")
                            for k in (("ckv", "kr", "ckv_scale", "kr_scale")
                                      if kv_dtype else ("ckv", "kr"))}
        for fn in ("decode_cache_seq_axes", "decode_cache_batch_axes"):
            assert convert.flatten(getattr(M, fn)(cfg, pol)) == \
                convert.flatten(getattr(JM, fn)(cfg_j, pol_j)), fn
        assert M.cache_nbytes(cfg, 2, 8, pol) == \
            JM.cache_nbytes(cfg_j, 2, 8, pol_j)
        assert M.paged_cache_nbytes(cfg, 3, 6, 4, pol) == \
            JM.paged_cache_nbytes(cfg_j, 3, 6, 4, pol_j)
    # full width: 576 values a token and layer; 584 bytes quantized
    # (512 + 64 codes, two f32 scales) against 1,152 in bf16
    per = M.cache_nbytes(cfg, 1, 1, pol) // cfg.n_layers
    assert per == {"": 1152, "int8": 584, "fp8": 584}[kv_dtype]
