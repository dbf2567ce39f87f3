"""StarCoder2-3B and DeepSeek-MoE-16B in the port against the JAX
reference, on the CPU.

Reduced variants (``models.config.reduced``): StarCoder2 keeps its
LayerNorm, ungated tanh-GELU MLP, GQA (4 query heads over 2 kv heads)
and tied head; DeepSeek-MoE keeps one leading dense layer
(``dense_blocks``) before its MoE layer (4 experts, top-2, one shared).
The reference's weights are converted, f32, with the tolerance of
``tests/test_torch_moe.py`` (1e-5 + 1e-4 relative).  The reference runs
its plain path (``use_pallas=False``: its Pallas MoE dispatch needs
``pl.load``, which the installed JAX lacks), the port both of its paths.
As ``tests/test_models_smoke.py`` does for JAX: forward logits at every
position, ``loss_fn`` and its metrics, plus the gradient of the loss;
the configs, ``full`` and ``reduced``; the ``dense_blocks`` conversion
both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import model as M

from test_torch_simulation import fast_reference_compiles, port_cfg

TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ["starcoder2-3b", "deepseek-moe-16b"]


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
        pj = JM.init_params(jax.random.PRNGKey(2), cfg_j)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
        _MODELS[arch] = (cfg_j, pj, cfg, pt)
    return _MODELS[arch]


def _batch(cfg, B=2, S=24, seed=3):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


@pytest.mark.parametrize("variant", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, variant):
    cfg = get_config(arch, variant=variant)
    assert cfg == port_cfg(jax_config(arch, variant=variant)).replace(
        use_kernels=True)
    if arch == "deepseek-moe-16b":
        assert cfg.first_dense_layers == 1 and cfg.d_ff == (
            10944 if variant == "full" else 256)
    else:
        assert (cfg.norm_type, cfg.act, cfg.mlp_gated,
                cfg.tie_embeddings) == ("layernorm", "gelu", False, True)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, use_kernels):
    cfg_j, pj, cfg, pt = models(arch)
    batch = _batch(cfg)
    hj = JM.backbone(pj, cfg_j, {"tokens": jnp.asarray(batch["tokens"])})[0]
    want = np.asarray(JM._head(pj, cfg_j, hj))
    c = cfg.replace(use_kernels=use_kernels)
    ht = M.backbone(pt, c, {"tokens": torch.as_tensor(batch["tokens"])})[0]
    got = M._head(pt, c, ht)
    assert got.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, use_kernels):
    cfg_j, pj, cfg, pt = models(arch)
    batch = _batch(cfg, seed=5)
    (lj, mj), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg_j, {k: jnp.asarray(v)
                                        for k, v in batch.items()}),
        has_aux=True)(pj)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in convert.flatten(pt).items()}
    lt, mt = M.loss_fn(convert.unflatten(leaves),
                       cfg.replace(use_kernels=use_kernels),
                       {k: torch.as_tensor(v) for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    for key in ("nll", "tokens", "accuracy", "aux_loss", "ce_loss"):
        np.testing.assert_allclose(mt[key].item(), float(mj[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    if arch == "deepseek-moe-16b":
        assert float(mj["aux_loss"]) > 0
    want = convert.flatten(jax.tree.map(np.asarray, gj))
    assert set(want) == set(leaves)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_prefill(arch):
    """Prefill of 11 tokens into the paged cache, then one decode step of
    the 12th, against the reference's on the same path."""
    cfg_j, pj, cfg, pt = models(arch)
    toks = _batch(cfg, B=1, S=12, seed=7)["tokens"]
    bl, P = 4, 11
    ids, mask = [1, 2, 3], [True] * 3
    bt = np.array([[1, 2, 3, 0]], np.int32)
    pos = np.array([P], np.int32)
    _, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks[:, :P])})
    cj = JM.scatter_prefill_paged(
        cfg_j, JM.init_paged_cache(cfg_j, 1, 5, bl),
        JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 1, 12),
                              pcj), 0, jnp.asarray(ids), jnp.asarray(mask),
        block_len=bl)
    lj, _ = JM.decode_step(pj, cfg_j, cj, jnp.asarray(toks[:, P:]),
                           jnp.asarray(pos), block_tables=jnp.asarray(bt))
    _, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks[:, :P])})
    ct = M.init_paged_cache(cfg, 1, 5, bl, device="cpu")
    M.scatter_prefill_paged(cfg, ct, M.prefill_into_cache(
        cfg, M.init_decode_cache(cfg, 1, 12, device="cpu"), pct), 0, ids,
        mask, block_len=bl)
    lt, _ = M.decode_step(pt, cfg, ct, torch.as_tensor(toks[:, P:]),
                          torch.as_tensor(pos),
                          block_tables=torch.as_tensor(bt))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    # the same logits as the full 12-token forward's last position
    lf, _ = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(lt.numpy(), lf.numpy(), **TOL)


def test_dense_blocks_round_trip_through_convert():
    cfg_j, pj, cfg, pt = models("deepseek-moe-16b")
    tree = jax.tree.map(np.asarray, pj)
    back = convert.flatten(convert.params_to_jax(pt, cfg))
    want = convert.flatten(tree)
    assert set(back) == set(want)
    assert any(p.startswith("dense_blocks/sub0/mlp/") for p in back)
    for p, a in want.items():
        np.testing.assert_array_equal(back[p], a, err_msg=p)
    # the port's own layout (from a meta init) is the reference's
    meta = convert.flatten(M.init_params(cfg, generator="meta"))
    assert {p: tuple(t.shape) for p, t in meta.items()} == \
        {p: a.shape for p, a in want.items()}
    # a dense_blocks leaf missing or mis-shaped is refused
    bad = dict(want)
    bad["dense_blocks/sub0/mlp/wo"] = bad["dense_blocks/sub0/mlp/wo"][:, :3]
    with pytest.raises(ValueError, match="dense_blocks/sub0/mlp/wo"):
        convert.params_from_jax(convert.unflatten(bad), cfg)
    del bad["dense_blocks/sub0/mlp/wo"]
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_jax(convert.unflatten(bad), cfg)


def test_cache_layouts_carry_dense_blocks():
    """Contiguous and paged caches, the axis maps and the byte counts of
    DeepSeek's layout: one ``dense_blocks`` entry beside ``blocks``."""
    _, _, cfg, _ = models("deepseek-moe-16b")
    c = M.init_decode_cache(cfg, 2, 8, device="meta")
    assert set(c) == {"blocks", "dense_blocks"}
    assert c["dense_blocks"]["sub0"]["k"].shape == (
        1, 2, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
    assert M.decode_cache_seq_axes(cfg)["dense_blocks"]["sub0"]["k"] == 2
    assert M.decode_cache_batch_axes(cfg)["dense_blocks"]["sub0"]["v"] == 1
    per_layer = 2 * 2 * 8 * cfg.n_kv_heads * cfg.resolved_head_dim * 4
    assert M.cache_nbytes(cfg, 2, 8) == cfg.n_layers * per_layer
    pool = M.init_paged_cache(cfg, 3, 6, 4, device="meta")
    assert pool["dense_blocks"]["sub0"]["k"].shape[:3] == (1, 6, 4)
    assert M.paged_cache_nbytes(cfg, 3, 6, 4) == cfg.n_layers * (
        2 * 6 * 4 * cfg.n_kv_heads * cfg.resolved_head_dim * 4)
