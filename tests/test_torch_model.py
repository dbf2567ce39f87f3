"""The port's dense model against the JAX reference on reduced TinyLlama.

Reference with ``use_pallas=True`` (Pallas kernels in interpret mode);
port with ``use_kernels=True`` on CPU tensors (the kernels' plain
versions).  Same weights (converted), same numpy tokens, f32; logits and
caches agree to 1e-4 (22-op-deep f32 sums in different orders).
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

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced").replace(
        use_pallas=True)
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    pj = JM.init_params(jax.random.PRNGKey(1), cfg_j)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), cfg)
    return cfg_j, pj, cfg, pt


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def test_reduced_config_matches_reference():
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced")
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab_size", "dtype", "rope_theta", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(cfg_j, f), f
    assert cfg.use_kernels and not cfg_j.use_pallas


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_logits_and_cache(models, use_kernels):
    cfg_j, pj, cfg, pt = models
    toks = _tokens(cfg, (2, 13))
    lj, cj = JM.prefill(pj, cfg_j.replace(use_pallas=use_kernels),
                        {"tokens": jnp.asarray(toks)})
    lt, ct = M.prefill(pt, cfg.replace(use_kernels=use_kernels),
                       {"tokens": torch.as_tensor(toks)})
    assert lt.dtype == torch.float32 and lt.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(
            ct["blocks"]["sub0"][key].numpy(),
            np.asarray(cj["blocks"]["sub0"][key]), **TOL)


def _paged_state(cfg_j, pj, cfg, pt, P=9, bl=4):
    """One request prefilled into slot 0 of a 2-slot paged cache, in both
    packages, with the reference's admission path."""
    toks = _tokens(cfg, (1, P))
    lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    n_pb = -(-P // bl)
    ids, mask = [1, 2, 3], [True, True, True]
    cj = JM.init_paged_cache(cfg_j, 2, 9, bl)
    subj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 1,
                                                             n_pb * bl), pcj)
    cj = JM.scatter_prefill_paged(cfg_j, cj, subj, 0, jnp.asarray(ids),
                                  jnp.asarray(mask), block_len=bl)
    lt, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    ct = M.init_paged_cache(cfg, 9, bl, device="cpu")
    subt = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 1, n_pb * bl,
                                                         device="cpu"), pct)
    M.scatter_prefill_paged(cfg, ct, subt, ids, mask, block_len=bl)
    bt = np.array([[1, 2, 3, 4, 0], [0, 0, 0, 0, 0]], np.int32)
    tok = np.array([[int(np.argmax(np.asarray(lj)))], [0]], np.int32)
    pos = np.array([P, 0], np.int32)
    return cj, ct, bt, tok, pos


@pytest.mark.parametrize("use_kernels", [True, False])
def test_paged_decode_step(models, use_kernels):
    cfg_j, pj, cfg, pt = models
    cj, ct, bt, tok, pos = _paged_state(cfg_j, pj, cfg, pt)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"]["sub0"][key].numpy(),
                                   np.asarray(cj["blocks"]["sub0"][key]),
                                   **TOL)
    lj, cj2 = JM.decode_step(pj, cfg_j.replace(use_pallas=use_kernels), cj,
                             jnp.asarray(tok), jnp.asarray(pos),
                             block_tables=jnp.asarray(bt))
    lt, ct2 = M.decode_step(pt, cfg.replace(use_kernels=use_kernels), ct,
                            torch.as_tensor(tok), torch.as_tensor(pos),
                            block_tables=torch.as_tensor(bt))
    assert ct2 is ct  # updated in place
    # slot 1 is a dead lane: its logits are garbage on both sides
    np.testing.assert_allclose(lt[0].numpy(), np.asarray(lj)[0], **TOL)
    # every live pool row matches (trash block 0 takes the dead writes)
    np.testing.assert_allclose(ct2["blocks"]["sub0"]["k"][:, 1:].numpy(),
                               np.asarray(cj2["blocks"]["sub0"]["k"])[:, 1:],
                               **TOL)


def test_contiguous_decode_step(models):
    cfg_j, pj, cfg, pt = models
    P, S = 7, 12
    toks = _tokens(cfg, (2, P), seed=4)
    lj, pcj = JM.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    cj = JM.prefill_into_cache(cfg_j, JM.init_decode_cache(cfg_j, 2, S), pcj)
    lt, pct = M.prefill(pt, cfg, {"tokens": torch.as_tensor(toks)})
    ct = M.prefill_into_cache(cfg, M.init_decode_cache(cfg, 2, S,
                                                       device="cpu"), pct)
    tok = np.argmax(np.asarray(lj), -1).astype(np.int32)[:, None]
    pos = np.full((2,), P, np.int32)
    lj2, _ = JM.decode_step(pj, cfg_j, cj, jnp.asarray(tok), jnp.asarray(pos))
    lt2, _ = M.decode_step(pt, cfg, ct, torch.as_tensor(tok),
                           torch.as_tensor(pos))
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), **TOL)


def test_paged_generate_matches_reference(models):
    """A 5-step paged generate: tokens, liveness and per-step logits."""
    cfg_j, pj, cfg, pt = models
    cj, ct, bt, tok, pos = _paged_state(cfg_j, pj, cfg, pt)
    rem = np.array([4, 0], np.int32)  # slot 1 dead; slot 0 stops early
    rj = JM.generate(pj, cfg_j, cj, jnp.asarray(tok[:, 0]), jnp.asarray(pos),
                     steps=5, remaining=jnp.asarray(rem),
                     block_tables=jnp.asarray(bt), return_logits=True)
    rt = M.generate(pt, cfg, ct, torch.as_tensor(tok[:, 0]),
                    torch.as_tensor(pos), steps=5,
                    remaining=torch.as_tensor(rem),
                    block_tables=torch.as_tensor(bt), return_logits=True)
    valid = np.asarray(rj["valid"])
    np.testing.assert_array_equal(rt["valid"].numpy(), valid)
    np.testing.assert_array_equal(rt["tokens"].numpy()[valid],
                                  np.asarray(rj["tokens"])[valid])
    for key in ("next_tok", "pos", "remaining", "done"):
        np.testing.assert_array_equal(rt[key].numpy()[0],
                                      np.asarray(rj[key])[0])
    np.testing.assert_allclose(rt["logits"].numpy()[0],
                               np.asarray(rj["logits"])[0], **TOL)


def test_unported_family_raises():
    # MoE is ported; DeepSeek's leading dense layers are not
    cfg = get_config("qwen2-moe-a2.7b", variant="reduced").replace(
        first_dense_layers=1)
    with pytest.raises(NotImplementedError):
        M.init_params(cfg, generator=torch.Generator())
