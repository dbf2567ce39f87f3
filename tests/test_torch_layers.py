"""The port's layers against the JAX reference's, f32 on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
parameters are the reference's, carried across by ``repro_torch.convert``.
Tolerance 1e-5: both sides compute in f32, in different orders.
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
from repro_torch.models import layers as L

ATOL = RTOL = 1e-5


def _pair(**overrides):
    cfg_j = jax_config("tinyllama-1.1b", variant="reduced").replace(
        **overrides)
    cfg = get_config("tinyllama-1.1b", variant="reduced").replace(**overrides)
    params = JM.init_params(jax.random.PRNGKey(2), cfg_j)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, params), cfg)
    # layer 0 of the stacked blocks
    jp = jax.tree.map(lambda x: x[0], params["blocks"]["sub0"])
    pp = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
              else v[0]) for k, v in tp["blocks"]["sub0"].items()}
    return cfg_j, cfg, jp, pp


def close(t, a, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), atol=atol,
                               rtol=RTOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=(64,)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=(64,)).astype(np.float32)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = L.apply_norm({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x))
    close(got, want)


@pytest.mark.parametrize("max_pos", [64, 2048])
def test_apply_rope(max_pos):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, max_pos, size=(2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    close(got, want)


def test_attention_qkv():
    cfg_j, cfg, jp, pp = _pair()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want = JL.attention_qkv(jp["attn"], cfg_j, jnp.asarray(x),
                            jnp.asarray(pos))
    got = L.attention_qkv(pp["attn"], cfg, torch.as_tensor(x),
                          torch.as_tensor(pos))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_apply_mlp(gated, act):
    cfg_j, cfg, jp, pp = _pair(mlp_gated=gated, act=act)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = JL.apply_mlp(jp["mlp"], cfg_j, jnp.asarray(x))
    got = L.apply_mlp(pp["mlp"], cfg, torch.as_tensor(x))
    close(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_attention_full(use_kernels):
    cfg_j, cfg, jp, pp = _pair()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(11, dtype=np.int32), (2, 1))
    want, (wk, wv) = JL.attention_full(
        jp["attn"], cfg_j.replace(use_pallas=use_kernels), jnp.asarray(x),
        jnp.asarray(pos), window=0)
    got, (gk, gv) = L.attention_full(
        pp["attn"], cfg.replace(use_kernels=use_kernels), torch.as_tensor(x),
        torch.as_tensor(pos), window=0)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


def _paged_setup(seed=5):
    rng = np.random.default_rng(seed)
    n_blocks, bl, KH, D, B, C = 9, 4, 2, 8, 3, 2
    pool = rng.normal(size=(n_blocks, bl, KH, D)).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 5, 0], [0, 0, 0]], np.int32)
    pos = np.array([[5, 6], [1, 2], [0, 0]], np.int32)
    entry = rng.normal(size=(B, C, KH, D)).astype(np.float32)
    return pool, table, pos, entry


def test_paged_insert_and_gather():
    pool, table, pos, entry = _paged_setup()
    want = JL.paged_insert(jnp.asarray(pool), jnp.asarray(table),
                           jnp.asarray(pos), jnp.asarray(entry))
    tpool = torch.as_tensor(pool.copy())
    got = L.paged_insert(tpool, torch.as_tensor(table), torch.as_tensor(pos),
                         torch.as_tensor(entry))
    assert got is tpool  # written in place
    # the dead slot's duplicate writes to trash row (0, 0) may land in
    # either order; every other row must match exactly
    np.testing.assert_array_equal(got[1:].numpy(), np.asarray(want)[1:])
    np.testing.assert_array_equal(got[0, 1:].numpy(), np.asarray(want)[0, 1:])
    gathered = L.paged_gather(got, torch.as_tensor(table))
    close(gathered, JL.paged_gather(want, jnp.asarray(table)), atol=0)


def test_paged_insert_position_outside_table_raises():
    """The reference's gathers clamp an out-of-table position onto the
    last entry; the port's indexing raises instead."""
    pool, table, pos, entry = _paged_setup()
    pos = pos.copy()
    pos[0, 1] = table.shape[1] * pool.shape[1]  # one past the table
    with pytest.raises(IndexError):
        L.paged_insert(torch.as_tensor(pool), torch.as_tensor(table),
                       torch.as_tensor(pos), torch.as_tensor(entry))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 30.0)])
def test_decode_attention(window, softcap):
    rng = np.random.default_rng(6)
    B, C, H, KH, D, S = 2, 3, 4, 2, 8, 12
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    qpos = np.array([[4, 5, 6], [9, 10, 11]], np.int32)
    kpos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want = JL.decode_attention(*map(jnp.asarray, (q, k, v, qpos, kpos)),
                               window=window, softcap=softcap)
    got = L.decode_attention(*map(torch.as_tensor, (q, k, v, qpos, kpos)),
                             window=window, softcap=softcap)
    close(got, want)


@pytest.mark.parametrize("skip", [False, True])
def test_chunked_attention(skip):
    rng = np.random.default_rng(7)
    B, S, H, KH, D = 2, 37, 4, 2, 8
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kw = dict(causal=True, window=9, softcap=20.0, q_chunk=16, k_chunk=8,
              skip_masked_chunks=skip)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)), **kw)
    got = L.chunked_attention(*map(torch.as_tensor, (q, k, v, pos, pos)),
                              **kw)
    close(got, want)
