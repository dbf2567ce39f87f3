"""The port's kernel ops on the CPU (their plain versions) against the JAX
Pallas kernels run in interpret mode and the reference's oracles.

f32 on both sides, inputs made with numpy from a seed; tolerance
atol/rtol 2e-5, as the reference's own paged-kernel test.  The CUDA
kernels themselves are held against these plain versions on the card
(``chip_smoke.py``, ``tests/test_torch_kernels_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro.kernels.paged_attn import ops as jpa
from repro.kernels.paged_attn.ref import paged_attention_ref as jpaged_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attn import ops as pa

TOL = dict(atol=2e-5, rtol=2e-5)

FLASH_CASES = {
    # name: (B, S, H, KH, D, causal, window, softcap)
    "gqa-causal": (2, 32, 8, 2, 16, True, 0, 0.0),
    "mha-causal": (1, 24, 4, 4, 32, True, 0, 0.0),
    "window": (2, 40, 4, 2, 16, True, 9, 0.0),
    "softcap": (1, 32, 4, 1, 16, True, 0, 20.0),
    "ragged": (2, 37, 4, 2, 16, True, 0, 0.0),   # S not a block multiple
    "non-causal": (1, 19, 2, 1, 8, False, 0, 0.0),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_ops_match_pallas_interpret(name):
    B, S, H, KH, D, causal, window, softcap = FLASH_CASES[name]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=16, block_k=16, interpret=True, **kw)
    got = fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                             torch.as_tensor(v), **kw)
    assert got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (7, 0.0), (0, 30.0)])
def test_flash_attention_ref_matches_reference_oracle(window, softcap):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(3, 21, 16)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, window=window, softcap=softcap)
    want = jattention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          **kw)
    got = attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


PAGED_CASES = {
    # name: (B, C, H, KH, D, n_blocks, bl, nbt, window, softcap)
    "gqa-decode": (3, 1, 8, 4, 32, 10, 4, 4, 0, 0.0),
    "mha-softcap": (2, 1, 4, 4, 16, 8, 8, 3, 0, 30.0),
    "window": (4, 1, 8, 2, 32, 12, 4, 5, 6, 0.0),
    "chunk-c4": (3, 4, 8, 2, 16, 12, 4, 5, 0, 0.0),
    "chunk-c3-window": (2, 3, 4, 2, 16, 10, 4, 5, 5, 20.0),
}


def _paged_inputs(B, C, H, KH, D, n_blocks, bl, nbt, seed=2):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, C, H, D)).astype(np.float32)
    kp = rng.normal(size=(n_blocks, bl, KH, D)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, bl, KH, D)).astype(np.float32)
    bt = rng.integers(0, n_blocks, size=(B, nbt)).astype(np.int32)
    # queries pos .. pos + C - 1 stay inside the table
    pos = rng.integers(0, nbt * bl - C + 1, size=(B,)).astype(np.int32)
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_paged_ops_match_pallas_interpret(name):
    B, C, H, KH, D, n_blocks, bl, nbt, window, softcap = PAGED_CASES[name]
    args = _paged_inputs(B, C, H, KH, D, n_blocks, bl, nbt)
    want = jpa.paged_decode_attention(*map(jnp.asarray, args), window=window,
                                      softcap=softcap, interpret=True)
    oracle = jpaged_ref(*map(jnp.asarray, args), window=window,
                        softcap=softcap)
    got = pa.paged_decode_attention(*map(torch.as_tensor, args),
                                    window=window, softcap=softcap)
    assert got.shape == (B, C, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def test_ops_count_no_launch_on_cpu():
    """The CPU path is the plain version: no kernel launch is counted."""
    args = _paged_inputs(2, 1, 4, 2, 16, 6, 4, 3)
    f0, p0 = fa.LAUNCHES, pa.LAUNCHES
    pa.paged_decode_attention(*map(torch.as_tensor, args))
    x = torch.zeros(1, 8, 4, 16)
    fa.flash_attention(x, x[:, :, :2], x[:, :, :2])
    assert (fa.LAUNCHES, pa.LAUNCHES) == (f0, p0)


def test_ops_reject_bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q.double(), q.double())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[..., :8], q[..., :8])      # head dims differ
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :3], q[:, :, :3])    # 4 % 3 heads
    args = list(map(torch.as_tensor, _paged_inputs(2, 1, 4, 2, 16, 6, 4, 3)))
    with pytest.raises(TypeError):
        pa.paged_decode_attention(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError):
        pa.paged_decode_attention(*args[:3], args[3][:1], args[4])


def test_build_target_hashes_included_headers(tmp_path):
    """A library is named by its source and every header it includes, so
    an edit to a shared header rebuilds each source that uses it."""
    from repro_torch.kernels import _build
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text('#include "g.cuh"\nint h;\n')
    (tmp_path / "g.cuh").write_text("int g;\n")
    src = tmp_path / "a.cu"
    assert [f.name for f in _build._sources(src)] == ["a.cu", "h.cuh", "g.cuh"]
    before = _build._target(src)
    (tmp_path / "g.cuh").write_text("int g2;\n")
    after = _build._target(src)
    assert after != before and after.stem.startswith("a-")


@pytest.mark.parametrize("name", ["kd_loss", "moe_gemm"])
def test_wgmma_sources_share_one_header(name):
    """Both wgmma kernels take their TMA, mbarrier and wgmma helpers and
    the tensor-map encoder from one header, which their hash covers."""
    from repro_torch.kernels import _build
    names = [f.name for f in _build._sources(_build.CSRC / f"{name}.cu")]
    assert names == [f"{name}.cu", "tma_wgmma.cuh"]
    text = (_build.CSRC / f"{name}.cu").read_text()
    assert "tma_encoder(&enc)" in text and "cuTensorMapEncodeTiled\"" not in text
