"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device.  On a
machine with one:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

f32 inputs, so the kernels are held to 1e-4 (sums in another order);
``chip_smoke.py`` covers bf16 at the serve path's shapes.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.paged_attn import ops as pa
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,S,H,KH,D,window,softcap", [
    (2, 130, 8, 2, 64, 0, 0.0), (1, 77, 4, 4, 32, 20, 0.0),
    (1, 64, 4, 1, 128, 0, 30.0)])
def test_flash_kernel_matches_plain(cuda, B, S, H, KH, D, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, S, H, D, generator=g, device=cuda)
    k = torch.randn(B, S, KH, D, generator=g, device=cuda)
    v = torch.randn(B, S, KH, D, generator=g, device=cuda)
    n0 = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, window=window, softcap=softcap)
    assert fa.LAUNCHES == n0 + 1
    want = flash_attention_ref(q, k, v, window=window, softcap=softcap)
    torch.testing.assert_close(out, want, **TOL)


@pytest.mark.parametrize("C,window,softcap", [(1, 0, 0.0), (4, 0, 0.0),
                                              (3, 10, 20.0)])
def test_paged_kernel_matches_plain(cuda, C, window, softcap):
    g = torch.Generator(device=cuda).manual_seed(1)
    B, H, KH, D, n_blocks, bl, nbt = 4, 8, 2, 64, 40, 16, 8
    q = torch.randn(B, C, H, D, generator=g, device=cuda)
    kp = torch.randn(n_blocks, bl, KH, D, generator=g, device=cuda)
    vp = torch.randn(n_blocks, bl, KH, D, generator=g, device=cuda)
    bt = torch.randint(0, n_blocks, (B, nbt), generator=g, device=cuda,
                       dtype=torch.int32)
    pos = torch.randint(0, nbt * bl - C + 1, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    n0 = pa.LAUNCHES
    out = pa.paged_decode_attention(q, kp, vp, bt, pos, window=window,
                                    softcap=softcap)
    assert pa.LAUNCHES == n0 + 1
    want = paged_attention_ref(q, kp, vp, bt, pos, window=window,
                               softcap=softcap)
    torch.testing.assert_close(out, want, **TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 8, 4, 48, device=cuda)  # head dim 48 not built
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 4, 8, 64, device=cuda).transpose(1, 2)
        fa.flash_attention(x, x, x)


def test_reduced_engine_on_card_matches_cpu(cuda):
    """Reduced TinyLlama (f32) served through the kernels on the card
    emits the CPU engine's greedy tokens."""
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, P)) for P in (9, 30, 17)]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        eng = PagedServeEngine(p, cfg, n_slots=2, max_len=64, block_len=16,
                               seg_len=4, device=dev)
        for pr in prompts:
            eng.submit({"tokens": pr}, max_new=12)
        outs[dev] = {u: c.tokens.tolist() for u, c in eng.run().items()}
    assert outs["cuda"] == outs["cpu"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
