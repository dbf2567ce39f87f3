"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device.  On a
machine with one:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

f32 inputs, so the kernels are held to 1e-4 (sums in another order);
``chip_smoke.py`` covers bf16 at the serve and train paths' shapes.
The kd_loss kernel also takes bf16 here: its products are exact in f32,
so only the summation order differs and 1e-4 holds for it too.  The MoE
kernels' bf16 outputs (rounded once from f32, as the plain versions
round) are held to 1e-2 relative (about two bf16 ulps) + 1e-4; the
dispatch kernel adds rows in the plain version's order and must equal
it bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.kd_loss import ops as kd
from repro_torch.kernels.kd_loss.ref import ce_kl_ref, ce_ref
from repro_torch.kernels.paged_attn import ops as pa
from repro_torch.kernels.moe_dispatch import ops as dis
from repro_torch.kernels.moe_gemm import ops as gemm
from repro_torch.kernels.moe_gemm.ref import (grouped_ffn_bwd_ref,
                                              grouped_ffn_ref,
                                              grouped_matmul_ref)
from repro_torch.kernels.paged_attn.ref import paged_attention_ref
from repro_torch.models import model as M
from repro_torch.serve import PagedServeEngine

pytestmark = pytest.mark.gpu
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-4, rtol=1e-2)


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


def test_flash_gradient_is_the_plain_versions(cuda):
    """The kernel's autograd Function: forward by the kernel, backward by
    differentiating the plain version; GQA K/V gradients summed over each
    group's query heads."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 70, H, 64, generator=g, device=cuda)
               for H in (8, 2, 2))
    dout = torch.randn(2, 70, 8, 64, generator=g, device=cuda)
    grads = []
    for fn in (fa.flash_attention, flash_attention_ref):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*qkv, window=30).backward(dout)
        grads.append([t.grad for t in qkv])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **TOL)


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


def _kd_inputs(cuda, T, Ds, Dt, V, dtype, seed=0):
    """Hidden states ~N(0,1), heads ~N(0,1/D) as the model's init draws
    them, so logits are ~N(0,1)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hs = torch.randn(T, Ds, generator=g, device=cuda).to(dtype)
    ws = (torch.randn(Ds, V, generator=g, device=cuda) / Ds ** 0.5).to(dtype)
    lab = torch.randint(0, V, (T,), generator=g, device=cuda,
                        dtype=torch.int32)
    if not Dt:
        return hs, ws, None, None, lab
    ht = torch.randn(T, Dt, generator=g, device=cuda).to(dtype)
    wt = (torch.randn(Dt, V, generator=g, device=cuda) / Dt ** 0.5).to(dtype)
    return hs, ws, ht, wt, lab


def _near_ties(hs, ws, cap, margin=1e-4):
    """Rows whose top two logits differ by less than ``margin``: there the
    argmax may differ with the summation order."""
    z = hs.float() @ ws.float()
    if cap:
        z = torch.tanh(z / cap) * cap
    top = z.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) < margin


@pytest.mark.parametrize("T,Ds,Dt,V,dtype,tau,cap_s,cap_t", [
    (130, 96, 0, 1000, torch.float32, 1.0, 0.0, 0.0),
    (77, 64, 48, 333, torch.float32, 2.0, 30.0, 50.0),
    (256, 256, 128, 4099, torch.bfloat16, 2.0, 0.0, 0.0),
    (200, 40, 0, 777, torch.bfloat16, 1.0, 15.0, 0.0),
    (64, 136, 72, 129, torch.bfloat16, 0.5, 0.0, 20.0)])
def test_kd_loss_kernel_matches_plain(cuda, T, Ds, Dt, V, dtype, tau,
                                      cap_s, cap_t):
    hs, ws, ht, wt, lab = _kd_inputs(cuda, T, Ds, Dt, V, dtype)
    n0 = kd.LAUNCHES
    ce, kl, cor = kd.kd_loss_fwd(hs, ws, ht, wt, lab, tau=tau,
                                 softcap_s=cap_s, softcap_t=cap_t)
    assert kd.LAUNCHES == n0 + 1
    if Dt:
        want_ce, want_kl, want_cor = ce_kl_ref(hs, ws, ht, wt, lab, tau=tau,
                                               softcap_s=cap_s,
                                               softcap_t=cap_t)
        torch.testing.assert_close(kl, want_kl, **TOL)
    else:
        want_ce, want_cor = ce_ref(hs, ws, lab, softcap=cap_s)
        assert (kl == 0).all()
    torch.testing.assert_close(ce, want_ce, **TOL)
    ok = (cor == want_cor) | _near_ties(hs, ws, cap_s)
    assert ok.all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kd_loss_kernel_argmax_ties_take_the_lowest_index(cuda, dtype):
    """Integer inputs make every logit exact in any summation order.  Row r
    has its maximum at two columns in different vocab tiles and splits;
    the kernel, like the reference, must report the lower one."""
    T, V = 96, 5000
    hs = torch.eye(T, device=cuda)                   # z[r] = ws[r]
    ws = torch.randint(-3, 4, (T, V), device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(2)
                       ).float()
    lo = torch.arange(T, device=cuda) * 17 % 2000
    hi = 2500 + torch.arange(T, device=cuda) * 29 % 2400
    rows = torch.arange(T, device=cuda)
    ws[rows, lo] = 9.0
    ws[rows, hi] = 9.0
    lab = torch.where(rows % 2 == 0, lo, hi).to(torch.int32)
    hs, ws = hs.to(dtype), ws.to(dtype)
    ce, _, cor = kd.kd_loss_fwd(hs, ws, None, None, lab)
    want_ce, want_cor = ce_ref(hs, ws, lab)
    assert torch.equal(cor, want_cor)
    assert torch.equal(cor, (rows % 2 == 0).float())
    torch.testing.assert_close(ce, want_ce, **TOL)


def test_kd_loss_refuses_what_it_does_not_take(cuda):
    hs = torch.zeros(4, 8, device=cuda)
    ws = torch.zeros(8, 16, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        kd.kd_loss_fwd(hs, ws, None, None,
                       torch.zeros(4, dtype=torch.int64, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        kd.kd_loss_fwd(hs.half(), ws.half(), None, None,
                       torch.zeros(4, dtype=torch.int32, device=cuda))


# ---------------------------------------------------------------------------
# MoE kernels: grouped matmul (5), grouped FFN (4), gather/scatter-add (6)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ta,tb,da,db,dc", [
    (False, False, torch.float32, torch.float32, torch.float32),
    (True, False, torch.bfloat16, torch.float32, torch.float32),
    (False, True, torch.float32, torch.bfloat16, torch.float32),
    (True, True, torch.bfloat16, torch.bfloat16, torch.bfloat16)])
def test_grouped_matmul_kernel_matches_plain(cuda, ta, tb, da, db, dc):
    """Transposed operands (views), mixed operand dtypes, ragged M, N and
    K (none a multiple of the 128 x 128 x 16 tile)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    E, M, K, N = 3, 130, 37, 70
    a = torch.randn((E, K, M) if ta else (E, M, K), generator=g,
                    device=cuda).to(da)
    b = torch.randn((E, N, K) if tb else (E, K, N), generator=g,
                    device=cuda).to(db)
    a = a.transpose(1, 2) if ta else a
    b = b.transpose(1, 2) if tb else b
    n0 = gemm.LAUNCHES["grouped_matmul"]
    out = gemm.grouped_matmul(a, b, out_dtype=dc)
    assert gemm.LAUNCHES["grouped_matmul"] == n0 + 1
    want = grouped_matmul_ref(a, b, dc)
    torch.testing.assert_close(out, want,
                               **(TOL if dc == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("dtype,act,C,D,F", [
    (torch.float32, "silu", 70, 96, 200),
    (torch.bfloat16, "gelu", 70, 96, 200),
    (torch.bfloat16, "silu", 130, 100, 136),
    (torch.float32, "gelu", 9, 40, 24)])
def test_grouped_ffn_kernel_matches_plain(cuda, dtype, act, C, D, F):
    """Ragged C and F edges; D = 100 takes the scalar loads of x."""
    g = torch.Generator(device=cuda).manual_seed(6)
    E = 3
    x = torch.randn(E, C, D, generator=g, device=cuda).to(dtype)
    wg, wu = (torch.randn(E, D, F, generator=g, device=cuda).div(D ** 0.5)
              .to(dtype) for _ in range(2))
    wo = torch.randn(E, F, D, generator=g, device=cuda).div(F ** 0.5).to(dtype)
    n0 = gemm.LAUNCHES["grouped_ffn"]
    out = gemm.grouped_ffn_fwd(x, wg, wu, wo, act=act)
    assert gemm.LAUNCHES["grouped_ffn"] == n0 + 1
    assert out.dtype == dtype
    want = grouped_ffn_ref(x, wg, wu, wo, act=act)
    torch.testing.assert_close(out, want,
                               **(TOL if dtype == torch.float32 else BF16_TOL))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_ffn_gradient_matches_plain(cuda, act):
    """The backward's eight products through the grouped-matmul kernel
    against the explicit-chain plain backward."""
    g = torch.Generator(device=cuda).manual_seed(7)
    E, C, D, F = 2, 50, 64, 72
    x = torch.randn(E, C, D, generator=g, device=cuda)
    wg, wu = (torch.randn(E, D, F, generator=g, device=cuda) / 8
              for _ in range(2))
    wo = torch.randn(E, F, D, generator=g, device=cuda) / 8
    dy = torch.randn(E, C, D, generator=g, device=cuda)
    args = [t.clone().requires_grad_(True) for t in (x, wg, wu, wo)]
    n0 = gemm.LAUNCHES["grouped_matmul"]
    gemm.grouped_ffn(*args, act=act).backward(dy)
    assert gemm.LAUNCHES["grouped_matmul"] == n0 + 8
    for got, want in zip([t.grad for t in args],
                         grouped_ffn_bwd_ref(x, wg, wu, wo, dy, act=act)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_add_kernel_equals_plain_in_row_order(cuda, dtype):
    """Repeated destinations, untouched destinations, zero scales: the
    kernel sums each destination's rows in row order, exactly as the
    plain version on the CPU does."""
    g = torch.Generator().manual_seed(8)
    Ns, R, n_out, D = 50, 300, 90, 2100   # D past one block's 2048 columns
    src = torch.randn(Ns, D, generator=g).to(dtype)
    sr = torch.randint(0, Ns, (R,), generator=g, dtype=torch.int32)
    dr = torch.randint(0, n_out - 10, (R,), generator=g, dtype=torch.int32)
    scale = torch.randn(R, generator=g)
    scale[::7] = 0
    n0 = dis.LAUNCHES
    out = dis.gather_scatter_add_rows(src.to(cuda), sr.to(cuda), dr.to(cuda),
                                      scale.to(cuda), n_out)
    assert dis.LAUNCHES == n0 + 1
    want = dis.gather_scatter_add_rows(src, sr, dr, scale, n_out)
    assert torch.equal(out.cpu(), want)
    assert (out[n_out - 10:] == 0).all()


def test_moe_ffn_on_card_drops_as_on_the_cpu(cuda):
    """A router biased onto expert 0 overflows its capacity: the card
    drops the assignments the CPU drops, and values and gradients agree
    (f32)."""
    g = torch.Generator().manual_seed(9)
    T, E, k, D, F = 64, 8, 2, 64, 96
    logits = torch.randn(T, E, generator=g)
    logits[:, 0] += 3.0
    w, idx = torch.softmax(logits, -1).topk(k, -1)
    w = w / w.sum(-1, keepdim=True)
    xt = torch.randn(T, D, generator=g)
    ws = [torch.randn(E, D, F, generator=g) / 8,
          torch.randn(E, D, F, generator=g) / 8,
          torch.randn(E, F, D, generator=g) / 8]
    dout = torch.randn(T, D, generator=g)
    res = {}
    for dev in ("cpu", "cuda"):
        args = [t.detach().to(dev).requires_grad_(True)
                for t in [xt, w] + ws]
        out = gemm.moe_ffn(args[0], args[1], idx.to(dev), *args[2:])
        _, keep = dis.capacity_positions(idx.to(dev).reshape(-1),
                                         max(-(-T * k // E) * 2, 8))
        drops = int((~keep).sum())
        out.backward(dout.to(dev))
        res[dev] = (drops, out.detach().cpu(), [a.grad.cpu() for a in args])
    assert res["cuda"][0] == res["cpu"][0] > 0
    torch.testing.assert_close(res["cuda"][1], res["cpu"][1], **TOL)
    for a, b in zip(res["cuda"][2], res["cpu"][2]):
        torch.testing.assert_close(a, b, **TOL)


def test_moe_kernels_refuse_what_they_do_not_take(cuda):
    h = torch.zeros(2, 4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        gemm.grouped_matmul(h, torch.zeros(2, 8, 3, device=cuda,
                                           dtype=torch.float16))
    with pytest.raises(TypeError, match="share a dtype"):
        bf = dict(device=cuda, dtype=torch.bfloat16)
        gemm.grouped_ffn_fwd(torch.zeros(2, 4, 8, device=cuda),
                             *(torch.zeros(s, **bf)
                               for s in ((2, 8, 5), (2, 8, 5), (2, 5, 8))))
    with pytest.raises(ValueError, match="one device"):
        dis.gather_scatter_add_rows(torch.zeros(4, 8, device=cuda),
                                    torch.zeros(3, dtype=torch.int32),
                                    torch.zeros(3, dtype=torch.int32),
                                    torch.ones(3), 2)
