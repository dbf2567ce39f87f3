"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where there is no CUDA device.  On a
machine with one:

  PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

f32 inputs, so the kernels are held to 1e-4 (sums in another order);
``chip_smoke.py`` covers bf16 at the serve and train paths' shapes.
The flash kernel's bf16 instance (tensor cores, split P) is held here at
every head dim, each element within two bf16 ulps of the plain output +
1e-4, the rule ``chip_smoke.py`` holds it to: both accumulate in f32
and round once.
The kd_loss kernel also takes bf16 here: its products are exact in f32,
so only the summation order differs and 1e-4 holds for it too.  Its
instances (``wgmma`` on TMA, ``general``, ``f32``) are held on ragged
edges, counted per instance, launched twice with the same bits, and at
T 2048 with V 32000 and 151936 every vocab tile of the split holds some
row's planted maximum.  The MoE
kernels' bf16 outputs (rounded once from f32, as the plain versions
round) are held to 1e-2 relative (about two bf16 ulps) + 1e-4; the
dispatch kernel adds rows in the plain version's order and must equal
it bit for bit.  The grouped FFN's bf16 instance (tensor cores, h as
two bf16 terms) is also held to the two-ulp rule at its edges: C = 1,
the tune path's C, D and F, F not a multiple of 32 or of 8, odd F, and
misaligned views.
The grouped matmul is held at each instance (``wgmma``, ``wgmma_split``
with an f32 operand split on the card, ``general``, ``f32``) on every
layout and ragged edge, the instance it takes counted, a second launch
bit-identical; the split pass equals its plain version bit for bit.
The paged kernel splits each slot's context across blocks and merges the
slices in a fixed order inside the launch: it is held at every pool
dtype and head dim and at the split's edges (slices emptied by a window
or past the last query, ctx 1, the last table position, a table far
wider than every context, chunks across a slice boundary) to the same
two-ulp rule in bf16, with a second launch bit-identical, the counters
back at zero, and the plain version patched to refuse CUDA tensors.
The SSD scan is held in each instance (``tc``: tensor cores with W, h_in
and B∘w as two bf16 terms; ``general``; ``f32``), bf16 y by the two-ulp
rule of each element as well as of the case's largest |y|, a second
launch bit-identical, and the instance ``ops.instance`` picks checked
on the model's strided views, an odd row stride, P or N not a multiple
of 16, and f32.
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
    q = torch.zeros(1, 8, 4, 40, device=cuda)  # head dim 40 not built
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    pool = torch.zeros(3, 4, 4, 40, device=cuda)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q[:, :1], pool, pool, bt, pos)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros(1, 4, 8, 64, device=cuda).transpose(1, 2)
        fa.flash_attention(x, x, x)


HEAD_DIMS = (16, 24, 32, 64, 96, 112, 128, 256)


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_kernel_takes_every_head_dim(cuda, D):
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn(2, 90, 8, D, generator=g, device=cuda)
    k, v = (torch.randn(2, 90, 2, D, generator=g, device=cuda)
            for _ in range(2))
    out = fa.flash_attention(q, k, v, window=40)
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, window=40),
                               **TOL)


def bf16_err_over_limit(out, want):
    """Largest |out - want| over its limit, two bf16 ulps of |want| +
    1e-4: the rule ``chip_smoke.py::check_close`` holds bf16 kernels to
    (``test_torch_flash_numerics.py`` takes it from here)."""
    out, ref = out.float(), want.float()
    _, e = torch.frexp(ref)     # |ref| in [2**(e-1), 2**e)
    ulp = torch.ldexp(torch.full_like(ref, torch.finfo(torch.bfloat16).eps),
                      e - 1)
    return ((out - ref).abs() / (2 * ulp + 1e-4)).max().item()


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("B,S,H,KH,window,softcap", [
    (1, 200, 8, 8, 50, 0.0),     # GQA 1, ragged S, window
    (2, 97, 8, 4, 0, 30.0),      # GQA 2, softcap
    (1, 47, 8, 1, 0, 0.0),       # GQA 8, S < 64
    (2, 1, 4, 4, 0, 0.0)])       # S = 1
def test_flash_bf16_kernel_matches_plain(cuda, B, S, H, KH, D, window,
                                         softcap):
    g = torch.Generator(device=cuda).manual_seed(D + S)
    q = torch.randn(B, S, H, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, KH, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    n0 = fa.LAUNCHES
    out = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    worst = bf16_err_over_limit(out, flash_attention_ref(q, k, v, **kw))
    assert torch.isfinite(out).all() and worst <= 1.0, worst


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_flash_bf16_refuses_unaligned_rows(cuda, name):
    """The bf16 kernel copies rows 16 bytes at a time: a contiguous view
    one element into its storage is refused by name, before a launch."""
    qkv = {n: torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16, device=cuda)
           for n in "qkv"}
    qkv[name] = torch.zeros(1 + 8 * 4 * 64, dtype=torch.bfloat16,
                            device=cuda)[1:].view(1, 8, 4, 64)
    assert qkv[name].is_contiguous()
    n0 = fa.LAUNCHES
    with pytest.raises(ValueError, match=f"{name} must be 16-byte aligned"):
        fa.flash_attention(qkv["q"], qkv["k"], qkv["v"])
    assert fa.LAUNCHES == n0


@pytest.mark.parametrize("H,KH,D", [(8, 8, 64), (8, 2, 64), (4, 4, 128)])
def test_flash_bf16_gradient_is_the_plain_versions(cuda, H, KH, D):
    """bf16: the forward goes through the kernel, and the backward
    differentiates the plain version on the saved inputs, so the
    gradients are the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn(2, 130, n, D, generator=g, device=cuda)
               .bfloat16() for n in (H, KH, KH))
    dout = torch.randn(2, 130, H, D, generator=g, device=cuda).bfloat16()
    grads = []
    for fn in (fa.flash_attention, flash_attention_ref):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        n0 = fa.LAUNCHES
        fn(*qkv, window=70).backward(dout)
        assert fa.LAUNCHES == n0 + (fn is fa.flash_attention)
        grads.append([t.grad for t in qkv])
    for got, want in zip(*grads):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want)


def _paged_inputs(cuda, D, C, seed, spread=0.0):
    """Pools whose rows are N(0,1) times 2^u, u uniform in
    [-spread, spread] per (position, kv head), less spread."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    B, H, KH, n_blocks, bl, nbt = 3, 8, 2, 30, 8, 8

    def rows():
        u = (torch.rand(n_blocks, bl, KH, 1, generator=g, device=cuda) * 2
             - 1) * spread - spread
        return torch.randn(n_blocks, bl, KH, D, generator=g,
                           device=cuda) * torch.exp2(u)
    q = 2 * torch.randn(B, C, H, D, generator=g, device=cuda)
    bt = torch.randint(0, n_blocks, (B, nbt), generator=g, device=cuda,
                       dtype=torch.int32)
    pos = torch.randint(0, nbt * bl - C + 1, (B,), generator=g, device=cuda,
                        dtype=torch.int32)
    return q, rows(), rows(), bt, pos


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_paged_kernel_takes_every_head_dim(cuda, D):
    q, kp, vp, bt, pos = _paged_inputs(cuda, D, 2, D)
    out = pa.paged_decode_attention(q, kp, vp, bt, pos, softcap=30.0)
    torch.testing.assert_close(
        out, paged_attention_ref(q, kp, vp, bt, pos, softcap=30.0), **TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_paged_dequant_branch_matches_plain(cuda, kv, D):
    """Scales spanning 2^8 across rows and heads; the plain version with
    permuted scales lands far away, so a misplaced scale would fail."""
    from repro_torch.models import quant
    q, kr, vr, bt, pos = _paged_inputs(cuda, D, 3, 100 + D, spread=4.0)
    kp, ks = quant.quantize(kr, kv)
    vp, vs = quant.quantize(vr, kv)
    kw = dict(window=20, out_dtype=torch.float32)
    n0, n0q = pa.LAUNCHES, pa.LAUNCHES_QUANT
    out = pa.paged_decode_attention(q, kp, vp, bt, pos, k_scale=ks,
                                    v_scale=vs, **kw)
    assert (pa.LAUNCHES, pa.LAUNCHES_QUANT) == (n0, n0q + 1)
    want = paged_attention_ref(q, kp, vp, bt, pos, k_scale=ks, v_scale=vs,
                               **kw)
    torch.testing.assert_close(out, want, **TOL)
    g = torch.Generator(device=cuda).manual_seed(7)
    for ksc, vsc in ((ks.reshape(-1)[torch.randperm(
            ks.numel(), generator=g, device=cuda)].reshape(ks.shape), vs),
                     (ks, vs.reshape(-1)[torch.randperm(
                         vs.numel(), generator=g, device=cuda)].reshape(
                             vs.shape))):
        moved = paged_attention_ref(q, kp, vp, bt, pos, k_scale=ksc,
                                    v_scale=vsc, **kw)
        assert ((moved - want).norm() / want.norm()).item() > 0.1


def test_paged_kernel_mixed_dtypes(cuda):
    """A bf16 pool under an f32 model (kv_dtype="bf16"), bf16 output by
    default, and an f32 pool under bf16 q."""
    q, kp, vp, bt, pos = _paged_inputs(cuda, 64, 1, 5)
    for qd, pd in ((torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32)):
        args = (q.to(qd), kp.to(pd), vp.to(pd), bt, pos)
        out = pa.paged_decode_attention(*args)
        assert out.dtype == pd
        torch.testing.assert_close(out.float(),
                                   paged_attention_ref(*args).float(),
                                   **BF16_TOL)


PAGED_POOLS = ("f32", "bf16", "int8", "fp8")


def _split_inputs(cuda, ctx, C, H, KH, D, bl, pool, *, nbt=None, seed=0):
    """Slots holding ctx[b] positions (their queries the last C), blocks
    scattered over the pool, table entries past a slot's blocks at block
    0, as the engine leaves them.  Rows N(0, 1); for int8/fp8 times 2^u,
    u uniform in [-8, 0] per (position, kv head), quantized.  -> the
    kernel's arguments and keywords."""
    from repro_torch.models import quant
    g = torch.Generator(device=cuda).manual_seed(seed)
    B = len(ctx)
    nbt = nbt or -(-max(ctx) // bl)
    need = [-(-c // bl) for c in ctx]
    n_blocks = 1 + sum(need)
    perm = torch.randperm(n_blocks - 1, generator=g, device=cuda) + 1
    bt = torch.zeros(B, nbt, dtype=torch.int32, device=cuda)
    o = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[o:o + n].int()
        o += n
    pos = torch.tensor([c - C for c in ctx], dtype=torch.int32, device=cuda)
    shape = (n_blocks, bl, KH, D)
    q = 2 * torch.randn(B, C, H, D, generator=g, device=cuda)
    if pool in ("f32", "bf16"):
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        kp, vp = (torch.randn(shape, generator=g, device=cuda).to(dt)
                  for _ in range(2))
        return (q.to(dt), kp, vp, bt, pos), {}

    def rows():
        u = torch.rand(shape[:3] + (1,), generator=g, device=cuda) * -8
        return torch.randn(shape, generator=g, device=cuda) * torch.exp2(u)
    (kp, ks), (vp, vs) = quant.quantize(rows(), pool), quant.quantize(
        rows(), pool)
    out = torch.bfloat16 if pool == "int8" else torch.float32
    return (q.to(out), kp, vp, bt, pos), dict(k_scale=ks, v_scale=vs,
                                              out_dtype=out)


def _hold_split(monkeypatch, args, kw, *, splits=True):
    """The kernel on one case: no CUDA input reaches the plain version,
    one launch is counted, the output keeps ``chip_smoke.py``'s rule
    against the plain version (two bf16 ulps + 1e-4, or 1e-4 in f32), a
    second launch gives the same bits, and the counters are back at 0."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(pa, "paged_attention_ref", refuse)
    q, kp, _, bt, _ = args
    B, C, H, D = q.shape
    _, n_split = pa.split_plan(B, C, H, kp.shape[2], D, kp.element_size(),
                               kp.shape[1], bt.shape[1],
                               torch.cuda.get_device_properties(
                                   q.device).multi_processor_count)
    assert (n_split > 1) == splits
    n0 = pa.LAUNCHES + pa.LAUNCHES_QUANT
    out = pa.paged_decode_attention(*args, **kw)
    assert pa.LAUNCHES + pa.LAUNCHES_QUANT == n0 + 1
    want = paged_attention_ref(*args, **kw)
    assert out.dtype == want.dtype and torch.isfinite(out).all()
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, want, **TOL)
    else:
        worst = bf16_err_over_limit(out, want)
        assert worst <= 1.0, worst
    assert torch.equal(out, pa.paged_decode_attention(*args, **kw))
    if splits:
        assert not pa._COUNTERS[q.device.index].any()


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("pool", PAGED_POOLS)
def test_paged_split_kernel_takes_every_pool_and_head_dim(cuda, monkeypatch,
                                                          pool, D):
    """Four slots (one at pos 0) over a split context, a chunk of C = 2,
    GQA 4, a window and a softcap."""
    args, kw = _split_inputs(cuda, [2, 70, 300, 130], 2, 8, 2, D, 16, pool,
                             seed=D)
    _hold_split(monkeypatch, args, dict(window=90, softcap=30.0, **kw))


SPLIT_EDGES = {
    # name: (ctx per slot, C, H, KH, D, block_len, nbt, window)
    # the leftmost slices of the long slots hold no visible key
    "window_empties_slices": ([1000, 700, 300], 1, 8, 2, 64, 16, None, 100),
    "ctx_1": ([1, 1, 50], 1, 8, 2, 64, 16, 20, 0),
    # slot 0's last query sits at the table's last position
    "last_table_position": ([256, 100], 3, 8, 2, 64, 16, 16, 0),
    # a table far wider than every context: the tail slices see trash
    # entries only
    "wide_table": ([40, 200, 90], 1, 8, 2, 64, 16, 256, 0),
    "chunk_across_slices": ([66, 130, 300], 4, 8, 2, 64, 8, None, 0),
    "serve_shape": ([int(c) for c in np.linspace(64, 1088, 8)], 1, 32, 4,
                    64, 16, None, 0),
}


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("name", sorted(SPLIT_EDGES))
def test_paged_split_kernel_edge_cases(cuda, monkeypatch, name, pool):
    ctx, C, H, KH, D, bl, nbt, window = SPLIT_EDGES[name]
    args, kw = _split_inputs(cuda, ctx, C, H, KH, D, bl, pool, nbt=nbt)
    _hold_split(monkeypatch, args, dict(window=window, **kw))


@pytest.mark.parametrize("pool", PAGED_POOLS)
def test_paged_unsplit_entry_matches_plain(cuda, monkeypatch, pool):
    """Shapes whose plan has one slice take the entry without scratch:
    one block per (kv head, slot, 8 query rows) walks the context."""
    args, kw = _split_inputs(cuda, [40, 64, 9], 2, 8, 2, 64, 16, pool)
    _hold_split(monkeypatch, args, dict(window=20, **kw), splits=False)


def test_paged_tile_keys_match_the_kernel(cuda):
    """The split plan's tile keys (Python) are the CUDA instances', and
    every instance fits the 227 KB of shared memory a block may opt in
    to."""
    for dt in (torch.float32, torch.bfloat16, torch.int8,
               torch.float8_e4m3fn):
        for D in HEAD_DIMS:
            tk, smem = pa.kernel_config(dt, D)
            assert tk == pa.tile_keys(D, dt.itemsize), (dt, D)
            assert 0 < smem <= 232448, (dt, D, smem)


@pytest.mark.parametrize("kv", ["int8", "fp8", "bf16"])
def test_reduced_quantized_engine_on_card_matches_cpu(cuda, kv):
    """Reduced TinyLlama (f32) with a quantized or bf16 KV pool, served
    through the kernels on the card, emits the CPU engine's tokens."""
    cfg = get_config("tinyllama-1.1b", variant="reduced")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, P)) for P in (9, 30, 17)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = PagedServeEngine(_to(params, dev), cfg, n_slots=2, max_len=64,
                               block_len=16, seg_len=4, device=dev,
                               kv_dtype=kv)
        for pr in prompts:
            eng.submit({"tokens": pr}, max_new=12)
        outs[dev] = {u: c.tokens.tolist() for u, c in eng.run().items()}
    assert outs["cuda"] == outs["cpu"]


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
    (64, 136, 72, 129, torch.bfloat16, 0.5, 0.0, 20.0),
    # the wgmma instance on ragged T, V and D
    (130, 136, 0, 4104, torch.bfloat16, 1.0, 0.0, 0.0),
    (2049, 256, 0, 32008, torch.bfloat16, 1.0, 15.0, 0.0),
    (130, 136, 72, 4104, torch.bfloat16, 0.5, 0.0, 20.0),
    (2049, 136, 200, 32008, torch.bfloat16, 2.0, 30.0, 0.0),
    (1, 8, 8, 8, torch.bfloat16, 1.0, 0.0, 0.0)])
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


@pytest.mark.parametrize("T,Ds,Dt,V,misalign,want", [
    (130, 136, 0, 4104, False, "wgmma"),
    (130, 136, 72, 4104, False, "wgmma"),
    (130, 136, 0, 4099, False, "general"),
    (130, 136, 70, 4104, False, "general"),
    (130, 132, 0, 4104, False, "general"),
    (130, 136, 0, 4104, True, "general")])
def test_kd_loss_counts_launches_by_instance(cuda, T, Ds, Dt, V, misalign,
                                             want):
    hs, ws, ht, wt, lab = _kd_inputs(cuda, T, Ds, Dt, V, torch.bfloat16)
    if misalign:
        hs = torch.cat([hs.new_zeros(1), hs.flatten()])[1:].view(T, Ds)
    assert kd.instance(hs, ws, ht, wt) == want
    before, n0 = dict(kd.LAUNCHES_BY_INSTANCE), kd.LAUNCHES
    kd.kd_loss_fwd(hs, ws, ht, wt, lab)
    assert kd.LAUNCHES == n0 + 1
    assert {k: v - before[k] for k, v in kd.LAUNCHES_BY_INSTANCE.items()} \
        == {k: int(k == want) for k in before}


@pytest.mark.parametrize("T,Ds,Dt,V,dtype", [
    (2049, 136, 0, 32008, torch.bfloat16),
    (2049, 136, 200, 32008, torch.bfloat16),
    (256, 256, 128, 4099, torch.bfloat16),
    (130, 96, 0, 1000, torch.float32)])
def test_kd_loss_repeats_bit_identical(cuda, T, Ds, Dt, V, dtype):
    """The splits merge in a fixed order, without atomics."""
    x = _kd_inputs(cuda, T, Ds, Dt, V, dtype)
    one = kd.kd_loss_fwd(*x, tau=2.0)
    two = kd.kd_loss_fwd(*x, tau=2.0)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("V", [32000, 151936])
def test_kd_loss_splits_cover_every_tile(cuda, V):
    """At the train and tune paths' T and V, row r's logits are ws[r]
    (hs the identity), integers in [-3, 3] with a 9 in vocab tile
    r % n_tiles: every tile of every split holds some row's maximum, so a
    tile left out would show in ce and correct."""
    T = D = 2048
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, tile_v = kd.tile_shape("wgmma")
    ns, tps = kd.vocab_splits(T, V, n_sm)
    n_tiles = -(-V // tile_v)
    assert (ns - 1) * tps < n_tiles <= ns * tps and n_tiles <= T
    g = torch.Generator(device=cuda).manual_seed(3)
    rows = torch.arange(T, device=cuda)
    col = (rows % n_tiles) * tile_v + rows * 7 % tile_v
    col = torch.minimum(col, torch.full_like(col, V - 1))
    hs = torch.eye(T, D, device=cuda).bfloat16()
    ws = torch.randint(-3, 4, (D, V), generator=g, device=cuda)
    ws[rows, col] = 9
    ws = ws.bfloat16()
    lab = col.to(torch.int32)
    assert kd.instance(hs, ws) == "wgmma"
    ce, _, cor = kd.kd_loss_fwd(hs, ws, None, None, lab)
    want_ce, _ = ce_ref(hs, ws, lab)
    assert (cor == 1).all()
    torch.testing.assert_close(ce, want_ce, **TOL)


@pytest.mark.parametrize("Dt", [0, 72])
def test_kd_loss_wgmma_on_a_fresh_thread(cuda, Dt):
    """kd_loss is recomputed in the backward, on autograd's thread: its
    tensor maps are encoded on a thread with no current context."""
    hs, ws, ht, wt, lab = _kd_inputs(cuda, 130, 136, Dt, 4104,
                                     torch.bfloat16)
    assert kd.instance(hs, ws, ht, wt) == "wgmma"
    got = _on_a_fresh_thread(
        lambda: kd.kd_loss_fwd(hs, ws, ht, wt, lab, tau=2.0))
    want = kd.kd_loss_fwd(hs, ws, ht, wt, lab, tau=2.0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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

_bf, _f32 = torch.bfloat16, torch.float32
# instance: (A transposed view, B transposed view, A dtype, B dtype, out
# dtype, split operand, two products, (E, M, K, N)).  M, N and K ragged
# against the 128 x 256 (x 128) x 64 tiles; K-major operands' rows a
# multiple of 8 elements where TMA must take them.
GMM_CASES = [
    ("wgmma", False, False, _bf, _bf, _f32, None, False, (3, 130, 136, 200)),
    ("wgmma", False, True, _bf, _bf, _bf, None, False, (3, 130, 136, 69)),
    ("wgmma", True, False, _bf, _bf, _f32, None, False, (3, 136, 37, 200)),
    ("wgmma", True, True, _bf, _bf, _bf, None, True, (2, 72, 136, 130)),
    ("wgmma_split", False, True, _f32, _bf, _bf, "a", True,
     (2, 130, 136, 264)),
    ("wgmma_split", True, False, _f32, _bf, _f32, "a", False,
     (3, 136, 37, 200)),
    ("wgmma_split", True, False, _bf, _f32, _bf, "b", False,
     (3, 200, 100, 136)),
    ("wgmma_split", False, False, _f32, _bf, _f32, "a", False,
     (2, 130, 72, 200)),
    ("general", False, False, _bf, _bf, _f32, None, False, (3, 130, 37, 70)),
    ("general", True, False, _bf, _f32, _f32, None, False, (3, 130, 37, 70)),
    ("general", False, True, _f32, _bf, _bf, "a", True, (2, 130, 37, 70)),
    ("f32", False, False, _f32, _f32, _f32, None, False, (3, 130, 37, 70)),
    ("f32", True, True, _f32, _f32, _f32, None, True, (2, 130, 37, 70)),
    # an unsplit f32 operand beside a bf16 one (gmm_kernel<float, bf16,
    # float>), and bf16 transposed views whose rows TMA cannot take
    ("general", False, True, _f32, _bf, _f32, None, False, (3, 130, 37, 70)),
    ("general", True, True, _bf, _bf, _bf, None, False, (3, 130, 37, 70)),
]


@pytest.mark.parametrize(
    "inst,ta,tb,da,db,dc,split,two,size", GMM_CASES,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(GMM_CASES)])
def test_grouped_matmul_kernel_matches_plain(cuda, inst, ta, tb, da, db, dc,
                                             split, two, size):
    """Every instance on transposed views, ragged M, N and K (K below one
    tile too), one or two products, f32 or bf16 out; an f32 operand split
    on the card where ``split`` names it.  The instance taken is counted
    and asserted, the output held to the plain version on the f32 values,
    and a second launch gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    E, M, K, N = size
    pairs, plain = [], []
    for _ in range(2 if two else 1):
        a = torch.randn((E, K, M) if ta else (E, M, K), generator=g,
                        device=cuda).to(da)
        b = (torch.randn((E, N, K) if tb else (E, K, N), generator=g,
                         device=cuda) / K ** 0.5).to(db)
        a = a.transpose(1, 2) if ta else a
        b = b.transpose(1, 2) if tb else b
        plain.append((a, b))
        if split == "a":
            a = gemm.split_f32(a.transpose(1, 2)).transpose(1, 2) if ta \
                else gemm.split_f32(a)
        if split == "b":
            b = gemm.split_f32(b.transpose(1, 2)).transpose(1, 2) if tb \
                else gemm.split_f32(b)
        pairs.append((a, b))
    plus = pairs[1] if two else None
    assert gemm.instance(*pairs[0], plus=plus) == inst
    n0 = dict(gemm.LAUNCHES_BY_INSTANCE)
    out = gemm.grouped_matmul(*pairs[0], out_dtype=dc, plus=plus)
    assert gemm.LAUNCHES_BY_INSTANCE[inst] == n0[inst] + 1
    assert sum(gemm.LAUNCHES_BY_INSTANCE.values()) == sum(n0.values()) + 1
    want = grouped_matmul_ref(*plain[0], dc,
                              plain[1] if two else None)
    torch.testing.assert_close(out, want,
                               **(TOL if dc == torch.float32 else BF16_TOL))
    assert torch.equal(out, gemm.grouped_matmul(*pairs[0], out_dtype=dc,
                                                plus=plus))


def _on_a_fresh_thread(fn):
    """fn() run on a new thread, after one call on this one (so the
    kernel's one-time set-up, which would make the context current, is
    done).  Autograd runs the backward on a thread of its own, where the
    runtime has not yet made the device's context current."""
    import threading
    fn()
    torch.cuda.synchronize()
    got, errors = [], []

    def run():
        try:
            got.append(fn())
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors, errors
    return got[0]


def test_grouped_matmul_wgmma_on_a_fresh_thread(cuda):
    """The tensor maps are encoded on a thread with no current context."""
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.randn(2, 130, 136, generator=g, device=cuda).bfloat16()
    b = torch.randn(2, 136, 200, generator=g, device=cuda).bfloat16()
    assert gemm.instance(a, b) == "wgmma"
    got = _on_a_fresh_thread(lambda: gemm.grouped_matmul(a, b))
    want = grouped_matmul_ref(a, b, torch.float32)
    torch.testing.assert_close(got, want, **TOL)


def test_split_f32_kernel_equals_plain(cuda):
    """Both bf16 terms bit for bit, on a length the vector path does not
    divide (a scalar tail) and on an offset view (scalar only)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    t = torch.randn(3, 130, 37, generator=g, device=cuda) * 1e3
    for v in (t, t.reshape(-1)[1:]):
        n0 = gemm.LAUNCHES["split_f32"]
        got = gemm.split_f32(v)
        assert gemm.LAUNCHES["split_f32"] == n0 + 1
        want = gemm.split_f32(v.cpu())
        assert torch.equal(got.hi.cpu(), want.hi)
        assert torch.equal(got.lo.cpu(), want.lo)


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


@pytest.mark.parametrize("E,C,D,F,act,off", [
    (2, 1, 256, 200, "silu", None),        # C = 1
    (2, 548, 2048, 1408, "silu", None),    # the tune path's C, D and F
    (3, 70, 96, 200, "gelu", None),        # F not a multiple of 32
    (2, 33, 64, 90, "silu", None),         # F not a multiple of 8
    (2, 33, 72, 45, "gelu", None),         # F odd
    (2, 130, 256, 200, "silu", "x"),       # x off 16-byte alignment
    (2, 130, 256, 200, "gelu", "wo")])     # wo off 16-byte alignment
def test_grouped_ffn_bf16_kernel_keeps_the_two_ulp_rule(cuda, monkeypatch, E,
                                                        C, D, F, act, off):
    """The tensor-core instance (h carried as two bf16 terms) against the
    plain version under ``chip_smoke.py``'s rule.  Rows unfit for 16-byte
    copies and misaligned views are taken by element-wise loads, on the
    kernel: a CUDA tensor never reaches the plain version."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(gemm, "grouped_ffn_ref", refuse)
    g = torch.Generator(device=cuda).manual_seed(C + F)
    shapes = {"x": (E, C, D), "wg": (E, D, F), "wu": (E, D, F),
              "wo": (E, F, D)}
    scale = {"x": 1.0, "wg": D ** -0.5, "wu": D ** -0.5, "wo": F ** -0.5}
    ts = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape)) + (name == off)
        flat = (torch.randn(n, generator=g, device=cuda) * scale[name]
                ).bfloat16()
        ts[name] = flat[int(name == off):].view(shape)
    if off:
        assert ts[off].is_contiguous() and ts[off].data_ptr() % 16
    n0 = gemm.LAUNCHES["grouped_ffn"]
    out = gemm.grouped_ffn_fwd(*ts.values(), act=act)
    assert gemm.LAUNCHES["grouped_ffn"] == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == (E, C, D)
    worst = bf16_err_over_limit(out, grouped_ffn_ref(*ts.values(), act=act))
    assert torch.isfinite(out).all() and worst <= 1.0, worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_ffn_gradient_matches_plain(cuda, act, dtype):
    """The backward's eight products through the grouped-matmul kernel
    (seven launches: dx's two products in one) against the explicit-chain
    plain backward in f32.  f32: the f32 instance, to 1e-4.  bf16: three
    wgmma and four wgmma_split launches after three splits, each
    gradient rounded once to bf16, to two bf16 ulps + 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(7)
    E, C, D, F = 2, 50, 64, 72
    x = torch.randn(E, C, D, generator=g, device=cuda).to(dtype)
    wg, wu = (torch.randn(E, D, F, generator=g, device=cuda).div(8).to(dtype)
              for _ in range(2))
    wo = torch.randn(E, F, D, generator=g, device=cuda).div(8).to(dtype)
    dy = torch.randn(E, C, D, generator=g, device=cuda).to(dtype)
    args = [t.clone().requires_grad_(True) for t in (x, wg, wu, wo)]
    n0 = dict(gemm.LAUNCHES)
    by0 = dict(gemm.LAUNCHES_BY_INSTANCE)
    gemm.grouped_ffn(*args, act=act).backward(dy)
    assert gemm.LAUNCHES["grouped_matmul"] == n0["grouped_matmul"] + 7
    by = {k: v - by0[k] for k, v in gemm.LAUNCHES_BY_INSTANCE.items()}
    if dtype == torch.float32:
        assert by == {"wgmma": 0, "wgmma_split": 0, "general": 0, "f32": 7}
        assert gemm.LAUNCHES["split_f32"] == n0["split_f32"]
    else:
        assert by == {"wgmma": 3, "wgmma_split": 4, "general": 0, "f32": 0}
        assert gemm.LAUNCHES["split_f32"] == n0["split_f32"] + 3
    for got, want in zip([t.grad for t in args],
                         grouped_ffn_bwd_ref(x, wg, wu, wo, dy, act=act)):
        assert got.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **TOL)
        else:
            assert bf16_err_over_limit(got, want.to(dtype)) <= 1.0


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


# ---------------------------------------------------------------------------
# the token dispatch/combine (kernel 6): vec and general instances
# ---------------------------------------------------------------------------

# dscale against the plain .sum(-1), relative to sum |a_i b_i|: a bound
# of the two orders' rounding depth at these D, not a reading
# (tests/test_torch_dispatch_numerics.py states it and its readings)
DSCALE_REL = 1e-5


def _routing_case(cuda, T, E, k, D, dtype, bias, *, off=None, seed=0):
    """Softmax-top-k routing of T tokens from random logits (``bias`` on
    expert 0: assignments drop into slot 0), the reference's capacity;
    tokens, expert outputs and the two outputs' gradients on the card.
    ``off`` names the one of xt / y2d made a view one element into its
    storage (off 16-byte alignment)."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def draw(name, rows):
        t = torch.randn(rows * D + 1, generator=g, device=cuda).to(dtype)
        return t[1:].view(rows, D) if name == off else t[:-1].view(rows, D)
    logits = torch.randn((T, E), generator=g, device=cuda)
    logits[:, 0] += bias
    w, idx = torch.softmax(logits, -1).topk(k, -1)
    w = w / w.sum(-1, keepdim=True)
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    pos, keep = dis.capacity_positions(flat_e, cap)
    return dict(w=w.reshape(-1), flat_tok=torch.arange(T * k, device=cuda)
                // k, slot=flat_e * cap + pos, keep=keep, cap=cap, E=E, T=T,
                k=k, xt=draw("xt", T), y2d=draw("y2d", E * cap),
                dbuf=draw("dbuf", E * cap), dout=draw("dout", T))


def _movements(c, dev):
    """The four movements of one routing on ``dev`` through the autograd
    Functions with ``moe_ffn``'s shared layouts: dispatch, combine, and
    both backwards with the routing weights' gradient."""
    t = {n: v.to(dev) if torch.is_tensor(v) else v for n, v in c.items()}
    xt, y2d, w = (t[n].detach().requires_grad_(True)
                  for n in ("xt", "y2d", "w"))
    lay = dis.routing_layouts(t["flat_tok"], t["slot"], t["keep"],
                              t["E"] * t["cap"], t["T"], k=t["k"])
    buf = dis.token_dispatch(xt, t["flat_tok"], t["slot"], t["keep"],
                             t["E"] * t["cap"], layouts=lay)
    out = dis.token_combine(y2d, t["flat_tok"], t["slot"], t["keep"], w,
                            t["T"], layouts=lay)
    gx, gy, gw = torch.autograd.grad((buf, out), (xt, y2d, w),
                                     (t["dbuf"], t["dout"]))
    return {"dispatch": buf.detach(), "combine": out.detach(), "dxt": gx,
            "dy2d": gy, "dw": gw, "layouts": lay}


def _equal_nan(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _check_dscale(c, got, want_cpu):
    """dscale bit-equal to its order's plain version
    (``dscale_in_kernel_order``, vec instance only) and within DSCALE_REL
    x sum |a_i b_i| of .sum(-1) (the CPU run's), 0 where dropped."""
    by_slot, by_token = got["layouts"]
    a = c["y2d"][by_slot.ids.long()]
    b = c["dout"][by_token.ids.long()]
    keep = c["keep"]
    if dis.instance(c["dout"], dot_src=c["y2d"]) == "vec":
        assert torch.equal(got["dw"][keep],
                           dis.dscale_in_kernel_order(a, b)[keep])
    plain = want_cpu["dw"].to(a.device)
    scale = (a.float() * b.float()).abs().sum(-1)
    err = ((got["dw"] - plain).abs() / scale)[keep]
    assert (err <= DSCALE_REL).all(), err.max().item()
    assert (got["dw"][~keep] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,E,k,D,bias,long0", [
    (256, 8, 2, 512, 0.0, False),     # empty slots, short segments
    (512, 8, 2, 256, 3.0, True),      # slot 0 holds hundreds of drops
    (300, 16, 4, 2048, 4.0, True),    # the model's D and top-k
    (400, 6, 2, 3000, 3.0, True)])    # two passes (three for f32)
def test_dispatch_vec_equals_plain_bit_for_bit(cuda, dtype, T, E, k, D,
                                               bias, long0):
    """Each movement (values, dxt, dy2d) equal to the CPU plain version
    bit for bit in the vec instance, with empty rows and a long slot-0
    segment; dscale to its order and its limit; a second run the same."""
    c = _routing_case(cuda, T, E, k, D, dtype, bias)
    seg0 = int((torch.where(c["keep"], c["slot"], 0) == 0).sum())
    assert (seg0 > dis.LONG) == long0
    before = dict(dis.LAUNCHES_BY_INSTANCE)
    got = _movements(c, cuda)
    n = {i: v - before[i] for i, v in dis.LAUNCHES_BY_INSTANCE.items()}
    assert n == {"vec": 4, "general": 0}
    want = _movements(c, "cpu")
    for name in ("dispatch", "combine", "dxt", "dy2d"):
        assert torch.equal(got[name].cpu(), want[name]), name
    _check_dscale(c, got, want)
    again = _movements(c, cuda)
    for name in ("dispatch", "combine", "dxt", "dy2d", "dw"):
        assert torch.equal(got[name], again[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_backward_equals_the_f32_path(cuda, dtype):
    """dsrc from dout in its own dtype equals an f32 copy of dout summed
    and then cast, bit for bit (one rounding either way)."""
    c = _routing_case(cuda, 300, 16, 4, 2048, dtype, 4.0)
    got = _movements(c, cuda)
    by_slot, by_token = got["layouts"]
    wk = torch.where(c["keep"], c["w"], 0.0)
    f32 = dis.gather_scatter_add_rows(c["dbuf"].float(), by_slot.ids,
                                      by_token.ids, c["keep"].float(), 300)
    assert torch.equal(got["dxt"], f32.to(dtype))
    f32 = dis.gather_scatter_add_rows(c["dout"].float(), by_token.ids,
                                      by_slot.ids, wk, c["E"] * c["cap"])
    assert torch.equal(got["dy2d"], f32.to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("poison", ["inf", "nan", "-inf"])
def test_dispatch_nonfinite_dropped_row_reaches_slot_0(cuda, dtype, poison):
    """A dropped token row holding an inf or NaN makes its columns of
    slot 0 NaN, as the in-order walk (0 * inf) does, though the long
    segment's zero-scale rows are walked apart; other columns keep the
    sum.  The layout's scratch is left clean for the next launch."""
    c = _routing_case(cuda, 512, 8, 2, 512, dtype, 3.0)
    dst = torch.where(c["keep"], c["slot"], 0)
    assert int((dst == 0).sum()) > dis.LONG
    dropped = torch.nonzero(~c["keep"]).flatten()
    xt = c["xt"].clone()
    tok = c["flat_tok"][dropped[[3, -1]]]
    xt[tok[0], 5] = float(poison)
    xt[tok[1], 300:308] = float(poison)
    assert dis.instance(xt) == "vec"
    lay = dis.routing_layouts(c["flat_tok"], c["slot"], c["keep"],
                              c["E"] * c["cap"], 512, k=2)
    out = dis.token_dispatch(xt, c["flat_tok"], c["slot"], c["keep"],
                             c["E"] * c["cap"], layouts=lay)
    want = dis.gather_scatter_add_rows(xt.cpu(), c["flat_tok"].cpu(),
                                       dst.cpu(), c["keep"].float().cpu(),
                                       c["E"] * c["cap"])
    assert _equal_nan(out.cpu(), want)
    # (the poisoned tokens' kept assignments carry inf * w elsewhere)
    assert torch.isnan(out[0, 5]) and torch.isnan(out[0, 300:308]).all()
    assert torch.isfinite(out[0, :5]).all()
    out = dis.token_dispatch(c["xt"], c["flat_tok"], c["slot"], c["keep"],
                             c["E"] * c["cap"], layouts=lay)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("D,off,want_n", [
    (2100, None, {"vec": 0, "general": 4}),     # bf16 rows not 16-byte whole
    (256, "xt", {"vec": 3, "general": 1}),      # the dispatch's source
    (256, "y2d", {"vec": 2, "general": 2})])    # combine, its dot source
def test_dispatch_general_instance(cuda, D, off, want_n):
    """Rows that 16-byte access cannot take go to the general instance:
    bf16 D 2100, views one element off alignment; values and dsrc equal
    to the plain version bit for bit, dscale within its limit."""
    c = _routing_case(cuda, 200, 6, 2, D, torch.bfloat16, 3.0, off=off)
    assert dis.instance(c["xt"]) == ("general" if off != "y2d" else "vec")
    before = dict(dis.LAUNCHES_BY_INSTANCE)
    got = _movements(c, cuda)
    n = {i: v - before[i] for i, v in dis.LAUNCHES_BY_INSTANCE.items()}
    assert n == want_n
    want = _movements(c, "cpu")
    for name in ("dispatch", "combine", "dxt", "dy2d"):
        assert torch.equal(got[name].cpu(), want[name]), name
    _check_dscale(c, got, want)


def test_dispatch_layouts_are_shared_and_counted(cuda):
    """The shared layouts equal a stable argsort + searchsorted (by slot)
    and the identity with offsets k * t (by token), and the four
    movements launch once each."""
    c = _routing_case(cuda, 256, 8, 2, 256, torch.bfloat16, 0.0)
    by_slot, by_token = dis.routing_layouts(
        c["flat_tok"], c["slot"], c["keep"], c["E"] * c["cap"], 256, k=2)
    dst = torch.where(c["keep"], c["slot"], 0)
    order = torch.argsort(dst, stable=True)
    assert torch.equal(by_slot.order.long(), order)
    assert torch.equal(by_slot.seg.long(), torch.searchsorted(
        dst[order], torch.arange(by_slot.n + 1, device=cuda)))
    assert by_token.order is None and by_token.sorted_ids is None
    assert torch.equal(by_token.seg.long(),
                       torch.arange(257, device=cuda) * 2)
    n0 = dis.LAUNCHES
    _movements(c, cuda)
    assert dis.LAUNCHES == n0 + 4


def test_dispatch_vec_refuses_what_it_does_not_take(cuda):
    """The vec C entry refuses a row that is not whole 16-byte chunks and
    a misaligned base (``ops.instance`` never sends them there)."""
    _, vec, _ = dis._kernel()
    src = torch.ones(4, 16, dtype=torch.bfloat16, device=cuda)
    out = torch.zeros(2, 16, dtype=torch.bfloat16, device=cuda)
    rows = torch.zeros(3, dtype=torch.int32, device=cuda)
    scale = torch.ones(3, device=cuda)
    seg = torch.tensor([0, 3, 3], dtype=torch.int32, device=cuda)

    def call(ptr, D):
        return vec(ptr, 1, out.data_ptr(), rows.data_ptr(),
                   scale.data_ptr(), None, seg.data_ptr(), None, None, None,
                   0, None, None, 2, D, 3,
                   torch.cuda.current_stream().cuda_stream)
    assert call(src.data_ptr(), 12) != 0          # 12 % 8
    assert call(src.data_ptr() + 2, 8) != 0       # base off alignment
    assert call(src.data_ptr(), 8) == 0
    torch.cuda.synchronize()
    assert (out.view(-1)[:8] == 3).all() and (out.view(-1)[8:16] == 0).all()


# ---------------------------------------------------------------------------
# SSD chunked scan (Mamba-2 prefill)
# ---------------------------------------------------------------------------

def _ssd_inputs(cuda, B, S, H, P, N, G, dtype, with_h0, slow, seed=0):
    """The model's distributions: x, B, C ~ N(0, 1) (B/C x 0.3), dt =
    softplus(N(0,1)) and A = -1 (fast decay, as the reference's init), or
    dt * |A| <= 0.01 (slow decay: the carried state and far pairs reach
    y)."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda)
    x = rnd(B, S, H, P).to(dtype)
    if slow:
        dt = 0.02 + 0.08 * torch.rand(B, S, H, generator=g, device=cuda)
        A = -(0.02 + 0.08 * torch.rand(H, generator=g, device=cuda))
    else:
        dt = torch.nn.functional.softplus(rnd(B, S, H))
        A = -torch.ones(H, device=cuda)
    b, c = ((0.3 * rnd(B, S, G, N)).to(dtype) for _ in range(2))
    h0 = 0.5 * rnd(B, H, P, N) if with_h0 else None
    return x, dt, A, b, c, h0


@pytest.mark.parametrize("slow", [False, True], ids=["fast", "slow"])
@pytest.mark.parametrize("B,S,H,P,N,G,chunk,dtype,with_h0", [
    (1, 1024, 64, 64, 128, 1, 256, torch.bfloat16, False),   # the path
    (1, 777, 64, 64, 128, 1, 256, torch.bfloat16, False),    # ragged
    (2, 300, 8, 64, 128, 2, 256, torch.bfloat16, True),      # groups, h0
    (1, 200, 6, 80, 64, 3, 100, torch.bfloat16, True),       # tc, odd tiles
    (1, 200, 6, 80, 200, 3, 100, torch.bfloat16, True),      # general
    (1, 600, 4, 64, 128, 1, 256, torch.float32, True),
    (2, 45, 4, 16, 16, 2, 32, torch.float32, False),         # reduced
    (1, 200, 6, 80, 200, 3, 100, torch.float32, True),       # odd tiles
    (1, 37, 2, 8, 8, 1, 1000, torch.float32, False)])        # S < chunk
def test_ssd_kernel_matches_plain(cuda, B, S, H, P, N, G, chunk, dtype,
                                  with_h0, slow):
    """y and the final state against the plain version.  bf16 y within two
    bf16 ulps of the case's largest |y| and each element within two bf16
    ulps of itself + 1e-4 (both round once from f32; the tc instance
    carries W, h_in and B∘w as two bf16 terms, and one term breaks the
    per-element rule); f32 y and every final state within 5e-5 of the
    largest value (sums and the cumsum in another order).  A second
    launch gives the same bits."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    x, dt, A, b, c, h0 = _ssd_inputs(cuda, B, S, H, P, N, G, dtype,
                                     with_h0, slow)
    n0 = ssd.LAUNCHES
    y, h = ssd.ssd(x, dt, A, b, c, chunk=chunk, init_state=h0)
    assert ssd.LAUNCHES == n0 + 1
    y2, h2 = ssd.ssd(x, dt, A, b, c, chunk=chunk, init_state=h0)
    wy, wh = ssd_scan_ref(x, dt, A, b, c, chunk=chunk, init_state=h0)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert y.dtype == dtype and h.dtype == torch.float32
    m = wy.float().abs().max()
    if dtype == torch.bfloat16:
        _, e = torch.frexp(m)
        limit = 2 * torch.ldexp(torch.tensor(2.0 ** -7, device=cuda), e - 1)
        assert bf16_err_over_limit(y, wy) <= 1.0
    else:
        limit = 5e-5 * m
    assert (y.float() - wy.float()).abs().max() <= limit
    assert (h - wh).abs().max() <= 5e-5 * wh.abs().max()


def _conv_views(cuda, B, S, H, P, N, G, dtype, pad=0):
    """x, B, C as the model passes them: views of one (B, S, H*P + 2*G*N +
    pad) conv output."""
    g = torch.Generator(device=cuda).manual_seed(S)
    conv = torch.randn(B, S, H * P + 2 * G * N + pad, generator=g,
                       device=cuda)
    conv[..., H * P:] *= 0.3
    conv = conv.to(dtype)
    return (conv[..., :H * P].reshape(B, S, H, P),
            conv[..., H * P:H * P + G * N].reshape(B, S, G, N),
            conv[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N))


@pytest.mark.parametrize("P,N,dtype,pad,inst", [
    (64, 128, torch.bfloat16, 0, "tc"),       # the ssm prefill's views
    (64, 128, torch.bfloat16, 1, "general"),  # row stride 4353: odd
    (24, 128, torch.bfloat16, 0, "general"),  # P not a multiple of 16
    (64, 40, torch.bfloat16, 0, "general"),   # N not a multiple of 16
    (64, 128, torch.float32, 0, "f32")])
def test_ssd_takes_the_instance_its_inputs_allow(cuda, P, N, dtype, pad,
                                                 inst):
    """``ops.instance`` routes by dtype, shape, strides and bases; the
    launch counts in that instance alone and holds the plain version's
    result."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    B, S, H, G = 1, 300, 8, 1
    x, b, c = _conv_views(cuda, B, S, H, P, N, G, dtype, pad)
    _, dt, A, _, _, h0 = _ssd_inputs(cuda, B, S, H, P, N, G, dtype, True,
                                     True)
    assert ssd.instance(x, b, c) == inst
    before = dict(ssd.LAUNCHES_BY_INSTANCE)
    y, h = ssd.ssd(x, dt, A, b, c, chunk=128, init_state=h0)
    assert {k: v - before[k] for k, v in ssd.LAUNCHES_BY_INSTANCE.items()} \
        == {k: int(k == inst) for k in before}
    wy, wh = ssd_scan_ref(x, dt, A, b, c, chunk=128, init_state=h0)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert bf16_err_over_limit(y, wy) <= 1.0
    else:
        assert (y - wy).abs().max() <= 5e-5 * wy.abs().max()
    assert (h - wh).abs().max() <= 5e-5 * wh.abs().max()


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ops as ssd
    x, dt, A, b, c, _ = _ssd_inputs(cuda, 1, 40, 2, 8, 8, 1, torch.float32,
                                    False, False)
    with pytest.raises(ValueError, match="unit stride"):
        ssd.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, b, c)
    with pytest.raises(NotImplementedError, match="no backward"):
        ssd.ssd(x.requires_grad_(True), dt, A, b, c)


def test_reduced_mamba2_on_card_matches_cpu(cuda):
    """Reduced Mamba2 (f32) served through the SSD kernel on the card
    emits the CPU engine's greedy tokens."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    cfg = get_config("mamba2-1.3b", variant="reduced")
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, P)) for P in (2, 33, 70)]
    outs = {}
    n0 = ssd.LAUNCHES
    for dev in ("cpu", "cuda"):
        eng = PagedServeEngine(_to(params, dev), cfg, n_slots=2, max_len=80,
                               seg_len=4, device=dev)
        for pr in prompts:
            eng.submit({"tokens": pr}, max_new=8)
        outs[dev] = {u: c.tokens.tolist() for u, c in eng.run().items()}
    assert ssd.LAUNCHES - n0 == cfg.n_layers * len(prompts)
    assert outs["cuda"] == outs["cpu"]
