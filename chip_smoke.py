#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (non-zero exit, no result line) on failure:

1. card: name and power limit (nvidia-smi), device name (torch);
2. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu``, in
   parallel, into ``build/repro_torch/`` (cached by source hash);
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serve, train and tune paths' shapes plus small edge
   cases (MoE: a drop case, transposed operands, gelu, ragged edges),
   each output element within two bf16 ulps of its own value + 1e-4
   (1e-4 for f32 outputs), kd_loss's argmax-correct exactly except on
   rows whose top two logits are within ``ARGMAX_MARGIN``; kernel, plain
   and library-call times (``scaled_dot_product_attention``, matmul +
   ``cross_entropy``, ``torch.bmm``, ``index_add_``: yardsticks the
   port never calls) from CUDA events
   with L2 flushed before each call, and the least time the card could
   take (bytes over 3.35 TB/s, flops over the type's peak);
4. serve: full-width TinyLlama-1.1B (bf16, random weights from seed 0)
   behind ``PagedServeEngine``: 16 greedy requests, prompts of 128-1024
   tokens, 64 new tokens each.  Checks the completions, the allocator,
   the kernels' launch counts on that run, and the kernel path's logits
   against the plain path's;
5. profile: torch.profiler over one prefill and one decode segment;
6. train: ``train_device`` on full-width TinyLlama-1.1B (bf16, random
   weights from seed 0), 8 steps of 4 x 1024 tokens at lr 1e-3.  Checks
   finite, falling losses and the kernels' launch counts on that run,
   the kernel path's loss and gradients against the plain path's, and
   reports ms per step, tokens/s, MFU, peak memory and a profile;
7. tune: Phase III on Qwen1.5-MoE-A2.7B at full width, 12 of its 24
   layers (bf16, random weights): K = 4 random base models merged by
   ``merge_into_moe`` on the card (the merge rule checked exactly), then
   ``DeepFusionServer.merge_and_tune`` for 6 steps of 4 x 1024 tokens
   with frozen experts at lr 5e-4.  Checks finite losses, frozen experts
   bit-identical and every trainable leaf changed, the MoE kernels'
   launch counts, the kernel path's loss and gradients against its plain
   version in bf16 and in f32 (the dropless plain path reported), and
   reports ms per step, tokens/s, MFU, peak memory, dropped assignments
   per step and a profile.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without either when
there is no CUDA device or the port is not beside this script.
f32 matrix products run in full f32 (TF32 off) throughout.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
L2_FLUSH_BYTES = 256 << 20        # 5x the H100's 50 MB L2
# kernel path vs plain path, final f32 logits of full-width TinyLlama in
# bf16 (logits ~N(0,1)): 22 layers of bf16 activations rounded at
# different points, so allow 0.1 absolute.
LOGIT_TOL = 0.1


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


F32_TOL = 1e-4   # f32 sums in another order over at most ~1k terms


def check_close(case: str, out: torch.Tensor, want: torch.Tensor) -> dict:
    """Holds a kernel's output to its plain version's, element by element.
    Both accumulate in f32 and round once to the output dtype, so in bf16
    an element differs by about one bf16 ulp of its own value, plus the
    f32 sum-order difference: the limit is two ulps of |want| + F32_TOL.
    A small output (a long row's average) gets a small limit.  f32
    outputs: F32_TOL.  Returns the largest error and its share of the
    limit."""
    out, ref = out.float(), want.float()
    err = (out - ref).abs()
    limit = torch.full_like(ref, F32_TOL)
    if want.dtype != torch.float32:
        _, e = torch.frexp(ref)     # |ref| in [2**(e-1), 2**e)
        ulp = torch.ldexp(torch.full_like(ref, torch.finfo(want.dtype).eps),
                          e - 1)
        limit += 2 * ulp
    worst = (err / limit).max().item()
    row = {"case": case, "max_abs_err": err.max().item(),
           "err_over_limit": worst,
           "max_abs_want": ref.abs().max().item()}
    if not torch.isfinite(out).all() or not worst <= 1.0:
        fail(f"{case}: error {worst:.3g}x its limit "
             f"(max abs err {row['max_abs_err']})")
    return row


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` with its inputs out of L2, as
    on the serve path, where other layers' weights and pools pass
    through L2 between two launches of a kernel.  A 256 MB write evicts
    L2 before each call, and each call is timed by its own events.  A
    device-side sleep first lets the host queue every call before the
    device starts, so host gaps between launches are not timed."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of device clock cycles
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def bound_ms(nbytes: float, flops: float, dtype):
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ---------------------------------------------------------------------------
# phase 1-2: card and build
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    name = torch.cuda.get_device_name(0)
    print(f"card: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    return name


def phase_build():
    from repro_torch.kernels import _build
    _build.build_all()
    info = _build.BUILD_INFO
    print(f"build: {info['seconds']:.1f}s, "
          f"{'cached' if info['cached'] else 'built ' + ','.join(info['built'])}"
          f" -> {_build.build_dir()}")
    for stem, report in sorted(info["ptxas"].items()):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def flash_case(gen, B, S, H, KH, D, dtype, *, window=0, softcap=0.0,
               timed=False):
    from repro_torch.kernels.flash_attention import ops, ref
    q = _randn(gen, (B, S, H, D), dtype)
    k = _randn(gen, (B, S, KH, D), dtype)
    v = _randn(gen, (B, S, KH, D), dtype)
    kw = dict(causal=True, window=window, softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    row = check_close(f"flash B={B} S={S} H={H} KH={KH} D={D} "
                      f"{str(dtype)[6:]} causal window={window} "
                      f"softcap={softcap}", out, want)
    if timed:
        # visible (q, k) pairs of causal attention, 4*D flops each
        pairs = S * (S + 1) / 2 if not window else sum(
            min(i + 1, window) for i in range(S))
        flops = 4 * D * pairs * B * H
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row.update(
            ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
            library_ms=(time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
                if not (window or softcap) else None))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
    return row


def paged_case(gen, ctx, C, H, KH, D, bl, dtype, *, window=0, softcap=0.0,
               timed=False):
    """len(ctx) slots; slot b holds ctx[b] cached positions (its queries
    are the last C of them).  Blocks are scattered over the pool in a
    random order; table entries past a slot's blocks point at block 0."""
    from repro_torch.kernels.paged_attn import ops, ref
    from repro_torch.models.layers import paged_gather
    B = len(ctx)
    nbt = -(-max(ctx) // bl)
    need = [-(-c // bl) for c in ctx]
    n_blocks = 1 + sum(need)
    perm = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    bt = torch.zeros((B, nbt), dtype=torch.int32, device="cuda")
    o = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[o:o + n].to(torch.int32)
        o += n
    pos = torch.tensor([c - C for c in ctx], dtype=torch.int32,
                       device="cuda")
    q = _randn(gen, (B, C, H, D), dtype)
    kp = _randn(gen, (n_blocks, bl, KH, D), dtype)
    vp = _randn(gen, (n_blocks, bl, KH, D), dtype)
    kw = dict(window=window, softcap=softcap)
    out = ops.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    want = ref.paged_attention_ref(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    row = check_close(f"paged slots={B} ctx={min(ctx)}-{max(ctx)} C={C} "
                      f"H={H} KH={KH} D={D} bl={bl} {str(dtype)[6:]} "
                      f"window={window} softcap={softcap}", out, want)
    if timed:
        # every visible K/V row read once, q read and out written once
        rows = sum(ctx)
        nbytes = (2 * rows * KH * D + 2 * q.numel()) * q.element_size() \
            + bt.numel() * 4 + pos.numel() * 4
        flops = 4 * D * H * sum(c - C + 1 + (C - 1) / 2 for c in ctx) * C
        # the library yardstick attends a pre-gathered dense cache (the
        # gather is not timed): (B, H, S, D) with a length mask
        S = nbt * bl
        kg = paged_gather(kp, bt).transpose(1, 2).contiguous()
        vg = paged_gather(vp, bt).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        kpos = torch.arange(S, device="cuda")[None, None, None, :]
        qpos = (pos.long()[:, None, None, None]
                + torch.arange(C, device="cuda")[None, None, :, None])
        mask = kpos <= qpos
        row.update(
            ms=time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, pos,
                                                          **kw)),
            plain_ms=time_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, bt, pos, **kw)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kg, vg, attn_mask=mask, enable_gqa=True)))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
    return row


def _near_tie_rows(hs, ws, cap, margin):
    """Rows whose top two (softcapped) logits differ by less than
    ``margin``: the argmax there may follow the summation order."""
    z = hs.float() @ ws.float()
    if cap:
        z = torch.tanh(z / cap) * cap
    top = z.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) < margin


# logits of the kd_loss cases are ~N(0,1) sums of up to 2048 f32
# products: two summation orders differ by ~1e-6, so rows whose top two
# logits are within 1e-5 may take either index
ARGMAX_MARGIN = 1e-5


def kd_case(gen, T, Ds, Dt, V, dtype, *, tau=1.0, cap_s=0.0, cap_t=0.0,
            timed=False, ties=False):
    """The kd_loss kernel against its plain version.  Hidden states
    ~N(0,1) and heads ~N(0,1/D), as the model draws them.  ``ties``
    plants, in integer-valued inputs (exact in any order), a maximum at
    two columns of every row; the lower index must win."""
    from repro_torch.kernels.kd_loss import ops, ref
    hs = _randn(gen, (T, Ds), dtype)
    ws = (torch.randn((Ds, V), generator=gen, device="cuda")
          / Ds ** 0.5).to(dtype)
    lab = torch.randint(0, V, (T,), generator=gen, device="cuda",
                        dtype=torch.int32)
    ht = wt = None
    if Dt:
        ht = _randn(gen, (T, Dt), dtype)
        wt = (torch.randn((Dt, V), generator=gen, device="cuda")
              / Dt ** 0.5).to(dtype)
    if ties:
        rows = torch.arange(T, device="cuda")
        hs = torch.eye(T, Ds, device="cuda").to(dtype)
        ws = torch.randint(-3, 4, (Ds, V), generator=gen, device="cuda")
        lo, hi = rows * 17 % (V // 2), V // 2 + rows * 29 % (V // 2)
        ws[rows, lo] = ws[rows, hi] = 9
        ws = ws.to(dtype)
        lab = torch.where(rows % 2 == 0, lo, hi).to(torch.int32)
    kw = dict(tau=tau, softcap_s=cap_s, softcap_t=cap_t)
    ce, kl, cor = ops.kd_loss_fwd(hs, ws, ht, wt, lab, **kw)
    if Dt:
        w_ce, w_kl, w_cor = ref.ce_kl_ref(hs, ws, ht, wt, lab, **kw)
    else:
        (w_ce, w_cor), w_kl = ref.ce_ref(hs, ws, lab, softcap=cap_s), None
    torch.cuda.synchronize()
    name = (f"kd_loss T={T} Ds={Ds} Dt={Dt} V={V} {str(dtype)[6:]} "
            f"tau={tau} softcap={cap_s}/{cap_t}{' ties' if ties else ''}")
    row = check_close(name + " ce", ce, w_ce)
    if Dt:
        kl_row = check_close(name + " kl", kl, w_kl)
        row["max_abs_err"] = max(row["max_abs_err"], kl_row["max_abs_err"])
        row["err_over_limit"] = max(row["err_over_limit"],
                                    kl_row["err_over_limit"])
    elif not (kl == 0).all():
        fail(f"{name}: kl is not 0 without a teacher")
    near = _near_tie_rows(hs, ws, cap_s, ARGMAX_MARGIN)
    wrong = (cor != w_cor) & ~near
    if ties and not (torch.equal(cor, w_cor) and torch.equal(
            cor, (torch.arange(T, device="cuda") % 2 == 0).float())):
        fail(f"{name}: a planted tie did not go to the lower index")
    if wrong.any():
        fail(f"{name}: correct differs on {int(wrong.sum())} rows whose top "
             f"two logits differ by {ARGMAX_MARGIN} or more")
    row.update(near_tie_rows=int(near.sum()),
               correct_differs_on_near_ties=int(((cor != w_cor) & near).sum()))
    if timed:
        lab64 = lab.long()
        if Dt:
            def library():
                zs = torch.matmul(hs, ws).float()
                zt = torch.matmul(ht, wt).float()
                c = F.cross_entropy(zs, lab64, reduction="none")
                k = F.kl_div(F.log_softmax(zs / tau, -1),
                             F.log_softmax(zt / tau, -1), log_target=True,
                             reduction="none").sum(-1) * tau ** 2
                return c, k

            def plain():
                return ref.ce_kl_ref(hs, ws, ht, wt, lab, **kw)
        else:
            def library():
                return F.cross_entropy(torch.matmul(hs, ws).float(), lab64,
                                       reduction="none")

            def plain():
                return ref.ce_ref(hs, ws, lab, softcap=cap_s)
        d_all = Ds + (Dt or 0)
        flops = 2 * T * d_all * V
        nbytes = (T * d_all + d_all * V) * hs.element_size() + 4 * T * 4
        row.update(ms=time_ms(lambda: ops.kd_loss_fwd(hs, ws, ht, wt, lab,
                                                      **kw)),
                   plain_ms=time_ms(plain), library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
    return row


# the expert layer on the tune path: batch 4 x 1024 tokens of
# Qwen1.5-MoE-A2.7B, top-4 of 60 experts, moe_d_ff 1408, and the
# reference's capacity max(ceil(T*k/E)*2, 8) = 548 slots per expert
MOE_T, MOE_K, MOE_E, MOE_D, MOE_F = 4096, 4, 60, 2048, 1408
MOE_CAP = max(-(-MOE_T * MOE_K // MOE_E) * 2, 8)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def gmm_case(gen, E, M, K, N, *, ta=False, tb=False, da=torch.float32,
             db=torch.float32, dc=torch.float32, timed=False):
    """The grouped-matmul kernel against its plain version (bmm of f32
    casts).  A ~N(0,1), B ~N(0,1/K), so outputs are O(1).  ``ta``/``tb``
    hand the kernel transposed views, as the backward does."""
    from repro_torch.kernels.moe_gemm import ops, ref
    a = torch.randn((E, K, M) if ta else (E, M, K), generator=gen,
                    device="cuda").to(da)
    b = (torch.randn((E, N, K) if tb else (E, K, N), generator=gen,
                     device="cuda") / K ** 0.5).to(db)
    a = a.transpose(1, 2) if ta else a
    b = b.transpose(1, 2) if tb else b
    out = ops.grouped_matmul(a, b, out_dtype=dc)
    want = ref.grouped_matmul_ref(a, b, dc)
    torch.cuda.synchronize()
    row = check_close(f"grouped_matmul E={E} M={M} K={K} N={N} "
                      f"a={str(da)[6:]}{'^T' if ta else ''} "
                      f"b={str(db)[6:]}{'^T' if tb else ''} "
                      f"out={str(dc)[6:]}", out, want)
    if timed:
        af, bf_ = a.float().contiguous(), b.float().contiguous()
        row.update(ms=time_ms(lambda: ops.grouped_matmul(a, b, out_dtype=dc)),
                   plain_ms=time_ms(lambda: ref.grouped_matmul_ref(a, b, dc)),
                   library_ms=time_ms(lambda: torch.bmm(af, bf_)))
        # bf16 x bf16 products are exact in f32, so the card's rate for
        # them is the bf16 tensor-core rate; an f32 operand takes the f32
        # rate (TF32 would round it)
        peak = torch.bfloat16 if da == db == torch.bfloat16 else torch.float32
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(a, b, out), 2 * E * M * N * K, peak)
    return row


def ffn_case(gen, E, C, D, Fh, dtype, *, act="silu", timed=False):
    """The grouped-FFN kernel (both stages) against its plain version."""
    from repro_torch.kernels.moe_gemm import ops, ref
    x = _randn(gen, (E, C, D), dtype)
    wg, wu = ((torch.randn((E, D, Fh), generator=gen, device="cuda")
               / D ** 0.5).to(dtype) for _ in range(2))
    wo = (torch.randn((E, Fh, D), generator=gen, device="cuda")
          / Fh ** 0.5).to(dtype)
    out = ops.grouped_ffn_fwd(x, wg, wu, wo, act=act)
    want = ref.grouped_ffn_ref(x, wg, wu, wo, act=act)
    torch.cuda.synchronize()
    row = check_close(f"grouped_ffn E={E} C={C} D={D} F={Fh} "
                      f"{str(dtype)[6:]} {act}", out, want)
    if timed:
        actf = F.silu if act == "silu" else (
            lambda t: F.gelu(t, approximate="tanh"))

        def library():  # a torch.bmm chain in the working dtype
            return torch.bmm(actf(torch.bmm(x, wg)) * torch.bmm(x, wu), wo)

        row.update(ms=time_ms(lambda: ops.grouped_ffn_fwd(x, wg, wu, wo,
                                                          act=act)),
                   plain_ms=time_ms(lambda: ref.grouped_ffn_ref(
                       x, wg, wu, wo, act=act)),
                   library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(x, wg, wu, wo, out), 6 * E * C * D * Fh, dtype)
    return row


def gsa_case(gen, direction, T, E, k, D, dtype, *, bias=0.0, timed=False):
    """The gather/scatter-add kernel as dispatch (tokens -> capacity
    slots) or combine (slots -> tokens) of softmax-top-k routing from
    random logits, ``bias`` added to expert 0 (a drop case).  Held to the
    plain version on the card (``index_add_``, atomics) by the bf16 rule,
    and bit for bit to the plain version on the CPU, which adds rows in
    order as the kernel does."""
    from repro_torch.kernels.moe_dispatch import ops, ref
    logits = torch.randn((T, E), generator=gen, device="cuda")
    logits[:, 0] += bias
    w, idx = torch.softmax(logits, -1).topk(k, -1)
    w = w / w.sum(-1, keepdim=True)
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device="cuda") // k
    pos, keep = ops.capacity_positions(flat_e, cap)
    slot = torch.where(keep, flat_e * cap + pos, 0)
    if direction == "dispatch":
        src = _randn(gen, (T, D), dtype)
        src_rows, dst, scale, n_out = flat_tok, slot, keep.float(), E * cap
    else:
        src = _randn(gen, (E * cap, D), dtype)
        src_rows, dst, n_out = slot, flat_tok, T
        scale = torch.where(keep, w.reshape(-1), 0.0)
    out = ops.gather_scatter_add_rows(src, src_rows, dst, scale, n_out)
    want = ref.gather_scatter_add_ref(src, src_rows, dst, scale, n_out)
    torch.cuda.synchronize()
    name = (f"gather_scatter_add {direction} T={T} E={E} k={k} cap={cap} "
            f"D={D} {str(dtype)[6:]} bias={bias}")
    row = check_close(name, out, want)
    cpu = ref.gather_scatter_add_ref(src.cpu(), src_rows.cpu(), dst.cpu(),
                                     scale.cpu(), n_out)
    if not torch.equal(out.cpu(), cpu):
        fail(f"{name}: differs from the in-order sum of the plain version "
             f"on the CPU")
    row.update(dropped=int((~keep).sum()), rows=int(src_rows.numel()),
               equal_to_cpu_in_order=True)
    if bias and not row["dropped"]:
        fail(f"{name}: the drop case dropped nothing")
    if timed:
        # each referenced source row read once, every output row written
        # once, the (row, scale, destination) triples read once
        used = int(torch.unique(src_rows).numel())
        nbytes = ((used + n_out) * D * src.element_size()
                  + 12 * src_rows.numel())

        def library():  # index_add_, with its gather and scale
            return torch.zeros((n_out, D), dtype=dtype, device="cuda"
                               ).index_add_(0, dst, src[src_rows]
                                            * scale[:, None].to(dtype))

        row.update(ms=time_ms(lambda: ops.gather_scatter_add_rows(
                       src, src_rows, dst, scale, n_out)),
                   plain_ms=time_ms(lambda: ref.gather_scatter_add_ref(
                       src, src_rows, dst, scale, n_out)),
                   library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 0, dtype)
    return row


def moe_cases(gen):
    """Kernels 4-6 at the tune path's shapes (timed), and edge cases."""
    bf, f32 = torch.bfloat16, torch.float32
    E, C, D, Fh = MOE_E, MOE_CAP, MOE_D, MOE_F
    ffn = [ffn_case(gen, E, C, D, Fh, bf, timed=True),
           ffn_case(gen, 3, 70, 96, 200, bf, act="gelu"),
           ffn_case(gen, 2, 130, 100, 136, bf),
           ffn_case(gen, 3, 33, 64, 72, f32, act="gelu")]
    # the backward's products at the path's shapes: g = x @ wg, then
    # dwg = x^T @ dg and dh = dy @ wo^T through transposed views
    gmm = [gmm_case(gen, E, C, D, Fh, da=bf, db=bf, timed=True),
           gmm_case(gen, E, D, C, Fh, ta=True, da=bf, db=f32, timed=True),
           gmm_case(gen, E, C, D, Fh, tb=True, da=bf, db=bf),
           gmm_case(gen, 3, 130, 37, 70, ta=True, tb=True, da=f32, db=bf,
                    dc=bf)]
    gsa = [gsa_case(gen, "dispatch", MOE_T, E, MOE_K, D, bf, timed=True),
           gsa_case(gen, "combine", MOE_T, E, MOE_K, D, bf, timed=True),
           gsa_case(gen, "dispatch", MOE_T, E, MOE_K, D, bf, bias=4.0),
           gsa_case(gen, "combine", 300, 8, 2, 2100, f32, bias=3.0)]
    return ffn, gmm, gsa


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    flash = [flash_case(gen, 1, 1024, 32, 4, 64, bf, timed=True),
             flash_case(gen, 1, 128, 32, 4, 64, bf, timed=True),
             flash_case(gen, 2, 300, 8, 2, 64, bf, window=100),
             flash_case(gen, 1, 200, 4, 4, 64, bf, softcap=30.0),
             flash_case(gen, 2, 77, 4, 2, 32, f32, window=20, softcap=50.0),
             flash_case(gen, 1, 130, 4, 1, 128, f32)]
    ctx = [int(c) for c in np.linspace(64, 1088, 8)]
    paged = [paged_case(gen, ctx, 1, 32, 4, 64, 16, bf, timed=True),
             paged_case(gen, ctx, 4, 32, 4, 64, 16, bf, timed=True),
             paged_case(gen, [5, 40, 17], 3, 8, 2, 32, 4, f32, window=12,
                        softcap=30.0),
             paged_case(gen, [1, 200], 1, 4, 4, 128, 16, f32)]
    kd = [kd_case(gen, 2048, 2048, 0, 32000, bf, timed=True),
          kd_case(gen, 2048, 2048, 1024, 32000, bf, tau=2.0, timed=True),
          kd_case(gen, 130, 96, 0, 1000, f32),
          kd_case(gen, 77, 64, 48, 333, f32, tau=2.0, cap_s=30.0,
                  cap_t=50.0),
          kd_case(gen, 200, 40, 0, 777, bf, cap_s=15.0),
          kd_case(gen, 64, 136, 72, 129, bf, tau=0.5, cap_t=20.0),
          kd_case(gen, 96, 96, 0, 5000, bf, ties=True),
          kd_case(gen, 96, 96, 0, 5000, f32, ties=True)]
    ffn, gmm, gsa = moe_cases(gen)
    for row in flash + paged + kd + ffn + gmm + gsa:
        print("kernel " + json.dumps(row))
    return {"flash_attention": flash[0], "paged_attn": paged[0],
            "kd_loss": kd[0], "grouped_ffn": ffn[0],
            "grouped_matmul": gmm[0], "gather_scatter_add": gsa[0]}


# ---------------------------------------------------------------------------
# phase 4: serve full-width TinyLlama-1.1B
# ---------------------------------------------------------------------------

def check_logits(params, cfg, M, prompt):
    """Prefill last-token logits and one paged decode step's logits,
    kernel path against plain path on the same weights and cache."""
    plain = cfg.replace(use_kernels=False)
    toks = torch.as_tensor(prompt, device="cuda")
    lk, pc = M.prefill(params, cfg, {"tokens": toks})
    lp, _ = M.prefill(params, plain, {"tokens": toks})
    err_prefill = (lk - lp).abs().max().item()

    bl, P = 16, prompt.shape[1]
    n_pb = -(-P // bl)
    n_blocks = n_pb + 2
    cache = M.init_paged_cache(cfg, n_blocks, bl, device="cuda")
    sub = M.prefill_into_cache(
        cfg, M.init_decode_cache(cfg, 1, n_pb * bl, device="cuda"), pc)
    ids = list(range(1, n_pb + 1))
    M.scatter_prefill_paged(cfg, cache, sub, ids, [True] * n_pb,
                            block_len=bl)
    bt = torch.tensor([ids + [n_pb + 1]], dtype=torch.int32, device="cuda")
    tok = lk.argmax(-1).to(torch.int32)[:, None]
    pos = torch.tensor([P], dtype=torch.int32, device="cuda")
    cache2 = {"blocks": {s: {k: v.clone() for k, v in e.items()}
                         for s, e in cache["blocks"].items()}}
    dk, _ = M.decode_step(params, cfg, cache, tok, pos, block_tables=bt)
    dp, _ = M.decode_step(params, plain, cache2, tok, pos, block_tables=bt)
    err_decode = (dk - dp).abs().max().item()
    scale = lp.abs().max().item()
    print(f"logits kernel vs plain: prefill max|d|={err_prefill:.4g} "
          f"decode max|d|={err_decode:.4g} (max|logit|={scale:.3g}, "
          f"tol {LOGIT_TOL})")
    if not (math.isfinite(err_prefill) and math.isfinite(err_decode)):
        fail("non-finite logits")
    if err_prefill > LOGIT_TOL or err_decode > LOGIT_TOL:
        fail(f"kernel-path logits differ from plain path by "
             f"{max(err_prefill, err_decode)} > {LOGIT_TOL}")
    return err_prefill, err_decode


def phase_serve():
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine

    cfg = get_config("tinyllama-1.1b", variant="full")
    if not cfg.use_kernels:
        fail("config does not route attention through the kernels")
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in convert.flatten(params).values())
    print(f"serve: {cfg.name} {n_params / 1e9:.3f}B params {cfg.dtype}, "
          f"init {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    lens = [int(p) for p in np.linspace(128, 1024, 16)]
    prompts = [rng.integers(0, cfg.vocab_size, (1, p)).astype(np.int32)
               for p in lens]
    max_new, n_slots, bl, seg_len = 64, 8, 16, 8

    with torch.no_grad():
        errs = check_logits(params, cfg, M, prompts[-1])

        def make_engine():
            eng = PagedServeEngine(params, cfg, n_slots=n_slots,
                                   block_len=bl, seg_len=seg_len,
                                   max_len=max(lens) + max_new,
                                   device="cuda")
            for p in prompts:
                eng.submit({"tokens": p}, max_new=max_new)
            return eng

        # warm-up run (allocator, cuBLAS handles, kernel first launches)
        make_engine().run()
        eng = make_engine()
        torch.cuda.synchronize()
        fa_ops.LAUNCHES = 0
        pa_ops.LAUNCHES = 0
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa_ops.LAUNCHES,
                    "paged_attn": pa_ops.LAUNCHES}

    st = eng.stats
    if sorted(comps) != list(range(len(prompts))):
        fail(f"completed {sorted(comps)}")
    for uid, c in comps.items():
        if len(c.tokens) != max_new or c.prompt_len != lens[uid]:
            fail(f"request {uid}: {len(c.tokens)} tokens, prompt "
                 f"{c.prompt_len}")
        if (c.tokens < 0).any() or (c.tokens >= cfg.vocab_size).any():
            fail(f"request {uid}: token ids out of range")
    if eng.alloc.n_free != eng.n_blocks - 1 or eng._slot_blocks:
        fail(f"allocator did not drain: {eng.alloc.n_free} free of "
             f"{eng.n_blocks - 1}")
    steps = st["segments"] * seg_len
    want = {"flash_attention": cfg.n_layers * st["prefills"],
            "paged_attn": cfg.n_layers * steps}
    if launches != want or min(launches.values()) <= 0:
        fail(f"launches {launches} != expected {want}")
    ttft = sorted(c.ttft_s for c in comps.values())
    res = {"requests": len(comps), "generated_tokens": st["generated_tokens"],
           "wall_s": wall, "tok_per_s": st["generated_tokens"] / wall,
           "decode_steps": steps,
           "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
           "admit_s": st["admit_s"], "decode_s": st["decode_s"],
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "ttft_min_s": ttft[0], "prefills": st["prefills"],
           "preemptions": st["preemptions"],
           "peak_live_blocks": st["peak_live_blocks"],
           "launches": launches, "logit_err_prefill": errs[0],
           "logit_err_decode": errs[1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("serve " + json.dumps(res))
    phase_profile(params, cfg, prompts[-1], make_engine)
    return launches


def profile(fn, top: int = 8, groups=None):
    """One call of ``fn`` under torch.profiler: host wall time, summed
    device kernel time (one stream, so kernels do not overlap), the
    device's idle share of the wall, and the kernels that took most.
    ``groups`` maps a name to kernel-name fragments; each group's summed
    device time is reported under ``group_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's self device time repeats
        # the time of the kernels it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        rows.append((dev_us, evt.key, evt.count))
    if not rows:
        fail("the profiler recorded no device events")
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    group_ms = {g: sum(us for us, k, _ in rows if any(f in k for f in frags))
                / 1e3 for g, frags in (groups or {}).items()}
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "group_ms": group_ms,
            "device_idle_share": 1 - device_ms / (wall * 1e3),
            "device_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "count": n,
                    "ms_per_launch": us / 1e3 / n}
                    for us, k, n in rows[:top]]}


def phase_profile(params, cfg, prompt, make_engine):
    """Where the time goes: one prefill of the longest prompt, and one
    steady decode segment with every slot live."""
    from repro_torch.models import model as M
    toks = torch.as_tensor(prompt, device="cuda")
    with torch.no_grad():
        pre = profile(lambda: M.prefill(params, cfg, {"tokens": toks}))
        eng = make_engine()
        eng.step()        # admits the first 8 requests, runs a segment
        seg = profile(eng.step)  # no slot free: a decode segment only
    print("profile " + json.dumps({"prefill_1024": pre,
                                   "decode_segment_8_steps": seg}))


# ---------------------------------------------------------------------------
# phase 6: train full-width TinyLlama-1.1B
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 1024, 1e-3
# kernel path vs plain path on one batch at full width, bf16.  The plain
# path rounds its logits to bf16 (the head GEMM's output) where the
# kernel keeps them in f32, and the two backwards round bf16 activations
# at different points through 22 layers.  Reading on an H100 (700 W):
# loss |d| = 6.6e-5; relative L2 error of the gradients 0.0125
# (lm_head), 0.0073 (final_norm), 0.0169 (layer 11's wq).  Limits: the
# loss to LOSS_TOL absolute, each gradient to GRAD_TOL, about 3x the
# worst reading (||g_kernel - g_plain|| / ||g_plain||).
LOSS_TOL = 2e-4
GRAD_TOL = 0.05
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]


def _grad_check(M, cfg, params, batch):
    """Loss and the gradients of ``lm_head``, ``final_norm`` and layer
    11's ``wq``, kernel path against plain path, same weights, same
    batch."""
    layer = 11
    leaves = {"lm_head": params["lm_head"],
              "final_norm": params["final_norm"]["scale"],
              "wq": params["blocks"]["sub0"]["attn"]["wq"]}
    out = {}
    for use_kernels in (True, False):
        for t in leaves.values():
            t.requires_grad_(True)
        loss, _ = M.loss_fn(params, cfg.replace(use_kernels=use_kernels),
                            batch)
        gs = torch.autograd.grad(loss, list(leaves.values()))
        out[use_kernels] = (loss.item(), {
            k: (g[layer] if k == "wq" else g).float()
            for k, g in zip(leaves, gs)})
        del gs
    (lk, gk), (lp, gp) = out[True], out[False]
    res = {"loss_kernel": lk, "loss_plain": lp, "loss_abs_err": abs(lk - lp)}
    for k in leaves:
        res[f"{k}_rel_err"] = ((gk[k] - gp[k]).norm() / gp[k].norm()).item()
        res[f"{k}_max_abs_err"] = (gk[k] - gp[k]).abs().max().item()
    print("train kernel vs plain " + json.dumps(res))
    if not math.isfinite(res["loss_abs_err"]) or \
            res["loss_abs_err"] > LOSS_TOL:
        fail(f"kernel-path loss differs from plain path by "
             f"{res['loss_abs_err']} > {LOSS_TOL}")
    for k in leaves:
        if not res[f"{k}_rel_err"] <= GRAD_TOL:
            fail(f"kernel-path {k} gradient differs from plain path by "
                 f"{res[f'{k}_rel_err']} (relative L2) > {GRAD_TOL}")
    for t in leaves.values():
        t.requires_grad_(False)
    return res


def phase_train():
    """``train_device`` on full-width TinyLlama-1.1B (bf16, random weights
    from seed 0): 8 steps at batch 4 x 1024 tokens, lr 1e-3, through the
    functions ``launch/train.py`` uses.  Then the kernel path against the
    plain path on one batch, the step time, and a profile of one step."""
    from repro_torch.configs import get_config
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import device as D
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
    from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like

    cfg = get_config("tinyllama-1.1b", variant="full")
    if not (cfg.use_kernels and cfg.remat):
        fail("config does not train through the kernels with remat")
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    spec = D.DeviceSpec(0, cfg, 0, int(corpus.device_domain[0]))
    run = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
               lr=TRAIN_LR, seed=0, device="cuda")

    # the main path, counts from 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa_ops.LAUNCHES = 0
    kd_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    up = D.train_device(spec, corpus, **run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_ops.LAUNCHES,
                "kd_loss": kd_ops.LAUNCHES}
    losses = up["losses"]
    del up
    # every group and every loss chunk is rematerialised in the backward
    # (cfg.remat), so each kernel runs twice per use per step
    chunks = TRAIN_SEQ // cfg.loss_chunk
    want = {"flash_attention": TRAIN_STEPS * cfg.n_layers * 2,
            "kd_loss": TRAIN_STEPS * chunks * 2}
    print(f"train: {TRAIN_STEPS} steps in {wall:.2f}s, losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses}")
    if launches != want:
        fail(f"train launches {launches} != expected {want}")

    # kernel path against plain path on one batch, fresh weights
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, generator=gen)
    batch = {k: v.cuda() for k, v in corpus.device_batch(
        0, TRAIN_BATCH, TRAIN_SEQ, step=0).items()}
    check = _grad_check(M, cfg, params, batch)

    # step time: one warm-up step, then synchronised steps
    opt = adamw_init(params)
    sched = cosine_schedule(TRAIN_LR, TRAIN_STEPS, warmup=1)
    batches = corpus.device_batches(0, 5, TRAIN_BATCH, TRAIN_SEQ)
    steps = [{k: v[s].cuda() for k, v in batches.items()} for s in range(5)]
    D.train_step(params, opt, cfg, steps[0], sched(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for b in steps[1:4]:
        t0 = time.perf_counter()
        D.train_step(params, opt, cfg, b, sched(2))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the step's two halves on CUDA events: loss + gradient, then AdamW
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    ev[0].record()
    loss, _ = M.loss_fn(params, cfg, steps[4])
    grads = torch.autograd.grad(loss, leaves)
    ev[1].record()
    adamw_update(tree_unflatten_like(params, grads), opt, params,
                 lr=sched(2))
    ev[2].record()
    torch.cuda.synchronize()
    del grads

    n_params = sum(t.numel() for t in tree_leaves(params))
    n_matmul = n_params - params["embed"].numel()   # the lookup is no GEMM
    tokens = TRAIN_BATCH * TRAIN_SEQ
    H, Dh = cfg.n_heads, cfg.resolved_head_dim
    attn = 3 * 4 * TRAIN_BATCH * H * Dh * TRAIN_SEQ * (TRAIN_SEQ + 1) / 2 \
        * cfg.n_layers                 # causal QK^T and PV, fwd + 2x bwd
    model_flops = 6 * n_matmul * tokens + attn
    ms = sorted(step_ms)[len(step_ms) // 2]
    prof = profile(lambda: D.train_step(params, opt, cfg, steps[4],
                                        sched(2)),
                   top=10, groups={"kd_loss": ("kd_partial", "kd_merge"),
                                   "flash_fwd": ("flash_fwd",)})
    res = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "losses": losses, "train_device_wall_s": wall,
           "launches": launches, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "mfu": model_flops / (ms / 1e3) / PEAK_BF16,
           "model_tflop_per_step": model_flops / 1e12,
           "n_params": n_params, "peak_mem_gb": peak_gb,
           "loss_grad_ms": ev[0].elapsed_time(ev[1]),
           "adamw_ms": ev[1].elapsed_time(ev[2]), **check}
    print("train " + json.dumps(res))
    print("profile " + json.dumps({"train_step": prof}))
    return launches


# ---------------------------------------------------------------------------
# phase 7: Phase III on Qwen1.5-MoE-A2.7B, full width, 12 of 24 layers
# ---------------------------------------------------------------------------

TUNE_LAYERS, TUNE_STEPS, TUNE_BATCH, TUNE_SEQ, TUNE_K = 12, 6, 4, 1024, 4
TUNE_CHECK_LAYER = 5
# The kernel path's loss and gradients on one 1 x 1024 batch of the tuned
# model, against the same path with kernels 4-6 swapped for their plain
# versions (``moe_ffn_capacity_ref``: the same capacity, ranks and
# drops), in f32 (parameters upcast).  The plain run replays the kernel
# run's top-4 expert choices (and takes its weights and load-balance loss
# at them): the two paths sum in other orders, and a near-tied choice
# resolved the other way by that rounding (in f32 too: one token in layer
# 11 in two of four runs; unreplayed, that read 7.6e-3 on wi_gate) would
# change which experts a token meets and compound through 12 layers.
# The dropless plain path (``use_kernels=False``) is a different
# function wherever the capacity drops, so it is reported, not held.
# Readings on an H100 (700 W), with and without a replayed choice: loss
# |d| = 0, gradients 3.3e-6 (lm_head) to 5.4e-6 (wi_gate) relative L2.
# Limits: the loss to 1e-5 (about ten f32 ulps of ~12.6), each gradient
# to 2e-5, about 3x the worst reading.
TUNE_LOSS_TOL = 1e-5
TUNE_GRAD_TOL = 2e-5
# The same check on the tuned bf16 model, as it runs: stage A's mma.sync
# and the backward's bf16-operand products against the plain version's
# f32 bmm of bf16 inputs, activations rounded to bf16 at the same points
# but from sums in other orders, so one-ulp differences compound through
# 12 layers (the replay then swaps 21-85 of 1,024 tokens' choices a
# layer).  Reading on an H100 (700 W): loss |d| 3.7e-4, gradients 0.022
# (lm_head) to 0.035 (wi_gate) relative L2.  Limits about 3x the
# reading: 1e-3 and 0.1.
TUNE_BF16_LOSS_TOL = 1e-3
TUNE_BF16_GRAD_TOL = 0.1


def _dropped(idx, n_experts):
    """Assignments that ``moe_ffn``'s capacity drops for one call's
    routing choices idx (T, k)."""
    from repro_torch.kernels.moe_dispatch.ops import capacity_positions
    T, k = idx.shape
    _, keep = capacity_positions(idx.reshape(-1),
                                 max(-(-T * k // n_experts) * 2, 8))
    return int((~keep).sum())


def _check_merge(params, bases, cfg):
    """The merge rule, exactly: routed expert e of every layer is base
    model e mod K's FFN, and the shared experts tile the bases' average
    FFN (f32 sum, divided, rounded to bf16; ``wo`` divided by their
    number).  Frozen leaves: this holds after tuning too."""
    from repro_torch.utils.pytree import tree_average
    K, n_sh = len(bases), cfg.n_shared_experts
    sub = params["blocks"]["sub0"]["moe"]
    for w in ("wi_gate", "wi_up", "wo"):
        for e in range(cfg.n_experts):
            if not torch.equal(sub[w][:, e],
                               bases[e % K]["blocks"]["sub0"]["mlp"][w]):
                fail(f"routed expert {e} {w} is not base {e % K}'s FFN")
    avg = tree_average([b["blocks"]["sub0"]["mlp"] for b in bases])
    want = {"wi_gate": avg["wi_gate"].repeat(1, 1, n_sh),
            "wi_up": avg["wi_up"].repeat(1, 1, n_sh),
            "wo": avg["wo"].repeat(1, n_sh, 1) / n_sh}
    for w, t in want.items():
        if not torch.equal(sub["shared"][w], t):
            fail(f"shared expert {w} is not the tiled average FFN")


def _tune_grad_check(M, cfg, params, batch, loss_tol, grad_tol):
    """Loss and the gradients of ``lm_head``, layer TUNE_CHECK_LAYER's
    router, ``wq`` and (frozen) routed ``wi_gate``: the kernel path
    against its plain version (held to ``loss_tol`` absolute and
    ``grad_tol`` relative L2) and against the dropless plain path
    (reported).  ``params`` in ``cfg.dtype``."""
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.kernels.moe_gemm import ref as mg_ref
    from repro_torch.models import moe
    from repro_torch.utils.pytree import tree_leaves
    g = TUNE_CHECK_LAYER
    sub = params["blocks"]["sub0"]
    leaves = {"lm_head": params["lm_head"], "router": sub["moe"]["router"],
              "wq": sub["attn"]["wq"], "wi_gate": sub["moe"]["wi_gate"]}
    for t in tree_leaves(params):
        t.requires_grad_(False)
    for t in leaves.values():
        t.requires_grad_(True)

    choices, replaced = [], []
    own_route = moe.route

    def recording_route(p, c, x):
        w, idx, aux = own_route(p, c, x)
        choices.append(idx)
        return w, idx, aux

    def replaying_route(p, c, x):
        # the kernel run's choices, in call order (forward, then remat's
        # recompute); weights and load-balance loss from this run's own
        # router probabilities at those choices
        _, idx, _ = own_route(p, c, x)
        want = choices[len(replaced)]
        replaced.append(int((torch.sort(idx, -1).values != torch.sort(
            want, -1).values).any(-1).sum()))
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        w = probs.gather(-1, want)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        return w, want, moe.load_balance_loss(c, probs, want)

    def run(use_kernels, plain_moe, route):
        kernel_moe_ffn = mg_ops.moe_ffn
        n0 = md_ops.LAUNCHES + sum(mg_ops.LAUNCHES.values())
        if plain_moe:
            mg_ops.moe_ffn = mg_ref.moe_ffn_capacity_ref
        moe.route = route
        try:
            loss, _ = M.loss_fn(params, cfg.replace(use_kernels=use_kernels),
                                batch)
            gs = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            mg_ops.moe_ffn = kernel_moe_ffn
            moe.route = own_route
        moe_launches = md_ops.LAUNCHES + sum(mg_ops.LAUNCHES.values()) - n0
        grads = {k: (gr if k == "lm_head" else gr[g]).float()
                 for k, gr in zip(leaves, gs)}
        return loss.item(), grads, moe_launches

    lk, gk, nk = run(True, False, recording_route)
    lc, gc, nc = run(True, True, replaying_route)
    lp, gp, _ = run(False, False, own_route)
    if len(replaced) != len(choices):
        fail(f"tune check: {len(choices)} routing calls in the kernel run, "
             f"{len(replaced)} replayed")
    if nk <= 0 or nc != 0:
        fail(f"tune check: {nk} MoE kernel launches on the kernel path, "
             f"{nc} on its plain version")

    def cmp(ga, gb, la, lb, tag):
        res = {f"loss_{tag}": lb, f"loss_abs_err_{tag}": abs(la - lb)}
        for k in leaves:
            res[f"{k}_rel_err_{tag}"] = (
                (ga[k] - gb[k]).norm() / gb[k].norm()).item()
        return res

    # the first n_layers routing calls are the forward's, one per layer
    drops = [_dropped(i, cfg.n_experts) for i in choices[:cfg.n_layers]]
    res = {"dtype": cfg.dtype, "loss_kernel": lk,
           "kernel_path_dropped_per_layer": drops,
           "plain_choices_replaced_per_call": replaced,
           "assignments_per_layer": batch["tokens"].numel() * cfg.top_k,
           **cmp(gk, gc, lk, lc, "vs_plain_capacity"),
           **cmp(gk, gp, lk, lp, "vs_plain_dropless")}
    print("tune kernel vs plain " + json.dumps(res))
    err = res["loss_abs_err_vs_plain_capacity"]
    if not math.isfinite(err) or err > loss_tol:
        fail(f"tune ({cfg.dtype}): kernel-path loss differs from its plain "
             f"version by {err} > {loss_tol}")
    for k in leaves:
        e = res[f"{k}_rel_err_vs_plain_capacity"]
        if not e <= grad_tol:
            fail(f"tune ({cfg.dtype}): kernel-path {k} gradient differs from "
                 f"its plain version by {e} (relative L2) > {grad_tol}")
    for t in leaves.values():
        t.requires_grad_(False)
    return res


def phase_tune():
    """Phase III through ``DeepFusionServer.merge_and_tune`` at full width
    with 12 of 24 layers: merge K = 4 random base models, tune 6 steps of
    4 x 1024 tokens with frozen experts (lr 5e-4, cosine, warmup 1)."""
    from repro_torch.configs import get_config
    from repro_torch.core import merge, tuning
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import server as S
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths

    cfg = get_config("qwen2-moe-a2.7b", variant="full").replace(
        n_layers=TUNE_LAYERS)
    if not (cfg.use_kernels and cfg.remat):
        fail("config does not tune through the kernels with remat")
    base_cfg = merge.base_config_of(cfg)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bases = [M.init_params(base_cfg, generator=torch.Generator(
        device="cuda").manual_seed(100 + i)) for i in range(TUNE_K)]
    scfg = S.ServerConfig(cfg, tune_steps=TUNE_STEPS, tune_batch=TUNE_BATCH,
                          seq_len=TUNE_SEQ, seed=0)
    # the server's merge, drawn again from its seed (seed + 303): check
    # the rule, and keep the trainable leaves to see that tuning moves them
    merged = merge.merge_into_moe(torch.Generator(device="cuda").manual_seed(
        scfg.seed + 303), cfg, bases)
    _check_merge(merged, bases, cfg)
    mask = tuning.expert_freeze_mask(merged)
    before = {p: t.clone() for (p, t), m in zip(tree_paths(merged),
                                                tree_leaves(mask)) if m}
    del merged
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    marks, choices, step_choices = [], [], []
    own_route = moe.route

    def recording_route(p, c, x):
        w, idx, aux = own_route(p, c, x)
        choices.append(idx)
        return w, idx, aux

    def on_step(s, loss):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        step_choices.append(choices[:])
        choices.clear()

    srv = S.DeepFusionServer(scfg, corpus, [], device="cuda",
                             on_step=on_step)
    # the main path, counts from 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fa_ops.LAUNCHES = kd_ops.LAUNCHES = md_ops.LAUNCHES = 0
    mg_ops.LAUNCHES.update(grouped_ffn=0, grouped_matmul=0)
    moe.route = recording_route
    t0 = time.perf_counter()
    try:
        params, losses = srv.merge_and_tune(bases)
    finally:
        moe.route = own_route
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"flash_attention": fa_ops.LAUNCHES,
                "kd_loss": kd_ops.LAUNCHES,
                "gather_scatter_add": md_ops.LAUNCHES,
                "grouped_ffn": mg_ops.LAUNCHES["grouped_ffn"],
                "grouped_matmul": mg_ops.LAUNCHES["grouped_matmul"]}
    L, n = cfg.n_layers, TUNE_STEPS
    # per layer and step, with each group rematerialised: dispatch and
    # combine forward twice plus their two backward movements; the FFN
    # forward twice; the backward's eight grouped products; flash twice;
    # kd_loss twice per loss chunk
    want = {"flash_attention": 2 * L * n,
            "kd_loss": 2 * (TUNE_SEQ // cfg.loss_chunk) * n,
            "gather_scatter_add": 6 * L * n, "grouped_ffn": 2 * L * n,
            "grouped_matmul": 8 * L * n}
    # each layer routes twice a step: the forward and remat's recompute
    drops = [sum(_dropped(i, cfg.n_experts) for i in c) / 2
             for c in step_choices]
    del step_choices
    print(f"tune: {n} steps in {wall:.2f}s (merge included), losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}")
    if launches != want:
        fail(f"tune launches {launches} != expected {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite tuning loss: {losses}")

    # frozen experts bit-identical to the merge, trainable leaves moved
    _check_merge(params, bases, cfg)
    del bases
    now = dict(tree_paths(params))
    frozen = [p for p, m in zip(now, tree_leaves(
        tuning.expert_freeze_mask(params))) if not m]
    unchanged = [p for p, t in before.items() if torch.equal(now[p], t)]
    # bf16 norm scales sit at 1.0, where half a bf16 ulp (2^-10) exceeds
    # an AdamW step of lr <= 5e-4: they round back to 1.0 (the reference
    # keeps bf16 parameters too).  Every other trainable leaf must move.
    norms = [p for p in unchanged if p.endswith("/scale")
             and bool((now[p] == 1).all())]
    if set(unchanged) - set(norms):
        fail(f"trainable leaves unchanged by tuning: "
             f"{sorted(set(unchanged) - set(norms))}")
    del before, now

    # where the time goes: one more step under the profiler
    mask, opt = tuning.init_tuning(params)
    step = tuning.make_tune_step(cfg, mask)
    b = {k: v.cuda() for k, v in corpus.mixed_eval_batch(
        TUNE_BATCH, TUNE_SEQ, seed_salt=78).items()}
    prof = profile(lambda: step(params, opt, b, scfg.tune_lr), top=12,
                   groups={"grouped_matmul_and_ffn_stage_b": ("gmm_kernel",),
                           "ffn_stage_b": ("gmm_kernel<float, "
                                           "__nv_bfloat16, __nv_bfloat16>",),
                           "ffn_stage_a": ("ffn_gate_up",),
                           "gather_scatter_add": ("gsa_kernel",),
                           "kd_loss": ("kd_partial", "kd_merge"),
                           "flash_fwd": ("flash_fwd",)})
    del opt, step
    n_params = sum(t.numel() for t in tree_leaves(params))
    trainable = sum(map(bool, tree_leaves(mask)))

    # the tuned model, kernel path against its plain version: in bf16 as
    # tuned, then in f32 (the bf16 copy freed)
    batch = {k: v.cuda() for k, v in corpus.mixed_eval_batch(
        1, TUNE_SEQ, seed_salt=77).items()}
    check_bf16 = _tune_grad_check(M, cfg, params, batch,
                                  TUNE_BF16_LOSS_TOL, TUNE_BF16_GRAD_TOL)
    params = tree_map(lambda t: t.detach().float(), params)
    torch.cuda.empty_cache()
    check = _tune_grad_check(M, cfg.replace(dtype="float32"), params, batch,
                             TUNE_LOSS_TOL, TUNE_GRAD_TOL)
    del params

    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    ms = sorted(step_ms)[len(step_ms) // 2]
    tokens = TUNE_BATCH * TUNE_SEQ
    D, Fh, H, Dh = cfg.d_model, cfg.moe_d_ff, cfg.n_heads, \
        cfg.resolved_head_dim
    per_layer = (4 * D * H * Dh + D * cfg.n_experts
                 + 3 * D * Fh * (cfg.n_shared_experts + cfg.top_k))
    active = L * per_layer + D * cfg.vocab_size   # the head is a GEMM too
    attn = 3 * 4 * TUNE_BATCH * H * Dh * TUNE_SEQ * (TUNE_SEQ + 1) / 2 * L
    model_flops = 6 * active * tokens + attn
    res = {"layers": L, "steps": n, "batch": TUNE_BATCH, "seq": TUNE_SEQ,
           "base_models": TUNE_K, "losses": losses, "setup_s": setup_s,
           "merge_and_tune_wall_s": wall, "launches": launches,
           "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "mfu": model_flops / (ms / 1e3) / PEAK_BF16,
           "model_tflop_per_step": model_flops / 1e12,
           "active_matmul_params": active, "n_params": n_params,
           "trainable_fraction": srv.report["trainable_fraction"],
           "dropped_per_step": drops,
           "assignments_per_step": L * tokens * cfg.top_k,
           "frozen_leaves_bit_identical": len(frozen),
           "trainable_leaves_changed": trainable - len(norms),
           "norm_scales_unchanged_in_bf16": norms,
           "peak_mem_gb": peak_gb, **check,
           "bf16_check": check_bf16}
    print("tune " + json.dumps(res))
    print("profile " + json.dumps({"tune_step": prof}))
    return launches


KERNELS = {
    "kd_loss": {
        "route": "cuda", "source": "src/repro_torch/csrc/kd_loss.cu",
        "replaces": "src/repro/kernels/kd_loss/kernel.py:163"},
    "flash_attention": {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:108"},
    "paged_attn": {
        "route": "cuda", "source": "src/repro_torch/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:159"},
    "grouped_ffn": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:136"},
    "grouped_matmul": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:103"},
    "gather_scatter_add": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_dispatch.cu",
        "replaces": "src/repro/kernels/moe_dispatch/kernel.py:68"},
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = phase_card()
    phase_build()
    rows = phase_kernels()
    serve = phase_serve()
    train = phase_train()
    tune = phase_tune()
    # launches: the counts of every path run that drives the kernel
    launches = {k: serve.get(k, 0) + train.get(k, 0) + tune.get(k, 0)
                for k in KERNELS}
    line = []
    for kname in KERNELS:
        main_row = rows[kname]
        if launches[kname] <= 0:
            fail(f"{kname} was never launched on the main path")
        line.append({"name": kname, **KERNELS[kname],
                     "launches": launches[kname],
                     "max_abs_err": main_row["max_abs_err"],
                     "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
                     "bound_ms": main_row["bound_ms"],
                     "bound_by": main_row["bound_by"],
                     "library_ms": main_row["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
