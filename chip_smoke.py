#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (non-zero exit, no result line) on failure:

1. card: name and power limit (nvidia-smi), device name (torch);
2. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu``, in
   parallel, into ``build/repro_torch/`` (cached by source hash);
3. kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the serve, train and tune paths' shapes plus small edge
   cases (MoE: a drop case, transposed operands, gelu, ragged edges;
   SSD scan: ragged, two groups with h0, odd tiles, an odd row stride,
   f32, each in the instance ``ops.instance`` must pick (``tc``:
   tensor cores, W, h_in and B∘w as two bf16 terms; ``general``; ``f32``),
   launched twice and bit-identical, bf16 y also by the per-element rule,
   each also with slow decay, where the far pairs and the carried state
   must show;
   the bf16 flash kernel (tensor cores) at every head dim 16-256 with a
   window, a softcap, ragged S, S < 64, S = 1 and GQA ratios 1, 2 and 8,
   timed at the serve, train and tune shapes and at D 256;
   flash and paged attention at head dims 16, 24, 96, 112 and 256; the
   paged kernel's int8/fp8 dequant branch with scales that vary by row
   and head, where permuted or dropped scales must move the plain
   output by QUANT_FAR; every paged case launched twice, the two
   outputs bit-identical (the kernel merges its context's slices in a
   fixed order); paged also timed at 8 slots x ctx 4096, bf16 and int8),
   each output element within two bf16 ulps of its own value + 1e-4
   (1e-4 for f32 outputs), kd_loss's argmax-correct exactly except on
   rows whose top two logits are within ``ARGMAX_MARGIN``; kd_loss in
   each instance (``wgmma`` timed at the train and tune steps' shapes
   and in KD mode, and on ragged T, V and D; ``general`` for rows or
   bases TMA cannot take; ``f32``), every case launched twice and
   bit-identical, planted ties across vocab-tile and split boundaries
   going to the lower index; the grouped matmul in each instance
   (``wgmma`` and ``wgmma_split`` timed at the backward's five layouts
   at the tune path's shapes, f32 operands split on the card; ragged M,
   N and K, K below one chunk, one expert, odd N; ``general`` for
   misaligned operands; ``f32``), every case launched twice and
   bit-identical, and its split pass bit for bit; the token
   dispatch/combine's four movements at the tune shapes through
   ``moe_ffn``'s shared layouts and the bias-4.0 drop case (``vec``:
   16-byte rows; f32 in three passes; ``general`` for bf16 D 2100 and a
   misaligned source), each bit-equal to the in-order plain version on
   the CPU, launched twice with the same bits, the backwards' bf16 dsrc
   bit-equal to an f32 copy summed then cast, the fused dscale bit-equal
   to its order's plain version and within DSCALE_REL of ``.sum(-1)``;
   kernel, plain
   and library-call times (``scaled_dot_product_attention``, matmul +
   ``cross_entropy``, ``torch.bmm``, ``index_add_``: yardsticks the
   port never calls; none for the SSD scan) from CUDA events
   with L2 flushed before each call, and the least time the card could
   take (bytes over 3.35 TB/s, flops over the type's peak);
4. serve: full-width TinyLlama-1.1B (bf16, random weights from seed 0)
   behind ``PagedServeEngine``: 16 greedy requests, prompts of 128-1024
   tokens, 64 new tokens each.  Checks the completions, the allocator,
   the kernels' launch counts on that run, and the kernel path's logits
   against the plain path's;
5. profile: torch.profiler over one 1024-token prefill (flash's share
   read apart) and one decode segment (the paged kernel's share read
   apart, failing at zero; device launches a layer-step);
5a. serve_kv: the same model, traffic and engine with the KV pool in
   bf16, int8, fp8 and bf16 again, in turns.  Checks the completions,
   the dequant branch's launches in the quantized runs (22 per decode
   step, none of the unquantized branch), the decode logits of the
   quantized kernel path against the quantized gather path and against
   the unquantized path (and that dropped scales would fail that
   limit), reports speed, pool bytes and peak memory against the bf16
   runs, bf16 against int8 pools of equal bytes (live requests,
   preemptions), and profiles an int8 decode segment as phase 5 does;
5b. serve_ssm: full-width, full-depth Mamba2-1.3B (bf16, random weights
   from seed 0) behind ``PagedServeEngine``: 16 greedy requests, prompts
   of 128-1024 tokens, 64 new tokens each.  Checks the completions, the
   SSD kernel's launches (48 per prefill, all ``tc``), logits on two
   prompts (f32 kernel path against the plain version; bf16 paths
   against the f32 model; prefill + decode against one prefill), and
   profiles one 1024-token prefill (the scan's three launches read
   apart) and one decode segment;
6. train: ``train_device`` on full-width TinyLlama-1.1B (bf16, random
   weights from seed 0), 8 steps of 4 x 1024 tokens at lr 1e-3.  Checks
   finite, falling losses and the kernels' launch counts on that run
   (every kd_loss launch in the wgmma instance),
   the kernel path's loss and gradients against the plain path's, every
   layer's flash output on a real batch (q, k, v caught on the path)
   against the plain version's by the per-element rule, and
   reports ms per step, tokens/s, MFU, peak memory and a profile;
7. tune: Phase III on Qwen1.5-MoE-A2.7B at full width, 12 of its 24
   layers (bf16, random weights): K = 4 random base models merged by
   ``merge_into_moe`` on the card (the merge rule checked exactly), then
   ``DeepFusionServer.merge_and_tune`` for 6 steps of 4 x 1024 tokens
   with frozen experts at lr 5e-4.  Checks finite losses, frozen experts
   bit-identical and every trainable leaf changed, the MoE kernels'
   launch counts (every kd_loss launch in the wgmma instance, every
   grouped-matmul launch in a tensor-core instance, every dispatch/
   combine launch in the vec instance), the
   kernel path's loss and gradients against its plain
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
import re
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
        fn = ""
        for line in report.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                fn = _kernel_label(entry.group(1))
            if "registers" in line or "spill" in line:
                print(f"  ptxas {stem} {fn}: {line.strip()}")
    # the paged kernel's shared memory is dynamic, which ptxas does not see
    from repro_torch.kernels.paged_attn import ops as pa_ops
    for dt in (torch.float32, torch.bfloat16, torch.int8,
               torch.float8_e4m3fn):
        cfg = {D: pa_ops.kernel_config(dt, D) for D in pa_ops._HEAD_DIMS}
        print(f"  paged_attn {str(dt)[6:]}: shared bytes (keys a tile) by "
              f"head dim " + ", ".join(f"D{D} {s} ({tk})"
                                       for D, (tk, s) in cfg.items()))


def _kernel_label(mangled: str) -> str:
    """A readable label of a mangled kernel name from the anonymous
    namespace of a ``csrc`` file: the function's name and its template
    arguments as mangled (``flash_fwd_tc_kernelILi64EE``)."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled[:60]
    pos, parts = m.start(1), []
    while d := re.match(r"\d+", mangled[pos:]):  # nested namespaces
        start = pos + d.end()
        pos = start + int(d.group())
        parts.append(mangled[start:pos])
    name, rest = "::".join(parts), mangled[pos:]
    if rest.startswith("I"):
        name += rest[:rest.find("EE") + 2]
    return name


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
    bt, n_blocks = _pool_table(gen, ctx, bl)
    nbt = bt.shape[1]
    pos = torch.tensor([c - C for c in ctx], dtype=torch.int32,
                       device="cuda")
    q = _randn(gen, (B, C, H, D), dtype)
    kp = _randn(gen, (n_blocks, bl, KH, D), dtype)
    vp = _randn(gen, (n_blocks, bl, KH, D), dtype)
    kw = dict(window=window, softcap=softcap)
    out = ops.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    want = ref.paged_attention_ref(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    name = (f"paged slots={B} ctx={min(ctx)}-{max(ctx)} C={C} H={H} KH={KH} "
            f"D={D} bl={bl} {str(dtype)[6:]} window={window} "
            f"softcap={softcap}")
    row = check_close(name, out, want)
    _check_repeat(name, out, lambda: ops.paged_decode_attention(
        q, kp, vp, bt, pos, **kw))
    if timed:
        row["split"] = _split(ops, q, kp, bt)
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


def _check_repeat(name, out, again):
    """The paged kernel merges its context's slices in a fixed order: a
    second launch on the same inputs must give the same bits."""
    if not torch.equal(out, again()):
        fail(f"{name}: a second launch on the same inputs differs")


def _split(ops, q, kp, bt):
    """(tiles per slice, slices) the paged kernel runs at these shapes."""
    B, C, H, D = q.shape
    return ops.split_plan(B, C, H, kp.shape[2], D, kp.element_size(),
                          kp.shape[1], bt.shape[1],
                          torch.cuda.get_device_properties(
                              0).multi_processor_count)


def _pool_table(gen, ctx, bl):
    """Block table and pool size for len(ctx) slots holding ctx[b] cached
    positions: blocks scattered over the pool in a random order, table
    entries past a slot's blocks pointing at block 0."""
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
    return bt, n_blocks


# A quantized case draws q ~ N(0, 16) and each K/V row as N(0,1) times
# 2^u, u uniform in
# [-QUANT_LOG2_SPREAD, QUANT_LOG2_SPREAD] per (position, kv head), less
# QUANT_LOG2_SPREAD (rows of at most unit size: outputs stay O(1), so
# the f32 limit of 1e-4 stays a few ulps), then quantizes them: scales
# then span 2^(2 * spread) across rows and heads.  The plain version is
# run again with the k scales permuted across rows and heads, the v
# scales permuted, and both set to 1 (dropped); each output must lie at
# least QUANT_FAR (relative RMS) from the true plain output, or the
# check could not see a misplaced or dropped scale.
QUANT_LOG2_SPREAD = 4.0
QUANT_FAR = 0.1


def _rel_rms(a, b):
    """RMS of a - b over the RMS of b, in f32."""
    a, b = a.float(), b.float()
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def paged_quant_case(gen, ctx, C, H, KH, D, bl, dtype, kv, *, window=0,
                     softcap=0.0, timed=False):
    """The paged kernel's dequant branch against its plain version: int8
    or fp8 pools with per-(position, kv head) scales that vary by row and
    head, q and out in ``dtype``.  Also shows that permuted or dropped
    scales move the plain output by at least QUANT_FAR."""
    from repro_torch.kernels.paged_attn import ops, ref
    from repro_torch.models import quant
    from repro_torch.models.layers import paged_gather
    B = len(ctx)
    bt, n_blocks = _pool_table(gen, ctx, bl)
    pos = torch.tensor([c - C for c in ctx], dtype=torch.int32,
                       device="cuda")
    # q ~ N(0, 16): scores spread enough that moving the k scales moves
    # the softmax weights
    q = (4 * torch.randn((B, C, H, D), generator=gen, device="cuda")
         ).to(dtype)

    def rows():
        u = (torch.rand((n_blocks, bl, KH, 1), generator=gen, device="cuda")
             * 2 - 1) * QUANT_LOG2_SPREAD - QUANT_LOG2_SPREAD
        return torch.randn((n_blocks, bl, KH, D), generator=gen,
                           device="cuda") * torch.exp2(u)
    kp, ks = quant.quantize(rows(), kv)
    vp, vs = quant.quantize(rows(), kv)
    kw = dict(window=window, softcap=softcap, out_dtype=dtype)
    out = ops.paged_decode_attention(q, kp, vp, bt, pos, k_scale=ks,
                                     v_scale=vs, **kw)
    want = ref.paged_attention_ref(q, kp, vp, bt, pos, k_scale=ks,
                                   v_scale=vs, **kw)
    torch.cuda.synchronize()
    name = (f"paged_quant {kv} slots={B} ctx={min(ctx)}-{max(ctx)} C={C} "
            f"H={H} KH={KH} D={D} bl={bl} out={str(dtype)[6:]} "
            f"window={window} softcap={softcap}")
    row = check_close(name, out, want)
    _check_repeat(name, out, lambda: ops.paged_decode_attention(
        q, kp, vp, bt, pos, k_scale=ks, v_scale=vs, **kw))

    def perm(t):
        idx = torch.randperm(t.numel(), generator=gen, device="cuda")
        return t.reshape(-1)[idx].reshape(t.shape)
    ones = torch.ones_like(ks)
    far = {
        "k_scales_permuted": ref.paged_attention_ref(
            q, kp, vp, bt, pos, k_scale=perm(ks), v_scale=vs, **kw),
        "v_scales_permuted": ref.paged_attention_ref(
            q, kp, vp, bt, pos, k_scale=ks, v_scale=perm(vs), **kw),
        "scales_dropped": ref.paged_attention_ref(
            q, kp, vp, bt, pos, k_scale=ones, v_scale=ones, **kw)}
    far = {k: _rel_rms(v, want) for k, v in far.items()}
    row.update(kv=kv, rel_rms_from_true=far,
               scale_log2_range=[math.log2(ks.min().item()),
                                 math.log2(ks.max().item())])
    near = {k: v for k, v in far.items() if not v >= QUANT_FAR}
    if near:
        fail(f"{name}: perturbed scales leave the plain output within "
             f"{QUANT_FAR} relative RMS {near}: the check could not see them")
    if timed:
        row["split"] = _split(ops, q, kp, bt)
        # every visible int8/fp8 K/V row once, plus its 4-byte scale per
        # pool, q read and out written once
        n_rows = sum(ctx)
        nbytes = (2 * n_rows * KH * (D * kp.element_size() + 4)
                  + 2 * q.numel() * q.element_size()
                  + bt.numel() * 4 + pos.numel() * 4)
        flops = 4 * D * H * sum(c - C + 1 + (C - 1) / 2 for c in ctx) * C
        # the library yardstick attends a pre-gathered, pre-dequantized
        # cache in q's dtype (neither the gather nor the dequant timed)
        S = bt.shape[1] * bl
        kg = quant.dequantize(paged_gather(kp, bt), paged_gather(ks, bt),
                              dtype).transpose(1, 2).contiguous()
        vg = quant.dequantize(paged_gather(vp, bt), paged_gather(vs, bt),
                              dtype).transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        kpos = torch.arange(S, device="cuda")[None, None, None, :]
        qpos = (pos.long()[:, None, None, None]
                + torch.arange(C, device="cuda")[None, None, :, None])
        mask = kpos <= qpos
        row.update(
            ms=time_ms(lambda: ops.paged_decode_attention(
                q, kp, vp, bt, pos, k_scale=ks, v_scale=vs, **kw)),
            plain_ms=time_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, bt, pos, k_scale=ks, v_scale=vs, **kw)),
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


# the plain version's logits and their temporaries above this are not
# timed (the check still runs it once)
PLAIN_TIMED_BYTES = 4e9


def _n_sm():
    return torch.cuda.get_device_properties(0).multi_processor_count


def _tie_columns(T, V, inst, teacher):
    """Two columns per row for a planted tie: in turn across a vocab-tile
    boundary inside a split, across a split boundary, and far apart
    (the tiles and splits ``inst`` runs at these shapes)."""
    from repro_torch.kernels.kd_loss import ops
    _, tile_v = ops.tile_shape(inst, teacher)
    ns, tps = ops.vocab_splits(T, V, _n_sm(), inst, teacher)
    rows = torch.arange(T, device="cuda")
    kind = (rows // 2) % 3
    far_lo, far_hi = rows * 17 % (V // 2), V // 2 + rows * 29 % (V // 2)
    if ns < 3:
        return far_lo, far_hi
    s = 1 + (rows // 6) % (ns - 2)     # neither the first split nor the last
    split_edge = s * tps * tile_v
    tile_edge = split_edge + tile_v if tps > 1 else split_edge
    hi = torch.where(kind == 0, tile_edge,
                     torch.where(kind == 1, split_edge, far_hi))
    return torch.where(kind < 2, hi - 1, far_lo), hi


def kd_case(gen, T, Ds, Dt, V, dtype, *, tau=1.0, cap_s=0.0, cap_t=0.0,
            timed=False, ties=False, inst=None, misalign=False):
    """The kd_loss kernel against its plain version, launched twice (the
    splits merge in a fixed order: the two must give the same bits).
    Hidden states ~N(0,1) and heads ~N(0,1/D), as the model draws them.
    ``inst`` is the instance the inputs must take (default: ``wgmma`` for
    bf16, ``f32`` for f32); ``misalign`` puts hs one element off a 16-byte
    boundary.  ``ties`` plants, in integer-valued inputs (exact in any
    order), a maximum at two columns of every row, across tile and split
    boundaries; the lower index must win."""
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
    inst = inst or ("f32" if dtype == torch.float32 else "wgmma")
    if ties:
        rows = torch.arange(T, device="cuda")
        hs = torch.eye(T, Ds, device="cuda").to(dtype)
        ws = torch.randint(-3, 4, (Ds, V), generator=gen, device="cuda")
        lo, hi = _tie_columns(T, V, inst, bool(Dt))
        ws[rows, lo] = ws[rows, hi] = 9
        ws = ws.to(dtype)
        lab = torch.where(rows % 2 == 0, lo, hi).to(torch.int32)
    if misalign:
        hs = torch.cat([hs.new_zeros(1), hs.flatten()])[1:].view(T, Ds)
    took = ops.instance(hs, ws, ht, wt)
    name = (f"kd_loss T={T} Ds={Ds} Dt={Dt} V={V} {str(dtype)[6:]} "
            f"tau={tau} softcap={cap_s}/{cap_t}{' ties' if ties else ''}"
            f"{' misaligned' if misalign else ''} [{took}]")
    if took != inst:
        fail(f"{name}: took the {took} instance, not {inst}")
    kw = dict(tau=tau, softcap_s=cap_s, softcap_t=cap_t)
    ce, kl, cor = ops.kd_loss_fwd(hs, ws, ht, wt, lab, **kw)
    again = ops.kd_loss_fwd(hs, ws, ht, wt, lab, **kw)
    if Dt:
        w_ce, w_kl, w_cor = ref.ce_kl_ref(hs, ws, ht, wt, lab, **kw)
    else:
        (w_ce, w_cor), w_kl = ref.ce_ref(hs, ws, lab, softcap=cap_s), None
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((ce, kl, cor), again)):
        fail(f"{name}: a second launch on the same inputs differs")
    row = check_close(name + " ce", ce, w_ce)
    row["instance"] = took
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
    del w_ce, w_kl, w_cor, again
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
        # f32 copies of the inputs, the f32 logits and one temporary a side
        plain_bytes = 4 * (T * d_all + d_all * V + 2 * T * V * (1 + bool(Dt)))
        row.update(ms=time_ms(lambda: ops.kd_loss_fwd(hs, ws, ht, wt, lab,
                                                      **kw)),
                   plain_ms=(time_ms(plain) if plain_bytes <= PLAIN_TIMED_BYTES
                             else None),
                   library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
        torch.cuda.empty_cache()
    return row


def kd_cases(gen):
    """Timed at the train step's shape (the kernels line's row), in KD mode
    and at the tune step's vocabulary; the wgmma instance on ragged T, V
    and D; the general instance (V not a multiple of 8, rows too narrow
    for TMA, hs off alignment); f32; planted ties in each instance."""
    bf, f32 = torch.bfloat16, torch.float32
    return [kd_case(gen, 2048, 2048, 0, 32000, bf, timed=True),
            kd_case(gen, 2048, 2048, 1024, 32000, bf, tau=2.0, timed=True),
            kd_case(gen, 2048, 2048, 0, 151936, bf, timed=True),
            kd_case(gen, 130, 136, 0, 4104, bf),
            kd_case(gen, 2049, 256, 0, 32008, bf, cap_s=15.0),
            kd_case(gen, 130, 136, 72, 4104, bf, tau=0.5, cap_t=20.0),
            kd_case(gen, 2049, 136, 200, 32008, bf, tau=2.0, cap_s=30.0),
            kd_case(gen, 256, 256, 128, 4099, bf, tau=2.0, inst="general"),
            kd_case(gen, 200, 40, 0, 777, bf, cap_s=15.0, inst="general"),
            kd_case(gen, 64, 136, 72, 129, bf, tau=0.5, cap_t=20.0,
                    inst="general"),
            kd_case(gen, 130, 136, 0, 4104, bf, misalign=True,
                    inst="general"),
            kd_case(gen, 130, 96, 0, 1000, f32),
            kd_case(gen, 77, 64, 48, 333, f32, tau=2.0, cap_s=30.0,
                    cap_t=50.0),
            kd_case(gen, 96, 96, 0, 5000, bf, ties=True),
            kd_case(gen, 256, 256, 0, 32000, bf, ties=True),
            kd_case(gen, 256, 256, 64, 16000, bf, tau=2.0, ties=True),
            kd_case(gen, 256, 256, 0, 32000, bf, ties=True, misalign=True,
                    inst="general"),
            kd_case(gen, 96, 96, 0, 5000, f32, ties=True)]


# the expert layer on the tune path: batch 4 x 1024 tokens of
# Qwen1.5-MoE-A2.7B, top-4 of 60 experts, moe_d_ff 1408, and the
# reference's capacity max(ceil(T*k/E)*2, 8) = 548 slots per expert
MOE_T, MOE_K, MOE_E, MOE_D, MOE_F = 4096, 4, 60, 2048, 1408
MOE_CAP = max(-(-MOE_T * MOE_K // MOE_E) * 2, 8)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _library_gmm(plain):
    """One PyTorch call computing the same product(s) as ``plain`` [(a,
    b), ...] (two products as one bmm over K concatenated): where both
    operands are bf16, torch.bmm with f32 sums and an f32 output
    (``out_dtype``); else f32 torch.bmm on f32 copies (TF32 off).
    Returns (the call, its description)."""
    a = torch.cat([p[0] for p in plain], 2)
    b = torch.cat([p[1] for p in plain], 1)
    if a.dtype == b.dtype == torch.bfloat16:
        return (lambda: torch.bmm(a, b, out_dtype=torch.float32),
                "torch.bmm(bf16, bf16, out_dtype=float32)")
    af, bf_ = a.float(), b.float()
    return (lambda: torch.bmm(af, bf_)), "torch.bmm(float32)"


def gmm_case(gen, E, M, K, N, *, inst, ta=False, tb=False, da=torch.float32,
             db=torch.float32, dc=torch.float32, split=None, two=False,
             off=None, label="", timed=False):
    """The grouped-matmul kernel against its plain version on the f32
    values (bmm of f32 casts).  A ~N(0,1), B ~N(0,1/K), so outputs are
    O(1).  ``ta``/``tb`` hand the kernel transposed views, as the
    backward does; ``split`` ("a" or "b") hands it that f32 operand as
    the two bf16 terms of ``ops.split_f32`` (made on the card, not
    timed), as the backward does; ``two`` adds a second product of the
    same kind into the sum (dx); ``off`` ("a" or "b") makes that operand
    a view one element into its storage (off TMA's 16-byte alignment).
    Fails unless the launch takes instance ``inst`` and a second launch
    gives the same bits.  Timed: the bound is the f32 values' bytes (an
    f32 operand read once as f32) and the products at the bf16 tensor-core
    rate, the least the card can take for an f32-accurate product of a
    bf16 operand."""
    from repro_torch.kernels.moe_gemm import ops, ref

    def draw(shape, scale, dtype, misalign):
        n = math.prod(shape) + misalign
        t = (torch.randn(n, generator=gen, device="cuda") * scale).to(dtype)
        return t[misalign:].view(shape)

    def split_view(t, transposed):
        if not transposed:
            return ops.split_f32(t)
        return ops.split_f32(t.transpose(1, 2)).transpose(1, 2)

    pairs, plain = [], []
    for _ in range(2 if two else 1):
        a = draw((E, K, M) if ta else (E, M, K), 1.0, da, int(off == "a"))
        b = draw((E, N, K) if tb else (E, K, N), K ** -0.5, db,
                 int(off == "b"))
        a = a.transpose(1, 2) if ta else a
        b = b.transpose(1, 2) if tb else b
        plain.append((a, b))
        pairs.append((split_view(a, ta) if split == "a" else a,
                      split_view(b, tb) if split == "b" else b))
    plus = pairs[1] if two else None
    name = (f"grouped_matmul {label + ' ' if label else ''}E={E} M={M} "
            f"K={K} N={N} a={str(da)[6:]}{'^T' if ta else ''}"
            f"{' split' if split == 'a' else ''} "
            f"b={str(db)[6:]}{'^T' if tb else ''}"
            f"{' split' if split == 'b' else ''}{' x2' if two else ''} "
            f"out={str(dc)[6:]}{f' {off} misaligned' if off else ''}")
    got = ops.instance(*pairs[0], plus=plus)
    if got != inst:
        fail(f"{name}: takes the {got} instance, expected {inst}")

    def run():
        return ops.grouped_matmul(*pairs[0], out_dtype=dc, plus=plus)

    def plain_run():
        return ref.grouped_matmul_ref(*plain[0], dc,
                                      plain[1] if two else None)
    n0 = dict(ops.LAUNCHES_BY_INSTANCE)
    out = run()
    n0[inst] += 1
    if ops.LAUNCHES_BY_INSTANCE != n0:
        fail(f"{name}: launches by instance {ops.LAUNCHES_BY_INSTANCE}, "
             f"expected {n0}")
    want = plain_run()
    torch.cuda.synchronize()
    row = check_close(name, out, want)
    _check_repeat(name, out, run)
    row["instance"] = inst
    if timed:
        library, row["library"] = _library_gmm(plain)
        row.update(ms=time_ms(run), plain_ms=time_ms(plain_run),
                   library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(
            sum(_nbytes(x, y) for x, y in plain) + _nbytes(out),
            2 * E * M * N * K * len(plain), torch.bfloat16)
    return row


def split_case(gen, shape, *, timed=False):
    """The split pass against its plain version, both terms bit for bit,
    on values spanning 2^-40 .. 2^40; a second launch equal."""
    from repro_torch.kernels.moe_gemm import ops, ref
    t = torch.randn(shape, generator=gen, device="cuda") * torch.exp2(
        torch.randint(-40, 40, shape, generator=gen, device="cuda").float())
    got = ops.split_f32(t)
    want = ref.split_f32_ref(t)
    torch.cuda.synchronize()
    name = f"split_f32 {'x'.join(map(str, shape))}"
    if not (torch.equal(got.hi, want.hi) and torch.equal(got.lo, want.lo)):
        fail(f"{name}: the bf16 terms differ from the plain version's")
    again = ops.split_f32(t)
    if not (torch.equal(got.hi, again.hi) and torch.equal(got.lo, again.lo)):
        fail(f"{name}: a second launch on the same inputs differs")
    row = {"case": name, "max_abs_err": 0.0, "err_over_limit": 0.0,
           "equal_to_plain": True}
    if timed:
        row.update(ms=time_ms(lambda: ops.split_f32(t)),
                   plain_ms=time_ms(lambda: ref.split_f32_ref(t)),
                   library_ms=None)
        # t read once, both bf16 terms written once
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(t) + _nbytes(got.hi, got.lo), 0, torch.float32)
    return row


def ffn_case(gen, E, C, D, Fh, dtype, *, act="silu", off=None,
             timed=False):
    """The grouped-FFN kernel (both stages) against its plain version.
    ``off`` names an input made a contiguous view one element into its
    storage (off 16-byte alignment: the kernel loads it element-wise)."""
    from repro_torch.kernels.moe_gemm import ops, ref

    def draw(name, shape, scale):
        n = math.prod(shape) + (name == off)
        t = (torch.randn(n, generator=gen, device="cuda") * scale).to(dtype)
        return t[int(name == off):].view(shape)
    x = draw("x", (E, C, D), 1.0)
    wg, wu = (draw(n, (E, D, Fh), D ** -0.5) for n in ("wg", "wu"))
    wo = draw("wo", (E, Fh, D), Fh ** -0.5)
    out = ops.grouped_ffn_fwd(x, wg, wu, wo, act=act)
    want = ref.grouped_ffn_ref(x, wg, wu, wo, act=act)
    torch.cuda.synchronize()
    row = check_close(f"grouped_ffn E={E} C={C} D={D} F={Fh} "
                      f"{str(dtype)[6:]} {act}"
                      + (f" {off} misaligned" if off else ""), out, want)
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


# dscale (the routing weights' gradient, fused into the combine
# backward's launch) against .sum(-1) of the same f32 products, relative
# to sum |a_i b_i|: the kernel adds a lane's D/32 products in order, then
# a five-level shuffle tree, so each order's rounding is at most about
# (D/32 + 5) f32 half-ulps of sum |a_i b_i| (3.3e-6 at D 2048) and the
# two orders' difference under twice that.  It must also equal its own
# order's plain version (``ops.dscale_in_kernel_order``) bit for bit.
DSCALE_REL = 1e-5


def _routing(gen, T, E, k, bias):
    """Softmax-top-k routing from random logits, ``bias`` added to expert
    0 (a drop case), with the reference's capacity and ``moe_ffn``'s two
    shared layouts."""
    from repro_torch.kernels.moe_dispatch import ops
    logits = torch.randn((T, E), generator=gen, device="cuda")
    logits[:, 0] += bias
    w, idx = torch.softmax(logits, -1).topk(k, -1)
    w = w / w.sum(-1, keepdim=True)
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device="cuda") // k
    pos, keep = ops.capacity_positions(flat_e, cap)
    slot = flat_e * cap + pos
    by_slot, by_token = ops.routing_layouts(flat_tok, slot, keep, E * cap, T,
                                            k=k)
    return {"cap": cap, "keep": keep, "wk": torch.where(keep, w.reshape(-1),
                                                        0.0),
            "by_slot": by_slot, "by_token": by_token}


# the four movements of a routed layer: (source rows, destination layout,
# scale, whether the scale's gradient is fused in)
GSA_MOVES = {"dispatch": ("by_token", "by_slot", "keep", False),
             "combine": ("by_slot", "by_token", "wk", False),
             "dispatch_bwd": ("by_slot", "by_token", "keep", False),
             "combine_bwd": ("by_token", "by_slot", "wk", True)}


def gsa_case(gen, move, T, E, k, D, dtype, *, bias=0.0, off=False,
             inst="vec", timed=False):
    """One of the four movements (``GSA_MOVES``) of kernel 6 on softmax-
    top-k routing from random logits, through ``moe_ffn``'s shared
    layouts.  Fails unless it takes instance ``inst``, equals the plain
    version on the CPU (which adds rows in order, as the kernel does) bit
    for bit, and a second launch gives the same bits; held also to the
    plain version on the card (``index_add_``, atomics) by the bf16 rule.
    A backward movement reads its gradient in bf16 and must equal the
    same movement of an f32 copy, then cast, bit for bit; the combine's
    backward also computes dscale in the same launch, which must equal
    its order's plain version bit for bit and .sum(-1) within
    DSCALE_REL.  ``off``: the source one element off 16-byte alignment.
    Timed: the kernel, the plain version (with the dot's .sum(-1)), one
    ``index_add_`` (with ``torch.einsum`` for dscale) and the bound: each
    source row an entry names read once (and the dot's rows), every
    output row written once, 12 bytes an entry (4 more for dscale)."""
    from repro_torch.kernels.moe_dispatch import ops, ref
    r = _routing(gen, T, E, k, bias)
    src_key, dst_key, scale_key, with_dot = GSA_MOVES[move]
    src_lay, dst, scale = r[src_key], r[dst_key], r[scale_key]
    scale = scale.float() if scale_key == "keep" else scale
    n = src_lay.n * D + int(off)
    src = torch.randn(n, generator=gen, device="cuda").to(dtype)[
        int(off):].view(src_lay.n, D)
    dot_src = _randn(gen, (dst.n, D), dtype) if with_dot else None
    name = (f"gather_scatter_add {move} T={T} E={E} k={k} cap={r['cap']} "
            f"D={D} {str(dtype)[6:]} bias={bias}"
            f"{' misaligned' if off else ''}")
    got = ops.instance(src, dot_src=dot_src)
    if got != inst:
        fail(f"{name}: takes the {got} instance, expected {inst}")

    def run():
        return ops.move(src, scale, src_lay, dst, dot_src=dot_src)

    def plain():
        out = ref.gather_scatter_add_ref(src, src_lay.ids, dst.ids, scale,
                                         dst.n)
        if with_dot:
            return out, (dot_src[dst.ids.long()].float()
                         * src[src_lay.ids.long()].float()).sum(-1)
        return out, None
    n0 = dict(ops.LAUNCHES_BY_INSTANCE)
    out, dscale = run()
    n0[inst] += 1
    if ops.LAUNCHES_BY_INSTANCE != n0:
        fail(f"{name}: launches by instance {ops.LAUNCHES_BY_INSTANCE}, "
             f"expected {n0}")
    want, want_dscale = plain()
    torch.cuda.synchronize()
    row = check_close(name, out, want)
    cpu = ref.gather_scatter_add_ref(src.cpu(), src_lay.ids.cpu(),
                                     dst.ids.cpu(), scale.cpu(), dst.n)
    if not torch.equal(out.cpu(), cpu):
        fail(f"{name}: differs from the in-order sum of the plain version "
             f"on the CPU")
    again, dscale_again = run()
    if not torch.equal(out, again) or (
            with_dot and not torch.equal(dscale, dscale_again)):
        fail(f"{name}: a second launch on the same inputs differs")
    if move.endswith("_bwd"):
        f32, _ = ops.move(src.float(), scale, src_lay, dst)
        if not torch.equal(out, f32.to(dtype)):
            fail(f"{name}: differs from the f32 path then cast")
        row["equal_to_f32_then_cast"] = True
    if with_dot:
        a = dot_src[dst.ids.long()]
        b = src[src_lay.ids.long()]
        if got == "vec" and not torch.equal(
                dscale, ops.dscale_in_kernel_order(a, b)):
            fail(f"{name}: dscale differs from its order's plain version")
        rel = ((dscale - want_dscale).abs()
               / (a.float() * b.float()).abs().sum(-1)).max().item()
        if not rel <= DSCALE_REL:
            fail(f"{name}: dscale {rel:.3g} of sum |ab| from .sum(-1), "
                 f"limit {DSCALE_REL}")
        row["dscale_rel_err"] = rel
    seg0 = int((r["by_slot"].ids == 0).sum())
    row.update(instance=got, dropped=int((~r["keep"]).sum()),
               rows=int(src_lay.ids.numel()), slot0_segment=seg0,
               equal_to_cpu_in_order=True, repeat_bit_identical=True)
    if bias and not row["dropped"]:
        fail(f"{name}: the drop case dropped nothing")
    if timed:
        used = int(torch.unique(src_lay.ids).numel())
        nbytes = ((used + dst.n) * D * src.element_size()
                  + 12 * src_lay.ids.numel())
        rows_s, rows_d = src_lay.ids.long(), dst.ids.long()
        if with_dot:
            nbytes += (int(torch.unique(dst.ids).numel()) * D
                       * src.element_size() + 4 * src_lay.ids.numel())

        def library():  # index_add_ (and an einsum for dscale)
            out = torch.zeros((dst.n, D), dtype=dtype, device="cuda"
                              ).index_add_(0, rows_d, src[rows_s]
                                           * scale[:, None].to(dtype))
            if with_dot:
                return out, torch.einsum("rd,rd->r",
                                         dot_src[rows_d].float(),
                                         src[rows_s].float())
            return out

        row.update(ms=time_ms(run), plain_ms=time_ms(plain),
                   library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 0, dtype)
    return row


def moe_cases(gen):
    """Kernels 4-6 (and kernel 5's split pass) at the tune path's shapes
    (timed), and edge cases."""
    bf, f32 = torch.bfloat16, torch.float32
    E, C, D, Fh = MOE_E, MOE_CAP, MOE_D, MOE_F
    # edges of the bf16 tensor-core instance: C = 1, ragged C and F, F
    # not a multiple of 32, D or F not a multiple of 8 and F odd (the
    # element-wise loads and stores), misaligned x and wo
    ffn = [ffn_case(gen, E, C, D, Fh, bf, timed=True),
           ffn_case(gen, 3, 70, 96, 200, bf, act="gelu"),
           ffn_case(gen, 2, 130, 100, 136, bf),
           ffn_case(gen, 3, 33, 64, 72, f32, act="gelu"),
           ffn_case(gen, 2, 1, 256, 200, bf),
           ffn_case(gen, 2, 33, 64, 90, bf),
           ffn_case(gen, 2, 33, 72, 45, bf, act="gelu"),
           ffn_case(gen, 2, 130, 256, 200, bf, off="x"),
           ffn_case(gen, 2, 130, 256, 200, bf, act="gelu", off="wo")]
    # the backward's seven launches at the path's shapes, as it forms
    # them (bf16 model; dg, du and h split on the card), then each
    # instance's edges: ragged M, N and K, K below one 64-deep chunk, odd
    # N, one expert, bf16 out, misaligned operands (general), f32
    gmm = [gmm_case(gen, E, C, D, Fh, da=bf, db=bf, inst="wgmma",
                    label="x@wg", timed=True),
           gmm_case(gen, E, C, D, Fh, tb=True, da=bf, db=bf, inst="wgmma",
                    label="dy@wo^T", timed=True),
           gmm_case(gen, E, C, Fh, D, tb=True, da=f32, db=bf, dc=bf,
                    split="a", two=True, inst="wgmma_split",
                    label="dg@wg^T+du@wu^T", timed=True),
           gmm_case(gen, E, D, C, Fh, ta=True, da=bf, db=f32, dc=bf,
                    split="b", inst="wgmma_split", label="x^T@dg",
                    timed=True),
           gmm_case(gen, E, Fh, C, D, ta=True, da=f32, db=bf, dc=bf,
                    split="a", inst="wgmma_split", label="h^T@dy",
                    timed=True),
           gmm_case(gen, 3, 130, 136, 69, tb=True, da=bf, db=bf, dc=bf,
                    inst="wgmma"),
           gmm_case(gen, 3, 136, 37, 200, ta=True, da=bf, db=bf,
                    inst="wgmma"),
           gmm_case(gen, 2, 72, 136, 130, ta=True, tb=True, da=bf, db=bf,
                    dc=bf, two=True, inst="wgmma"),
           gmm_case(gen, 2, 130, 136, 264, tb=True, da=f32, db=bf,
                    split="a", two=True, inst="wgmma_split"),
           gmm_case(gen, 3, 200, 100, 136, ta=True, da=bf, db=f32,
                    split="b", inst="wgmma_split"),
           gmm_case(gen, 3, 136, 37, 200, ta=True, da=f32, db=bf,
                    split="a", inst="wgmma_split"),
           gmm_case(gen, 1, 130, 72, 200, da=f32, db=bf, dc=bf, split="a",
                    inst="wgmma_split"),
           gmm_case(gen, 2, 130, 136, 200, da=bf, db=bf, off="a",
                    inst="general"),
           gmm_case(gen, 2, 130, 136, 200, da=f32, db=bf, split="a",
                    off="b", two=True, inst="general"),
           gmm_case(gen, 3, 130, 37, 70, ta=True, tb=True, da=f32, db=bf,
                    dc=bf, inst="general"),
           gmm_case(gen, 3, 130, 37, 70, ta=True, da=f32, db=f32, two=True,
                    inst="f32")]
    split = [split_case(gen, (E, C, Fh), timed=True),
             split_case(gen, (3, 130, 37))]
    return ffn, gmm, split, gsa_cases(gen)


def gsa_cases(gen):
    """Kernel 6's four movements at the tune path's shapes (the dispatch
    forward first: the kernels line's row), timed; the bias-4.0 drop case
    (slot 0's segment 1 + drops long), timed; f32 (three passes); and the
    general instance: bf16 D 2100 and a misaligned source."""
    bf, f32 = torch.bfloat16, torch.float32
    T, E, k, D = MOE_T, MOE_E, MOE_K, MOE_D
    gsa = [gsa_case(gen, m, T, E, k, D, bf, timed=True) for m in GSA_MOVES]
    gsa += [gsa_case(gen, m, T, E, k, D, bf, bias=4.0, timed=True)
            for m in ("dispatch", "combine_bwd")]
    gsa += [gsa_case(gen, m, 300, 8, 2, 2100, f32, bias=3.0)
            for m in ("combine", "combine_bwd")]
    gsa += [gsa_case(gen, m, 300, 8, 2, 2100, bf, bias=3.0, inst="general")
            for m in ("dispatch", "combine_bwd")]
    gsa += [gsa_case(gen, "dispatch", 300, 8, 2, 256, bf, bias=3.0, off=True,
                     inst="general")]
    return gsa


# SSD scan outputs: bf16 y within two bf16 ulps of the case's largest |y|
# (kernel and plain version both round once from f32), and each element
# within check_close's rule (two bf16 ulps of itself + 1e-4): the tc
# instance carries W, h_in and B∘w as two bf16 terms each, and one term
# breaks that rule 28-58x where the largest-|y| rule lets it through
# (tests/test_torch_ssd_numerics.py).  f32 y and the
# final state (f32 in every case): sums and the in-chunk cumsum run in
# other orders, so a limit relative to the case's largest value.
# Readings on an H100 (700 W): y 7.2e-6 of the largest |y| (f32, fast
# decay, path shape with h0), final states 4.6e-6.  Limit about 3x that.
SSD_F32_REL = 2e-5
SSD_FAR = 64          # "far" pairs: more than 64 rows (a quarter chunk) apart
SSD_MIN_SHARE = 0.10  # each term a slow-decay case must show


def _ssd_inputs(gen, B, S, H, P, N, G, dtype, with_h0, slow, pad=0):
    """x, B, C ~ N(0,1) (B/C x 0.3), views of one (B, S, H*P + 2*G*N +
    pad) conv output as the model passes them; fast decay as the
    reference's init (A = -1, dt = softplus(N(0,1)), about 0.75 a row),
    or slow decay (dt * |A| <= 0.01: exp(cum) over a 256-row chunk >=
    e^-2.56)."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    conv = rnd(B, S, H * P + 2 * G * N + pad)
    conv[..., H * P:] *= 0.3
    conv = conv.to(dtype)
    x = conv[..., :H * P].reshape(B, S, H, P)
    b = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
    c = conv[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    if slow:
        dt = 0.02 + 0.08 * torch.rand((B, S, H), generator=gen, device="cuda")
        A = -(0.02 + 0.08 * torch.rand((H,), generator=gen, device="cuda"))
    else:
        dt = F.softplus(rnd(B, S, H))
        A = -torch.ones(H, device="cuda")
    h0 = 0.5 * rnd(B, H, P, N) if with_h0 else None
    return x, dt, A, b, c, h0


def ssd_bound_ms(B, S, H, P, N, G, Q, dtype, with_h0):
    """Least time for the scan on these shapes: per chunk of Qc rows the
    causal triangle of C·Bᵀ and of (C·Bᵀ∘L)(x∘dt), the carried-state
    term where a state enters (chunks after the first, or h0), and the
    state update, every product counted once at the rate of the inputs'
    dtype (bf16: the tensor cores; an f32 operand the bf16 kernel carries
    as two bf16 terms is not credited twice, as grouped_matmul's bound);
    bytes: each input read once (B/C once per group), y and the final
    state written once."""
    xs = torch.finfo(dtype).bits // 8
    cb = wx = inter = upd = 0.0
    for c in range(-(-S // Q)):
        qc = min(Q, S - c * Q)
        pairs = qc * (qc + 1) / 2
        cb += 2 * N * pairs
        wx += 2 * P * pairs
        if c > 0 or with_h0:
            inter += 2 * qc * N * P
        upd += 2 * qc * N * P
    flops = B * H * (cb + wx + inter + upd)
    nbytes = (2 * B * S * H * P * xs + B * S * H * 4 + H * 4
              + 2 * B * S * G * N * xs
              + B * H * P * N * 4 * (2 if with_h0 else 1))
    ms, by = bound_ms(nbytes, flops, dtype)
    return ms, by, flops / 1e9


def ssd_case(gen, B, S, H, P, N, G, dtype, *, inst, chunk=256,
             with_h0=False, slow=False, timed=False, views=True):
    """The SSD scan kernel against its plain version, y and the final
    state, launched twice (bit-identical) in the instance ``inst`` (which
    ``ops.instance`` must pick).  x, B and C are views of one conv output
    as the model passes them (``views``), or, with ``views=False``, of
    one a column wider, whose odd row stride only the CUDA-core kernel
    takes.  A slow-decay case also reports, from the plain version, the
    share of the intra-chunk term from pairs more than SSD_FAR rows (at
    most a quarter of the chunk) apart, and the carried-state term's
    share of |y| over the chunks after the first (with h0, also over the
    first chunk), and fails if one is under SSD_MIN_SHARE: so the check
    can see each term."""
    from repro_torch.kernels.ssd_scan import ops, ref
    x, dt, A, b, c, h0 = _ssd_inputs(gen, B, S, H, P, N, G, dtype, with_h0,
                                     slow, pad=0 if views else 1)
    kw = dict(chunk=chunk, init_state=h0)
    name = (f"ssd_scan B={B} S={S} H={H} P={P} N={N} G={G} chunk={chunk} "
            f"{str(dtype)[6:]} h0={with_h0} {'slow' if slow else 'fast'} "
            f"decay")
    picked = ops.instance(x, b, c)
    if picked != inst:
        fail(f"{name}: ops.instance picks {picked}, expected {inst}")
    n0 = dict(ops.LAUNCHES_BY_INSTANCE)
    y, h = ops.ssd(x, dt, A, b, c, **kw)
    y2, h2 = ops.ssd(x, dt, A, b, c, **kw)
    wy, wh = ref.ssd_scan_ref(x, dt, A, b, c, **kw)
    torch.cuda.synchronize()
    if ops.LAUNCHES_BY_INSTANCE[inst] != n0[inst] + 2:
        fail(f"{name}: launches by instance {ops.LAUNCHES_BY_INSTANCE}, "
             f"before {n0}: not two in {inst}")
    if not (torch.equal(y, y2) and torch.equal(h, h2)):
        fail(f"{name}: a second launch gave other bits")
    err_y = (y.float() - wy.float()).abs().max().item()
    max_y = wy.float().abs().max().item()
    if dtype == torch.float32:
        lim_y = SSD_F32_REL * max_y
    else:
        ulp = math.ldexp(torch.finfo(dtype).eps, math.frexp(max_y)[1] - 1)
        lim_y = 2 * ulp
    err_h = (h - wh).abs().max().item()
    lim_h = SSD_F32_REL * wh.abs().max().item()
    row = {"case": name, "instance": inst, "max_abs_err": err_y,
           "limit": lim_y, "max_abs_want": max_y, "state_max_abs_err": err_h,
           "state_limit": lim_h, "repeat_bit_identical": True}
    if not (torch.isfinite(y.float()).all() and torch.isfinite(h).all()) \
            or not (err_y <= lim_y and err_h <= lim_h):
        fail(f"{name}: y error {err_y} (limit {lim_y}), state error {err_h} "
             f"(limit {lim_h})")
    if dtype != torch.float32:   # and each element by check_close's rule
        row["err_over_limit"] = check_close(name, y, wy)["err_over_limit"]
    if slow:
        Q = min(chunk, S)
        near, far, inter = ref.ssd_terms(x, dt, A, b, c,
                                         far=min(SSD_FAR, Q // 4), **kw)
        intra = near.abs() + far.abs()
        tot = intra + inter.abs()
        shares = {"far_pair_share": (far.abs().sum() / intra.sum()).item()}
        if S > Q:
            shares["carried_share_after_first_chunk"] = (
                inter[:, Q:].abs().sum() / tot[:, Q:].sum()).item()
        if with_h0:
            shares["h0_share_first_chunk"] = (
                inter[:, :Q].abs().sum() / tot[:, :Q].sum()).item()
        row.update(shares)
        low = {k: v for k, v in shares.items() if not v >= SSD_MIN_SHARE}
        if low:
            fail(f"{name}: a slow-decay case shows too little of a term "
                 f"{low} (< {SSD_MIN_SHARE}): the check would not see it")
    if timed:
        row.update(ms=time_ms(lambda: ops.ssd(x, dt, A, b, c, **kw)),
                   plain_ms=time_ms(lambda: ref.ssd_scan_ref(x, dt, A, b, c,
                                                             **kw)),
                   library_ms=None)
        row["bound_ms"], row["bound_by"], row["gflop"] = ssd_bound_ms(
            B, S, H, P, N, G, min(chunk, S), dtype, with_h0)
    return row


def ssd_cases(gen):
    """Kernel 7 at the ssm serve path's shape (one 1024-token prompt of
    Mamba2-1.3B: B*H = 64, P 64, N 128, chunk 256, bf16, the tc
    instance; timed), a ragged prompt, two groups with h0, P 80 with N
    64 and an odd chunk (tc); the path's shape with an odd row stride, N
    200 (general); f32; each case also with slow decay."""
    bf, f32 = torch.bfloat16, torch.float32
    rows = []
    for slow in (False, True):
        rows += [ssd_case(gen, 1, 1024, 64, 64, 128, 1, bf, slow=slow,
                          timed=not slow, inst="tc"),
                 ssd_case(gen, 1, 777, 64, 64, 128, 1, bf, slow=slow,
                          inst="tc"),
                 ssd_case(gen, 2, 300, 8, 64, 128, 2, bf, with_h0=True,
                          slow=slow, inst="tc"),
                 ssd_case(gen, 1, 200, 6, 80, 64, 3, bf, chunk=100,
                          with_h0=True, slow=slow, inst="tc"),
                 ssd_case(gen, 1, 1024, 64, 64, 128, 1, bf, slow=slow,
                          inst="general", views=False),
                 ssd_case(gen, 1, 200, 6, 80, 200, 3, bf, chunk=100,
                          with_h0=True, slow=slow, inst="general"),
                 ssd_case(gen, 1, 1024, 64, 64, 128, 1, f32, with_h0=True,
                          slow=slow, inst="f32"),
                 ssd_case(gen, 1, 200, 6, 80, 200, 3, f32, chunk=100,
                          with_h0=True, slow=slow, inst="f32")]
    from repro_torch.kernels.ssd_scan import ops
    print("ssd_scan tc dynamic shared bytes (chunk state, outputs) at "
          f"chunk 256, N 128: {ops.tc_smem_bytes(256, 128)}")
    print("ssd_scan library_ms: null -- no single PyTorch call computes the "
          "chunked scan (its plain version is einsum, cumsum and a loop "
          "over chunks)")
    return rows


# head dims beyond the serve/train/tune paths' 64 and 128 (and 32): those
# of the repository's other configs, gpt2-tiny and qwen-moe-tiny 16,
# llama-tiny 24, bloom-1.1b 96, zamba2-7b 112, gemma2-9b/paligemma 256
NEW_HEAD_DIMS = (16, 24, 96, 112, 256)


def head_dim_cases(gen):
    """Flash and paged (both branches) at every new head dim, bf16 and
    f32; one flash (gemma2-9b's heads, D 256) and one paged case
    (bloom-1.1b's, D 96) timed."""
    bf, f32 = torch.bfloat16, torch.float32
    flash, paged, quant = [], [], []
    for i, D in enumerate(NEW_HEAD_DIMS):
        dt = (bf, f32)[i % 2]
        flash += [flash_case(gen, 2, 150, 8, 2, D, dt, window=60),
                  flash_case(gen, 1, 97, 4, 4, D, (f32, bf)[i % 2],
                             softcap=30.0)]
        paged += [paged_case(gen, [3, 70, 130], 1, 8, 2, D, 16, dt),
                  paged_case(gen, [9, 40], 3, 4, 1, D, 8, (f32, bf)[i % 2],
                             window=20, softcap=30.0)]
        quant += [paged_quant_case(gen, [3, 70, 130], 1, 8, 2, D, 16, dt,
                                   ("int8", "fp8")[i % 2]),
                  paged_quant_case(gen, [9, 40], 3, 4, 1, D, 8,
                                   (f32, bf)[i % 2], ("fp8", "int8")[i % 2],
                                   window=20, softcap=30.0)]
    flash.append(flash_case(gen, 1, 1024, 16, 8, 256, bf, timed=True))
    ctx = [int(c) for c in np.linspace(64, 1088, 8)]
    paged.append(paged_case(gen, ctx, 1, 16, 16, 96, 16, bf, timed=True))
    return flash, paged, quant


# every head dim the flash kernel is built for (csrc/flash_attention.cu)
FLASH_HEAD_DIMS = (16, 24, 32, 64, 96, 112, 128, 256)


def flash_bf16_cases(gen):
    """The bf16 kernel (tensor cores, split P) at every head dim: a window
    over GQA 1 and a softcap over GQA 2, both at a ragged S; S < 64 over
    GQA 8; S = 1; a ragged S over GQA 8 with window and softcap."""
    bf = torch.bfloat16
    rows = []
    for D in FLASH_HEAD_DIMS:
        rows += [flash_case(gen, 1, 200, 8, 8, D, bf, window=50),
                 flash_case(gen, 2, 97, 8, 4, D, bf, softcap=30.0),
                 flash_case(gen, 1, 47, 8, 1, D, bf),
                 flash_case(gen, 2, 1, 4, 4, D, bf),
                 flash_case(gen, 1, 300, 16, 2, D, bf, window=100,
                            softcap=50.0)]
    return rows


# a context where the paged kernel's bytes, not its launch, should set
# its time (timed, not the kernels line's row)
LONG_CTX = 4096


def quant_cases(gen):
    """The dequant branch at the serve path's shape (8 slots, ctx
    64-1088, H 32 over KH 4, D 64, block_len 16, bf16 out; timed), C = 4,
    GQA with window and softcap in f32, and D = 24, whose int8/fp8 rows
    (24 bytes) take 8-byte loads; int8 and fp8 each; int8 timed at 8
    slots x ctx LONG_CTX."""
    bf, f32 = torch.bfloat16, torch.float32
    ctx = [int(c) for c in np.linspace(64, 1088, 8)]
    rows = []
    for kv in ("int8", "fp8"):
        rows += [paged_quant_case(gen, ctx, 1, 32, 4, 64, 16, bf, kv,
                                  timed=True),
                 paged_quant_case(gen, ctx, 4, 32, 4, 64, 16, bf, kv),
                 paged_quant_case(gen, [5, 40, 17], 3, 8, 2, 64, 4, f32, kv,
                                  window=12, softcap=30.0),
                 paged_quant_case(gen, [1, 70, 33], 1, 8, 2, 24, 16, bf, kv),
                 paged_quant_case(gen, [9, 130], 2, 6, 3, 24, 8, f32, kv,
                                  window=50)]
    # where bytes matter: 8 slots x ctx 4096
    rows.append(paged_quant_case(gen, [LONG_CTX] * 8, 1, 32, 4, 64, 16, bf,
                                 "int8", timed=True))
    return rows


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    # serve/prefill shape first (the kernels line's row), then the train
    # step's (TinyLlama, batch 4) and the tune step's (Qwen1.5-MoE heads)
    flash = [flash_case(gen, 1, 1024, 32, 4, 64, bf, timed=True),
             flash_case(gen, 4, 1024, 32, 4, 64, bf, timed=True),
             flash_case(gen, 4, 1024, 16, 16, 128, bf, timed=True),
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
             paged_case(gen, [1, 200], 1, 4, 4, 128, 16, f32),
             paged_case(gen, [LONG_CTX] * 8, 1, 32, 4, 64, 16, bf,
                        timed=True)]
    pq = quant_cases(gen)
    hd_flash, hd_paged, hd_quant = head_dim_cases(gen)
    flash += flash_bf16_cases(gen)
    kd = kd_cases(gen)
    ffn, gmm, split, gsa = moe_cases(gen)
    ssd = ssd_cases(gen)
    for row in (flash + paged + pq + hd_flash + hd_paged + hd_quant + kd
                + ffn + gmm + split + gsa + ssd):
        print("kernel " + json.dumps(row))
    return {"flash_attention": flash[0], "paged_attn": paged[0],
            "paged_attn_quant": pq[0], "kd_loss": kd[0],
            "grouped_ffn": ffn[0],
            "grouped_matmul": gmm[0], "split_f32": split[0],
            "gather_scatter_add": gsa[0],
            "ssd_scan": ssd[0]}


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
    cache = M.init_paged_cache(cfg, 1, n_blocks, bl, device="cuda")
    sub = M.prefill_into_cache(
        cfg, M.init_decode_cache(cfg, 1, n_pb * bl, device="cuda"), pc)
    ids = list(range(1, n_pb + 1))
    M.scatter_prefill_paged(cfg, cache, sub, 0, ids, [True] * n_pb,
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

    lens, prompts = _serve_prompts(cfg)
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
        torch.cuda.reset_peak_memory_stats()   # the timed run's own peak
        fa_ops.LAUNCHES = 0
        pa_ops.LAUNCHES = pa_ops.LAUNCHES_QUANT = 0
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"flash_attention": fa_ops.LAUNCHES,
                    "paged_attn": pa_ops.LAUNCHES,
                    "paged_attn_quant": pa_ops.LAUNCHES_QUANT}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

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
            "paged_attn": cfg.n_layers * steps, "paged_attn_quant": 0}
    if launches != want or steps <= 0:
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
           "peak_mem_gb": peak_gb}
    print("serve " + json.dumps(res))
    phase_profile(params, cfg, prompts[-1], make_engine, seg_len)
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


def decode_profile(eng, cfg, seg_len, what):
    """One steady decode segment of a started engine under the profiler,
    with the paged kernel's device time (failing if it reads zero) and
    the device launches a layer-step."""
    seg = profile(eng.step, top=12, groups={"paged_attn": ("paged_fwd",)})
    if not seg["group_ms"]["paged_attn"] > 0:
        fail(f"{what}: the profile shows no device time in the paged kernel")
    seg["launches_per_layer_step"] = seg["device_launches"] / (
        cfg.n_layers * seg_len)
    return seg


def phase_profile(params, cfg, prompt, make_engine, seg_len):
    """Where the time goes: one prefill of the longest prompt, and one
    steady decode segment with every slot live."""
    from repro_torch.models import model as M
    toks = torch.as_tensor(prompt, device="cuda")
    with torch.no_grad():
        pre = profile(lambda: M.prefill(params, cfg, {"tokens": toks}),
                      groups={"flash_fwd": ("flash_fwd",)})
        eng = make_engine()
        eng.step()        # admits the first 8 requests, runs a segment
        # no slot free: a decode segment only
        seg = decode_profile(eng, cfg, seg_len, "serve decode")
    print("profile " + json.dumps({"prefill_1024": pre,
                                   "decode_segment_8_steps": seg}))


# ---------------------------------------------------------------------------
# phase 5a: serve full-width TinyLlama-1.1B from a quantized (int8/fp8) KV pool
# ---------------------------------------------------------------------------

KV_QUANT = ("int8", "fp8")
KV_CHECK_STEPS = 8
# (i) decode logits of the quantized kernel path against the quantized
# gather path on the same pool (8 steps after a 1024-token prompt).  f32:
# both dequantize in f32 and differ in summation order only.  bf16: the
# gather path rounds the dequantized K/V to bf16, the kernel does not,
# and 22 layers of bf16 activations round at different points, as in the
# unquantized kernel-vs-plain check (LOGIT_TOL).  Readings on an H100
# (700 W): f32 1.20e-5 (int8) and 1.66e-5 (fp8), bf16 0.0518 and 0.0547
# (max |logit| 4.4); limits about 3x the largest.
KV_F32_PATH_TOL = 5e-5
KV_BF16_PATH_TOL = 0.16
# (ii) quantized against unquantized decode logits (bf16 model, kernel
# paths), relative RMS of the difference: what int8/fp8 storage costs.
# Readings on an H100 (700 W): int8 0.0147, fp8 0.0252; limits about 3x.
# A dropped scale puts K/V off by up to qmax/amax (read 0.85 and 0.87);
# the dropped-scale reading must exceed the limit KV_DROPPED_MARGIN-fold.
KV_REL_RMS_TOL = {"int8": 0.045, "fp8": 0.075}
KV_DROPPED_MARGIN = 3.0
# equal-bytes reading: the bf16 pool of this many blocks (one is the
# trash block) caps the bytes both runs may hold; 16 slots, so the pool
# and not the slots bounds how many requests are live
EQ_BF16_BLOCKS, EQ_SLOTS = 200, 16


def _serve_prompts(cfg):
    """The serve phase's traffic: 16 prompts of 128-1024 tokens (seed 0)."""
    rng = np.random.default_rng(0)
    lens = [int(p) for p in np.linspace(128, 1024, 16)]
    return lens, [rng.integers(0, cfg.vocab_size, (1, p)).astype(np.int32)
                  for p in lens]


def _kv_decode_logits(M, params, cfg, pc, P, feed, policy, *,
                      dropped=False):
    """Graft a P-token prefill cache ``pc`` into a fresh paged cache under
    ``policy`` (quantized once, at the graft), then decode ``feed`` one
    token a step through it: the (len(feed), V) logits.  ``dropped`` sets
    every scale of the prompt's rows to 1 (K/V read as raw codes)."""
    bl = 16
    n_pb = -(-P // bl)
    nbt = -(-(P + len(feed)) // bl)
    cache = M.init_paged_cache(cfg, 1, nbt + 1, bl, device="cuda",
                               policy=policy)
    sub = M.prefill_into_cache(
        cfg, M.init_decode_cache(cfg, 1, n_pb * bl, device="cuda"), pc)
    M.scatter_prefill_paged(cfg, cache, sub, 0, list(range(1, n_pb + 1)),
                            [True] * n_pb, block_len=bl)
    if dropped:
        for e in cache["blocks"].values():
            e["k_scale"].fill_(1.0)
            e["v_scale"].fill_(1.0)
    bt = torch.arange(1, nbt + 1, dtype=torch.int32, device="cuda")[None]
    out = []
    for j in range(len(feed)):
        logits, _ = M.decode_step(params, cfg, cache, feed[j].reshape(1, 1),
                                  torch.tensor([P + j], device="cuda"),
                                  block_tables=bt)
        out.append(logits[0])
    return torch.stack(out)


def kv_logit_readings(M, params, cfg, prompt):
    """On one 1024-token prompt and 8 teacher-forced decode steps, in the
    f32 model and in the bf16 one: (i) quantized kernel path against
    quantized gather path on the same pool; (ii) quantized against
    unquantized (kernel paths), and, bf16, with the scales dropped;
    (iii) greedy top-1 agreement with the unquantized path."""
    from repro_torch.models import quant
    from repro_torch.utils.pytree import tree_map
    toks = torch.as_tensor(prompt, device="cuda")
    P = toks.shape[1]
    feed = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, KV_CHECK_STEPS), dtype=torch.int32, device="cuda")
    res = {"prompt_len": P, "steps": KV_CHECK_STEPS}
    models = {"f32": (lambda: tree_map(lambda t: t.float(), params),
                      cfg.replace(dtype="float32")),
              "bf16": (lambda: params, cfg)}
    for tag, (get, c) in models.items():
        p = get()
        _, pc = M.prefill(p, c, {"tokens": toks})
        plain = c.replace(use_kernels=False)
        base = _kv_decode_logits(M, p, c, pc, P, feed, None)
        res[f"{tag}_max_abs_logit"] = base.abs().max().item()
        for kv in KV_QUANT:
            pol = quant.CachePolicy(kv)
            lk = _kv_decode_logits(M, p, c, pc, P, feed, pol)
            lg = _kv_decode_logits(M, p, plain, pc, P, feed, pol)
            res[f"{tag}_{kv}_kernel_vs_gather_max"] = (
                lk - lg).abs().max().item()
            res[f"{tag}_{kv}_kernel_vs_gather_rel_rms"] = _rel_rms(lk, lg)
            res[f"{tag}_{kv}_vs_unquantized_rel_rms"] = _rel_rms(lk, base)
            res[f"{tag}_{kv}_top1_agreement"] = (
                lk.argmax(-1) == base.argmax(-1)).float().mean().item()
            if tag == "bf16":
                ld = _kv_decode_logits(M, p, c, pc, P, feed, pol,
                                       dropped=True)
                res[f"bf16_{kv}_dropped_scale_rel_rms"] = _rel_rms(ld, base)
        del p, pc
        torch.cuda.empty_cache()
    print("serve_kv logits " + json.dumps(res))
    return res


def check_kv_logits(res):
    if not all(math.isfinite(v) for v in res.values()):
        fail(f"serve_kv logits: non-finite readings {res}")
    for kv in KV_QUANT:
        for tag, tol in (("f32", KV_F32_PATH_TOL),
                         ("bf16", KV_BF16_PATH_TOL)):
            d = res[f"{tag}_{kv}_kernel_vs_gather_max"]
            if d > tol:
                fail(f"serve_kv (i) {tag} {kv}: kernel-path logits differ "
                     f"from the gather path by {d} > {tol}")
        r = res[f"bf16_{kv}_vs_unquantized_rel_rms"]
        if r > KV_REL_RMS_TOL[kv]:
            fail(f"serve_kv (ii) {kv}: logits {r:.4f} relative RMS from "
                 f"the unquantized path (limit {KV_REL_RMS_TOL[kv]})")
        dr = res[f"bf16_{kv}_dropped_scale_rel_rms"]
        if not dr > KV_DROPPED_MARGIN * KV_REL_RMS_TOL[kv]:
            fail(f"serve_kv (ii) {kv}: dropping the scales moves the logits "
                 f"only {dr:.4f} relative RMS: the limit would not see it")


def equal_bytes_reading(M, params, cfg, prompts, max_new, bl, seg_len):
    """bf16 and int8 pools capped at the bytes of an EQ_BF16_BLOCKS-block
    bf16 pool, EQ_SLOTS slots: peak live requests and preemptions of
    each.  A reading, no limit."""
    from repro_torch.models import quant
    from repro_torch.serve import PagedServeEngine
    cap = M.paged_cache_nbytes(cfg, EQ_SLOTS, EQ_BF16_BLOCKS, bl)
    pol = quant.CachePolicy("int8")
    per_block = (M.paged_cache_nbytes(cfg, EQ_SLOTS, 2, bl, policy=pol)
                 - M.paged_cache_nbytes(cfg, EQ_SLOTS, 1, bl, policy=pol))
    out = {}
    for kv, nb in (("bf16", EQ_BF16_BLOCKS), ("int8", cap // per_block)):
        eng = PagedServeEngine(params, cfg, n_slots=EQ_SLOTS, block_len=bl,
                               seg_len=seg_len, n_blocks=nb,
                               max_len=max(p.shape[1] for p in prompts)
                               + max_new, kv_dtype="" if kv == "bf16" else kv,
                               device="cuda")
        for p in prompts:
            eng.submit({"tokens": p}, max_new=max_new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if sorted(comps) != list(range(len(prompts))) or any(
                len(c.tokens) != max_new for c in comps.values()):
            fail(f"equal-bytes {kv}: completions {sorted(comps)}")
        st = eng.stats
        out[kv] = {"n_blocks": nb, "pool_bytes": M.paged_cache_nbytes(
                       cfg, EQ_SLOTS, nb, bl, policy=eng.policy),
                   "peak_live_requests": st["peak_live_requests"],
                   "peak_live_blocks": st["peak_live_blocks"],
                   "preemptions": st["preemptions"],
                   "prefills": st["prefills"], "segments": st["segments"],
                   "wall_s": wall,
                   "tok_per_s": st["generated_tokens"] / wall}
    out["cap_bytes"] = cap
    print("serve_kv equal_bytes " + json.dumps(out))
    return out


def phase_serve_kv():
    """The serve phase's traffic and engine (8 slots, block_len 16,
    seg_len 8) with the KV pool in bf16, int8, fp8 and bf16 again, in
    turns in one phase, so the quantized runs are compared with bf16
    under the same conditions.  The quantized runs launch the dequant
    branch of the paged kernel 22 times a decode step and the
    unquantized branch never.  Reports tok/s, ms per decode step, TTFT,
    the pool's bytes, peak memory and agreement with the first bf16 run's
    tokens; then the logit checks, the equal-bytes reading and a profile
    of an int8 decode segment."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import model as M
    from repro_torch.models import quant
    from repro_torch.serve import PagedServeEngine

    cfg = get_config("tinyllama-1.1b", variant="full")
    torch.cuda.empty_cache()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    lens, prompts = _serve_prompts(cfg)
    max_new, n_slots, bl, seg_len = 64, 8, 16, 8
    runs = {}
    launches = {"paged_attn_quant": 0, "flash_attention": 0}
    with torch.no_grad():
        checks = kv_logit_readings(M, params, cfg, prompts[-1])
        check_kv_logits(checks)
        for name, kv in (("bf16_first", ""), ("int8", "int8"),
                         ("fp8", "fp8"), ("bf16_last", "")):
            eng = PagedServeEngine(params, cfg, n_slots=n_slots,
                                   block_len=bl, seg_len=seg_len,
                                   max_len=max(lens) + max_new,
                                   kv_dtype=kv, device="cuda")
            for p in prompts:
                eng.submit({"tokens": p}, max_new=max_new)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa_ops.LAUNCHES = 0
            pa_ops.LAUNCHES = pa_ops.LAUNCHES_QUANT = 0
            t0 = time.perf_counter()
            comps = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {"paged_attn_quant": pa_ops.LAUNCHES_QUANT,
                   "paged_attn": pa_ops.LAUNCHES,
                   "flash_attention": fa_ops.LAUNCHES}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            st = eng.stats
            if sorted(comps) != list(range(len(prompts))):
                fail(f"serve_kv {name}: completed {sorted(comps)}")
            for uid, c in comps.items():
                if len(c.tokens) != max_new or c.prompt_len != lens[uid] \
                        or (c.tokens < 0).any() \
                        or (c.tokens >= cfg.vocab_size).any():
                    fail(f"serve_kv {name} request {uid}: {c.tokens}")
            if eng.alloc.n_free != eng.n_blocks - 1 or eng._slot_blocks:
                fail(f"serve_kv {name}: allocator did not drain")
            steps = st["segments"] * seg_len
            paged = cfg.n_layers * steps
            want = {"paged_attn_quant": paged if kv else 0,
                    "paged_attn": 0 if kv else paged,
                    "flash_attention": cfg.n_layers * st["prefills"]}
            if got != want or steps <= 0:
                fail(f"serve_kv {name}: launches {got} != expected {want}")
            if kv:
                launches["paged_attn_quant"] += got["paged_attn_quant"]
                launches["flash_attention"] += got["flash_attention"]
            tokens = {u: c.tokens.tolist() for u, c in comps.items()}
            ref = runs.get("bf16_first", {}).get("tokens", tokens)
            # how long each request follows the first bf16 run's tokens
            prefix = [next((i for i, (a, b) in enumerate(zip(t, ref[u]))
                            if a != b), max_new) for u, t in tokens.items()]
            ttft = sorted(c.ttft_s for c in comps.values())
            runs[name] = {
                "tokens": tokens, "generated_tokens": st["generated_tokens"],
                "wall_s": wall, "tok_per_s": st["generated_tokens"] / wall,
                "decode_steps": steps,
                "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
                "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
                "pool_bytes": M.paged_cache_nbytes(
                    cfg, n_slots, eng.n_blocks, bl, policy=eng.policy),
                "peak_mem_gb": peak_gb, "launches": got,
                "requests_equal_to_bf16_first": sum(
                    n == max_new for n in prefix),
                "tokens_before_first_difference_mean":
                    sum(prefix) / len(prefix)}
        bf16_ms = (runs["bf16_first"]["ms_per_decode_step"]
                   + runs["bf16_last"]["ms_per_decode_step"]) / 2
        for name in KV_QUANT:
            runs[name]["ms_per_decode_step_over_bf16"] = (
                runs[name]["ms_per_decode_step"] / bf16_ms)
            runs[name]["pool_bytes_over_bf16"] = (
                runs[name]["pool_bytes"] / runs["bf16_first"]["pool_bytes"])
        for r in runs.values():
            del r["tokens"]
        eq = equal_bytes_reading(M, params, cfg, prompts, max_new, bl,
                                 seg_len)
        # where the time goes: one steady int8 decode segment, every slot
        # live, as the serve phase profiles the bf16 one
        eng = PagedServeEngine(params, cfg, n_slots=n_slots, block_len=bl,
                               seg_len=seg_len, max_len=max(lens) + max_new,
                               kv_dtype="int8", device="cuda")
        for p in prompts:
            eng.submit({"tokens": p}, max_new=max_new)
        eng.step()
        seg = decode_profile(eng, cfg, seg_len, "serve_kv int8 decode")
    print("serve_kv " + json.dumps({"runs": runs, "logit_checks": checks,
                                    "equal_bytes": eq}))
    print("profile " + json.dumps({"int8_decode_segment_8_steps": seg}))
    return launches


# ---------------------------------------------------------------------------
# phase 5b: serve full-width Mamba2-1.3B
# ---------------------------------------------------------------------------

# (i) the f32 model, kernel path against the same model with the kernel
# swapped for its plain version, all logits of a prompt (max |logit|
# about 5).  The in-chunk cumsum reaches about -190 over a 256-row chunk
# at the reference's init, so exp(cum[q] - cum[s]) carries about 1e-5
# relative rounding in any order, and 48 random layers amplify it.  Both
# paths' distances to the f32 model with the scan in f64 are reported
# beside it.  Readings on an H100 (700 W): 1.39e-3 and 1.55e-3 (1024-
# and 486-token prompts); the limit about 3x that.
SSM_F32_LOGIT_TOL = 4e-3
# (iii) prefill of all but the last 8 tokens then 8 decode steps, against
# one prefill, f32 kernel path.  Reading on an H100 (700 W): 3.1e-4; the
# limit about 3x that.
SSM_F32_DECODE_TOL = 1e-3
# (ii) the bf16 model against the f32 model's logits (plain version): the
# kernel path's RMS distance at most 1.5x the plain-version path's, so
# the limit is what bf16 itself costs, not a number on the logits' scale
SSM_BF16_RATIO = 1.5
SSM_DECODE_TAIL = 8


def _ssd_scan_f64(xh, dt, A, Bh, Ch, *, chunk, init_state=None):
    """The plain version computed in f64, y rounded to x's dtype."""
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    y, h = ssd_ref.ssd_scan_ref(
        xh.double(), dt.double(), A.double(), Bh.double(), Ch.double(),
        chunk=chunk,
        init_state=None if init_state is None else init_state.double())
    return y.to(xh.dtype), h.float()


def _ssm_logits(M, params, cfg, toks, plain=False):
    """Logits (S, V) f32 of every position of one prompt, through the
    kernel or, with ``plain``, through the kernel's plain version ("f64":
    the plain version in f64)."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref
    kernel = ssd_ops.ssd
    if plain:
        ssd_ops.ssd = (_ssd_scan_f64 if plain == "f64"
                       else ssd_ref.ssd_scan_ref)
    try:
        h, _, _ = M.backbone(params, cfg, {"tokens": toks})
    finally:
        ssd_ops.ssd = kernel
    return M._head(params, cfg, h)[0]


def _prefill_decode_logits(M, params, cfg, toks, n: int):
    """Prefill of all but the last ``n`` tokens, then ``n`` decode steps
    feeding them: the logits (n, V) of those positions."""
    S = toks.shape[1]
    logits, pc = M.prefill(params, cfg, {"tokens": toks[:, :S - n]})
    cache = M.prefill_into_cache(cfg, M.init_decode_cache(
        cfg, 1, S, device="cuda"), pc)
    out = [logits[0]]
    for j in range(S - n, S - 1):
        logits, cache = M.decode_step(params, cfg, cache, toks[:, j:j + 1],
                                      torch.tensor([j], device="cuda"))
        out.append(logits[0])
    return torch.stack(out)


def ssm_logit_readings(M, params, cfg, prompt):
    """(i) f32 kernel path against f32 plain-version path (and, reported,
    both against the scan in f64), (ii) bf16 kernel and plain-version
    paths against the f32 model, (iii) prefill then decode against one
    prefill."""
    from repro_torch.utils.pytree import tree_map
    toks = torch.as_tensor(prompt, device="cuda")
    S, n = toks.shape[1], SSM_DECODE_TAIL
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    k32 = _ssm_logits(M, p32, cfg32, toks, plain=False)
    q32 = _ssm_logits(M, p32, cfg32, toks, plain=True)
    o64 = _ssm_logits(M, p32, cfg32, toks, plain="f64")
    kb = _ssm_logits(M, params, cfg, toks, plain=False)
    qb = _ssm_logits(M, params, cfg, toks, plain=True)
    d32 = _prefill_decode_logits(M, p32, cfg32, toks, n)
    db = _prefill_decode_logits(M, params, cfg, toks, n)
    del p32

    def rms(a, b):
        return (a - b).pow(2).mean().sqrt().item()

    res = {"len": S, "max_abs_logit": q32.abs().max().item(),
           "f32_kernel_vs_plain": (k32 - q32).abs().max().item(),
           "f32_kernel_to_f64_scan": (k32 - o64).abs().max().item(),
           "f32_plain_to_f64_scan": (q32 - o64).abs().max().item(),
           "bf16_kernel_to_f32_rms": rms(kb, q32),
           "bf16_plain_to_f32_rms": rms(qb, q32),
           "bf16_kernel_to_f32_max": (kb - q32).abs().max().item(),
           "bf16_plain_to_f32_max": (qb - q32).abs().max().item(),
           "bf16_kernel_vs_plain_max": (kb - qb).abs().max().item(),
           "f32_prefill_decode_vs_prefill": (
               d32 - k32[S - n - 1:S - 1]).abs().max().item(),
           "bf16_prefill_decode_vs_prefill": (
               db - kb[S - n - 1:S - 1]).abs().max().item()}
    res["bf16_rms_ratio"] = (res["bf16_kernel_to_f32_rms"]
                             / res["bf16_plain_to_f32_rms"])
    print("ssm logits " + json.dumps(res))
    return res


def check_ssm_logits(res):
    """Holds one prompt's readings to the limits."""
    if not all(math.isfinite(v) for v in res.values()):
        fail(f"ssm logits: non-finite readings {res}")
    if res["f32_kernel_vs_plain"] > SSM_F32_LOGIT_TOL:
        fail(f"ssm (i): f32 kernel-path logits differ from the plain-version "
             f"path by {res['f32_kernel_vs_plain']} > {SSM_F32_LOGIT_TOL}")
    if res["bf16_rms_ratio"] > SSM_BF16_RATIO:
        fail(f"ssm (ii): bf16 kernel path is {res['bf16_rms_ratio']:.3f}x "
             f"as far from the f32 model as the plain-version path "
             f"(limit {SSM_BF16_RATIO})")
    if res["f32_prefill_decode_vs_prefill"] > SSM_F32_DECODE_TOL:
        fail(f"ssm (iii): prefill + decode logits differ from one prefill "
             f"by {res['f32_prefill_decode_vs_prefill']} > "
             f"{SSM_F32_DECODE_TOL}")


def _ssd_on_tensor_cores(by_instance, n):
    """Every scan launch of the serve_ssm run took the tc instance: the
    model's bf16 views of its conv output (row stride 4352 elements, B
    and C at byte offsets 8192 and 8448), none on the CUDA cores."""
    want = {"tc": n, "general": 0, "f32": 0}
    print(f"serve_ssm: ssd_scan launches by instance {by_instance}")
    if by_instance != want:
        fail(f"serve_ssm: ssd_scan launches by instance {by_instance}, "
             f"expected {want}")


def phase_serve_ssm():
    """Full-width, full-depth Mamba2-1.3B (bf16, random weights from seed
    0) behind ``PagedServeEngine`` with 8 slots: 16 greedy requests of
    128-1024 prompt tokens, 64 new tokens each, after a warm-up run.
    Checks the completions, the SSD kernel's launches on that run (48 per
    prefill, every one in the tc instance), the logit checks (i)-(iii) on
    two prompts, and profiles one 1024-token prefill and one decode
    segment."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine

    cfg = get_config("mamba2-1.3b", variant="full")
    if not cfg.use_kernels or M.has_paged_leaves(cfg):
        fail("mamba2 config: no kernels, or paged leaves")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in convert.flatten(params).values())
    print(f"serve_ssm: {cfg.name} {n_params / 1e9:.3f}B params {cfg.dtype}, "
          f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(1)
    lens = [int(p) for p in np.linspace(128, 1024, 16)]
    prompts = [rng.integers(0, cfg.vocab_size, (1, p)).astype(np.int32)
               for p in lens]
    max_new, n_slots, seg_len = 64, 8, 8

    with torch.no_grad():
        checks = [ssm_logit_readings(M, params, cfg, prompts[i])
                  for i in (15, 6)]
        for res in checks:
            check_ssm_logits(res)
        torch.cuda.empty_cache()

        def make_engine():
            eng = PagedServeEngine(params, cfg, n_slots=n_slots,
                                   seg_len=seg_len,
                                   max_len=max(lens) + max_new,
                                   device="cuda")
            for p in prompts:
                eng.submit({"tokens": p}, max_new=max_new)
            return eng

        make_engine().run()   # warm-up
        eng = make_engine()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ssd_ops.LAUNCHES = 0
        ssd_ops.LAUNCHES_BY_INSTANCE.update(dict.fromkeys(
            ssd_ops.LAUNCHES_BY_INSTANCE, 0))
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ssd_scan": ssd_ops.LAUNCHES}
        by_instance = dict(ssd_ops.LAUNCHES_BY_INSTANCE)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = eng.stats
    if sorted(comps) != list(range(len(prompts))):
        fail(f"ssm completed {sorted(comps)}")
    for uid, c in comps.items():
        if len(c.tokens) != max_new or c.prompt_len != lens[uid]:
            fail(f"ssm request {uid}: {len(c.tokens)} tokens, prompt "
                 f"{c.prompt_len}")
        if (c.tokens < 0).any() or (c.tokens >= cfg.vocab_size).any():
            fail(f"ssm request {uid}: token ids out of range")
    if st["fresh_blocks"] or st["preemptions"] or \
            eng.alloc.n_free != eng.n_blocks - 1:
        fail(f"ssm: the paged engine touched its block pool: {st}")
    want = {"ssd_scan": cfg.n_layers * st["prefills"]}
    if launches != want or st["prefills"] != len(prompts):
        fail(f"ssm launches {launches} != expected {want} "
             f"({st['prefills']} prefills)")
    _ssd_on_tensor_cores(by_instance, want["ssd_scan"])
    steps = st["segments"] * seg_len
    ttft = sorted(c.ttft_s for c in comps.values())
    res = {"requests": len(comps), "prompt_lens": lens,
           "generated_tokens": st["generated_tokens"], "wall_s": wall,
           "tok_per_s": st["generated_tokens"] / wall,
           "decode_steps": steps,
           "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
           "admit_s": st["admit_s"], "decode_s": st["decode_s"],
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "ttft_min_s": ttft[0], "prefills": st["prefills"],
           "launches": launches, "launches_by_instance": by_instance,
           "peak_mem_gb": peak_gb,
           "n_params": n_params, "logit_checks": checks}
    print("serve_ssm " + json.dumps(res))

    toks = torch.as_tensor(prompts[-1], device="cuda")
    groups = {"ssd_scan": ("ssd_chunk", "ssd_state"),
              "ssd_chunk_state": ("ssd_chunk_state",),
              "ssd_state_pass": ("ssd_state_pass",),
              "ssd_chunk_out": ("ssd_chunk_out",)}
    with torch.no_grad():
        pre = profile(lambda: M.prefill(params, cfg, {"tokens": toks}),
                      top=10, groups=groups)
        eng = make_engine()
        eng.step()        # admits the first 8 requests, runs a segment
        seg = profile(eng.step, top=10)  # no slot free: a decode segment
    print("ssd_scan per-launch split (device ms over the prefill's 48 "
          "layers): " + json.dumps({k: v for k, v in pre["group_ms"].items()
                                    if k != "ssd_scan"}))
    print("profile " + json.dumps({"ssm_prefill_1024": pre,
                                   "ssm_decode_segment_8_steps": seg}))
    return launches


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


def _flash_on_path(M, cfg, params, batch):
    """Every layer's flash attention on the real batch: q, k and v caught
    on their way into the kernel in a kernel-path forward, then the
    kernel's output held to the plain version's by ``check_close``.  The
    loss check sees the kernel's error only through 22 layers and a sum
    whose order moves it; this one sees it element by element.  Returns
    the worst layer's row."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    seen, kernel = [], fa_ops.flash_attention

    def catch(q, k, v, **kw):
        seen.append((q.detach().clone(), k.detach().clone(),
                     v.detach().clone(), kw))
        return kernel(q, k, v, **kw)

    fa_ops.flash_attention = catch
    try:
        with torch.no_grad():
            M.loss_fn(params, cfg, batch)
    finally:
        fa_ops.flash_attention = kernel
    if len(seen) != cfg.n_layers:
        fail(f"caught {len(seen)} flash calls, not one a layer")
    rows = []
    for i, (q, k, v, kw) in enumerate(seen):
        shape = "x".join(map(str, q.shape))
        rows.append(check_close(f"train layer {i} flash (q {shape})",
                                kernel(q, k, v, **kw),
                                flash_attention_ref(q, k, v, **kw)))
    worst = max(rows, key=lambda r: r["err_over_limit"])
    print("train flash on the path " + json.dumps(worst))
    return worst


def _all_wgmma(kd_ops, phase):
    """Every kd_loss launch of the phase's main path took the wgmma
    instance (bf16 rows and bases that suit TMA)."""
    by = dict(kd_ops.LAUNCHES_BY_INSTANCE)
    print(f"{phase}: kd_loss launches by instance {by}")
    if by["wgmma"] != kd_ops.LAUNCHES or sum(by.values()) != kd_ops.LAUNCHES:
        fail(f"{phase}: kd_loss launches {kd_ops.LAUNCHES} by instance {by}: "
             f"not all took the wgmma instance")


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
    kd_ops.LAUNCHES_BY_INSTANCE.update(dict.fromkeys(
        kd_ops.LAUNCHES_BY_INSTANCE, 0))
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
    _all_wgmma(kd_ops, "train")

    # kernel path against plain path on one batch, fresh weights
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, generator=gen)
    batch = {k: v.cuda() for k, v in corpus.device_batch(
        0, TRAIN_BATCH, TRAIN_SEQ, step=0).items()}
    check = _grad_check(M, cfg, params, batch)
    flash_path = _flash_on_path(M, cfg, params, batch)

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
                   top=10, groups={"kd_loss": ("kd_wgmma", "kd_merge"),
                                   "flash_fwd": ("flash_fwd",)})
    res = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "losses": losses, "train_device_wall_s": wall,
           "launches": launches, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "mfu": model_flops / (ms / 1e3) / PEAK_BF16,
           "model_tflop_per_step": model_flops / 1e12,
           "n_params": n_params, "peak_mem_gb": peak_gb,
           "loss_grad_ms": ev[0].elapsed_time(ev[1]),
           "adamw_ms": ev[1].elapsed_time(ev[2]),
           "flash_on_path_err_over_limit": flash_path["err_over_limit"],
           **check}
    print("train " + json.dumps(res))
    print("profile " + json.dumps({"train_step": prof}))
    return launches


# ---------------------------------------------------------------------------
def _gmm_on_tensor_cores(mg_ops, layer_steps, phase):
    """The bf16 backward's grouped products all took a tensor-core
    instance: per layer and step three of two bf16 operands (g, u, dh:
    wgmma) and four with a split f32 operand (dx's pair, dwg, dwu, dwo:
    wgmma_split), none on the CUDA cores (an f32 dy would have sent dh
    and dwo there)."""
    by = dict(mg_ops.LAUNCHES_BY_INSTANCE)
    want = {"wgmma": 3 * layer_steps, "wgmma_split": 4 * layer_steps,
            "general": 0, "f32": 0}
    print(f"{phase}: grouped_matmul launches by instance {by}")
    if by != want:
        fail(f"{phase}: grouped_matmul launches by instance {by}, "
             f"expected {want}")


def _gsa_all_vec(md_ops, phase):
    """Every dispatch/combine launch of the phase's main path (bf16 rows
    of 2048, 16-byte-aligned bases) took the vec instance."""
    by = dict(md_ops.LAUNCHES_BY_INSTANCE)
    print(f"{phase}: gather_scatter_add launches by instance {by}")
    if by["vec"] != md_ops.LAUNCHES or sum(by.values()) != md_ops.LAUNCHES:
        fail(f"{phase}: gather_scatter_add launches {md_ops.LAUNCHES} by "
             f"instance {by}: not all took the vec instance")


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
    kd_ops.LAUNCHES_BY_INSTANCE.update(dict.fromkeys(
        kd_ops.LAUNCHES_BY_INSTANCE, 0))
    mg_ops.LAUNCHES.update(dict.fromkeys(mg_ops.LAUNCHES, 0))
    mg_ops.LAUNCHES_BY_INSTANCE.update(dict.fromkeys(
        mg_ops.LAUNCHES_BY_INSTANCE, 0))
    md_ops.LAUNCHES_BY_INSTANCE.update(dict.fromkeys(
        md_ops.LAUNCHES_BY_INSTANCE, 0))
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
                "grouped_matmul": mg_ops.LAUNCHES["grouped_matmul"],
                "split_f32": mg_ops.LAUNCHES["split_f32"]}
    L, n = cfg.n_layers, TUNE_STEPS
    # per layer and step, with each group rematerialised: dispatch and
    # combine forward twice plus their two backward movements; the FFN
    # forward twice; the backward's eight grouped products in seven
    # launches (dx's two in one) after three splits (dg, du, h); flash
    # twice; kd_loss twice per loss chunk
    want = {"flash_attention": 2 * L * n,
            "kd_loss": 2 * (TUNE_SEQ // cfg.loss_chunk) * n,
            "gather_scatter_add": 6 * L * n, "grouped_ffn": 2 * L * n,
            "grouped_matmul": 7 * L * n, "split_f32": 3 * L * n}
    # each layer routes twice a step: the forward and remat's recompute
    drops = [sum(_dropped(i, cfg.n_experts) for i in c) / 2
             for c in step_choices]
    del step_choices
    print(f"tune: {n} steps in {wall:.2f}s (merge included), losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}")
    if launches != want:
        fail(f"tune launches {launches} != expected {want}")
    _all_wgmma(kd_ops, "tune")
    _gmm_on_tensor_cores(mg_ops, L * n, "tune")
    _gsa_all_vec(md_ops, "tune")
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
                   groups={"grouped_matmul": ("gmm_wgmma_kernel",
                                              "gmm_kernel"),
                           "split_f32": ("split_kernel",),
                           "ffn_stage_a": ("ffn_gate_up_tc",),
                           "ffn_stage_b": ("ffn_down_tc",),
                           "gather_scatter_add": ("gsa_vec_kernel",
                                                  "gsa_kernel"),
                           "kd_loss": ("kd_wgmma", "kd_merge"),
                           "flash_fwd": ("flash_fwd",)})
    del opt, step
    silent = [g for g in ("grouped_matmul", "split_f32", "ffn_stage_a",
                          "ffn_stage_b", "gather_scatter_add")
              if not prof["group_ms"][g] > 0]
    if silent:
        fail(f"the tune step's profile shows no device time in {silent}")
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
    # the same kernel's dequant branch (int8/fp8 pools with scales)
    "paged_attn_quant": {
        "route": "cuda", "source": "src/repro_torch/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:159"},
    "grouped_ffn": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:136"},
    "grouped_matmul": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:103"},
    # the same kernel's f32 operands as two bf16 terms, one pass a tensor
    "split_f32": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_gemm.cu",
        "replaces": "src/repro/kernels/moe_gemm/kernel.py:103"},
    "gather_scatter_add": {
        "route": "cuda", "source": "src/repro_torch/csrc/moe_dispatch.cu",
        "replaces": "src/repro/kernels/moe_dispatch/kernel.py:68"},
    "ssd_scan": {
        "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:91"},
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
    serve_kv = phase_serve_kv()
    serve_ssm = phase_serve_ssm()
    train = phase_train()
    tune = phase_tune()
    # launches: the counts of every path run that drives the kernel
    launches = {k: sum(path.get(k, 0)
                       for path in (serve, serve_kv, serve_ssm, train, tune))
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
