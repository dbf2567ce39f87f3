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
   and in KD mode, at Dt 1024 and at the distill step's T 2048, Ds = Dt
   = 2048, V 151936, and on ragged T, V and D; ``general`` for rows or
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
   take (bytes over 3.35 TB/s, flops over the type's peak); bucketed
   chunked admission's shapes: the paged kernel with 256 query rows a
   slot (TinyLlama's and Zamba2's heads, ctx up to 1024) and the SSD
   scan over one 256-row chunk from a carried state (Mamba2's and
   Zamba2's shapes, fast and slow decay); DeepSeek-V3's shapes: the
   grouped FFN over its 256 expert stacks (3.76 G elements each) at C 8
   and C 64 with expert 255's rows held apart, the dispatch and combine
   at T 1024, top-8, D 7168, and CE at T 2048, D 7168, V 129,280;
   Whisper-small's shapes: flash bidirectional at S 1500, H 12, D 64 in
   bf16 and f32 (a causal mask must miss the limit), paged at its
   decoder's heads (8 slots, 64 rows, int8), CE at D 768, V 51,865;
   the gemma shapes: flash at S 8192, H 16 over KH 8, D 256 with
   Gemma-2's window of 4096 and cap of 50 (q scaled so scores reach
   about 150) and at PaliGemma's S 1280, H 8 over KH 1; paged at C 1
   over 8 slots of ctx 4100-8192 and at C 256 over ctx 4608 with the
   window and the cap; the plain version without the window, and
   without the cap, must each miss the limit; speculative decode's draft
   block: flash at B 8, S 1, H 32 over KH 4, D 64 in bf16 (timed) and
   f32, and the paged kernel at 4 rows a slot (bf16 and int8 timed);
4. serve: full-width TinyLlama-1.1B (bf16, random weights from seed 0)
   behind ``PagedServeEngine``: 16 greedy requests, prompts of 128-1024
   tokens, 64 new tokens each.  Checks the completions, the allocator,
   the kernels' launch counts on that run, and the kernel path's logits
   against the plain path's.  Then the same traffic through bucketed
   chunked admission (chunks of CHUNK_LEN = 256 rows, the default
   ladder 256-2048; ``_bucketed_serve``): the completions, the launches
   (the paged kernel at 256 rows, 22 a chunk; no flash), TTFT, admission
   time, ms a decode step, tok/s and peak beside the unbucketed run's;
   and the f32 model (the weights cast) served unbucketed and bucketed
   on 8 of the requests, its completions equal token for token.  Then
   speculative decode (k SPEC_K = 3) through a seeded MTP head
   (``n_mtp=1``): the 16 requests in bf16 (launches: per verify step 22
   paged at 4 rows a slot and 3 flash at S 1, the draft block's;
   acceptance, each request's first divergence from plain decode); the
   f32 model's speculative completions equal plain ones in both engines,
   bucketed and not; an oracle drafter (``_Oracle``, in place of
   ``model._mtp_draft``) at acceptance 1.0 and, one chain depth wrong,
   strictly between 0 and 1, with the plain tokens; no nonzero cache row
   past any slot's frontier after the scrub, some without it; the
   samplers (Temperature, TopK) equal at seg_len 8 and 3, the stream's
   bits on the card equal the CPU's, ``_residual_verify``'s marginal
   (accepting without the uniform must miss);
5. profile: torch.profiler over one 1024-token prefill (flash's share
   read apart) and one decode segment (the paged kernel's share read
   apart, failing at zero; device launches a layer-step);
5a. serve_kv: the same model cut to 11 of its 22 layers, the same
   traffic and engine, with the KV pool in
   bf16, int8, fp8 and bf16 again, in turns.  Checks the completions,
   the dequant branch's launches in the quantized runs (one a layer a
   decode step, none of the unquantized branch), the decode logits of the
   quantized kernel path against the quantized gather path and against
   the unquantized path (and that dropped scales would fail that
   limit), reports speed, pool bytes and peak memory against the bf16
   runs, bf16 against int8 pools of equal bytes (live requests,
   preemptions), and profiles an int8 decode segment as phase 5 does;
5b. serve_ssm: full-width, full-depth Mamba2-1.3B (bf16, random weights
   from seed 0) behind ``PagedServeEngine``: 8 of the 16 greedy requests
   (every other), prompts of 187-1024 tokens, 64 new tokens each.
   Checks the completions, the SSD kernel's launches (48 per prefill, all ``tc``), logits on two
   prompts (f32 kernel path against the plain version; bf16 paths
   against the f32 model; prefill + decode against one prefill), and
   profiles one 1024-token prefill (the scan's three launches read
   apart) and one decode segment; then bucketed admission through the
   contiguous engine as in phase 4 (the scan from a carried state, 48 a
   chunk, all ``tc``), f32 completions equal to the unbucketed ones on 8
   of the requests;
5c. serve_moe: Qwen1.5-MoE-A2.7B at full width and depth, then
   DeepSeek-MoE-16B at full width on 14 of its 28 layers
   (SERVE_MOE_LAYERS), 8 of the 16 requests each, then StarCoder2-3B
   (``_serve_moe_model``).  On Qwen also
   bucketed admission: ``prefill_chunked`` at chunks of 8 kernel vs
   plain (nothing can drop), 8 of the requests unbucketed and bucketed
   with the chunks' dropped assignments, and each bf16 path's distance
   to the f32 model on its own path;
5d. serve_hybrid: Zamba2-7B at full width and depth: the logit checks
   (with the bucketed prefill: f32 against the plain path, bf16 against
   the f32 model), 8 of the 16 requests unbucketed and bucketed;
5e. serve_mla: DeepSeek-V3 at full width, cut to its 3 leading dense
   layers and 1 MoE layer (256 experts, top-8; MLA's latent cache; the
   MTP head built): one full-width MLA layer in f32 (a dense layer's and
   the MTP block's), the absorbed-matrix decode over a paged latent pool
   (chunks of CHUNK_LEN, then single steps) against ``mla_full``'s rows,
   wk_b's transpose absorbed and RoPE on the nope half each breaking the
   limit; the prefill and decode MoE checks of serve_moe (expert 255's
   weights read in every step); the 16 requests from a bf16, an int8 and
   an fp8 latent pool (launches: kernels 4 and 6 once a MoE layer a
   prefill or decode step, no flash or paged attention), the pools'
   bytes and decode logits (dropped scales breaking the limit); 8
   requests unbucketed and bucketed; the bf16 model's distance to the
   f32 model (RoPE on the nope half breaking it); speculative decode (k
   3, the model's own MTP head) on 8 requests from each latent pool
   (launches, acceptance, the live assignments a verify chunk drops),
   and the f32 model's speculative completions at 2 slots (8 rows a
   verify chunk: nothing can drop) equal plain ones, the oracle drafter's
   at acceptance 1.0;
5f. serve_gemma: Gemma-2-9B at full width on GEMMA9_LAYERS = 22 of its
   42 layers (local windows of 4096, both softcaps): the f32 model's kernel path against
   its plain path on a 4,608-token request (its prefill masks in flash,
   its 4 decode steps read paged attention past the window), the same
   weights with ``sliding_window=0`` breaking the limit, each bf16
   path's distance to the f32 model; 8 of the 16 requests (every other)
   and the long one through the paged and the contiguous engine
   (launches, readings, pool bytes); the 8 unbucketed and bucketed; f32 completions
   bucketed and unbucketed equal on GEMMA_F32_IDENTITY_LAYERS layers.
   Gemma-2-27B at full width on GEMMA27_LAYERS layers: the same check,
   three requests and the long one through both engines.  PaliGemma-3B
   at full width and depth: 8 requests of 256 stub patch rows and
   187-1024 text tokens through both engines, unbucketed and bucketed;
   the logit check with zeroed patches as the fault; equal patches and
   text sharing every full prompt block, other patches none;
5g. serve_encdec: Whisper-small at full width and depth (12 encoder and
   12 decoder layers, 1,500 stub frames a request): the f32 kernel-vs-
   plain logit check (prefill + 4 paged decode steps; the encoder through
   flash with ``causal=False``), a causal encoder and zeroed frames each
   breaking it; requests with equal frames sharing their prefix blocks,
   other frames none; 16 requests of 4-192 tokens and 32-128 new ones
   through the paged engine, the contiguous one, the paged one bucketed
   (chunks of 64, the encoder once an admission) and from an int8 pool,
   launches counted; f32 completions bucketed and unbucketed equal;
5h. serve_sharded (run last, after fleet): Qwen1.5-MoE-A2.7B at full
   width on an NCCL process group of one rank over an in-process store
   and its (1, 1) decode mesh
   (NCCL will not put two ranks on one card), the MoE forced onto the
   expert-parallel paths, so that the collectives and kernels 4-6 run on
   the sharded buffer layout: one MoE layer in f32 at the tune step's
   4,096 rows through ``moe_dense`` and both sharded paths (output, aux
   loss and every gradient within SHARDED_REL_TOL; kernels 4, 5 and 6
   launched, none by the plain runs; each path's forward time, the NCCL
   kernels' device time); the f32 model on 4 layers, 4 requests through
   both engines with chunks of 8 on both paths, tokens equal to
   ``mesh=None``'s; the bf16 model at full depth, 8 requests through
   the paged engine, ``mesh=None`` then a2a (launches; tok/s, ms a
   decode step, first divergence), a decode segment profiled;
   ``launch/serve.py --sharded --check-unsharded --paged`` in process;
6. train: ``train_device`` on full-width TinyLlama-1.1B (bf16, random
   weights from seed 0), 8 steps of 4 x 1024 tokens at lr 1e-3.  Checks
   finite, falling losses and the kernels' launch counts on that run
   (every kd_loss launch in the wgmma instance),
   the kernel path's loss and gradients against the plain path's, every
   layer's flash output on a real batch (q, k, v caught on the path)
   against the plain version's by the per-element rule, and
   reports ms per step, tokens/s, MFU, peak memory and a profile; then
   the same 8 steps with bf16 and with int8 AdamW moments (launches
   checked, losses against the fp32 run's at the reference's limits,
   2e-2 and 5e-2) and, per policy, ms per step, tokens/s, the resident
   state and the peak;
6d. train_mla: ``train_device`` on DeepSeek-V3 at full width cut to 4
   layers and 32 experts (top-8 kept), bf16 AdamW moments, 4 steps of 2 x
   1024 tokens with the MTP loss: finite, falling losses, launches
   (kd_loss twice a loss chunk of the main and the MTP CE, all wgmma;
   the MoE layer's products on tensor cores, the dispatch in vec), the
   MTP chain at depth 1 equal to ``_mtp_loss``, the kernel path's loss
   and gradients against its plain version in bf16 and f32; ms a step,
   tokens/s, MFU, peak;
6e. train_encdec: Whisper-small at full width and depth, 6 steps of 4 x
   448 tokens with zero frames (the launcher's ``make_batch``) under
   ``remat_policy="dots"``: each batch's loss falling, launches (flash
   twice a layer a step, the encoder's bidirectional; kd_loss in the
   general instance: V 51,865); on a batch with stub frames the kernel
   path's loss and every gradient against the plain path's, and
   ``dots`` against full and no remat (the same loss and gradients, each
   one's peak, the ``aten.mm`` calls the backward recomputes);
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
   per step and a profile;
8. distill: Phases I and II of the paper's method.  Two random
   full-width TinyLlama-1.1B uploads (22 layers, bf16) on the
   federation's vocabulary, 151936, instead of their own 32000 (the
   kd_loss kernel takes one V for both heads, and the student's must be
   the global MoE's): ``DeepFusionServer.cluster`` (K = 60 > N = 2, so
   each upload is its own proxy) and ``build_proxies`` on a cluster of
   both, whose bf16 average must equal the CPU's f32 sum, divided and
   cast, bit for bit; then ``distill_proxy`` into the dense base of
   Qwen1.5-MoE-A2.7B (12 of 24 layers, d_ff 1408, remat) for 6 steps of
   4 x 1024 tokens at lr 1e-3, J 4, VAA d 128, 4 heads, P_q 64, τ 2.
   Checks finite, falling losses, the launch counts (flash 22 + 2 x 12
   a step; kd_loss only in KD mode, 2 a loss chunk, every one in the
   wgmma instance), and the kernel path's distill_loss and the gradient
   of every student and VAA leaf against the plain path on one 1 x 1024
   batch in bf16 and in f32 (teacher sharpened so that KL reaches
   them), where a teacher rolled by one token (KL) and its stage list
   reversed (FM) must each break a limit; reports ms per step, tokens/s,
   MFU, peak memory, the KD backward's time and share of a step, and a
   profile;
9. pipeline: the whole federation through ``run_deepfusion`` from
   ``uploads=None``, the paper's case study 1 at full width: four
   devices (build_fleet's draws at seed 0: GPT-2, GPT-2-Medium,
   GPT-2-Medium, GPT-2; bf16, on the federation's vocabulary 151936,
   tied heads) train 4 steps of 4 x 1024; Phase I (K 60 > N 4: four
   proxies); Phase II distils each into the 12-layer Qwen1.5-MoE base (4
   steps of 4 x 1024, Dt 768 and 1024 against Ds 2048, the tied teacher
   head copied on every KD launch); Phase III merges and tunes 4 steps;
   ``evaluate_model`` on 4 domains x 4 batches of 8 x 1024.  Checks each
   stage's launches against the configs, every bf16 kd_loss launch in
   the wgmma instance, the tune's products on tensor cores and the
   dispatch in vec, finite losses, each trained model's mean loss over
   its training batches below its init's (the inits drawn again from
   their seeds), each device's and proxy's loss on a held-out batch
   below its init's, ``comm_bytes`` against ``device_upload_bytes``,
   finite metrics; reports each stage's wall time, tokens/s and peak
   memory, the KD calls' spans beside the tied head's copy, the MoE's
   drops and the tune's held-out loss;
10. methods: DeepFusion, FedKMT, OFA-KD, FedJETS, centralized training
   and FedAvg on ``benchmarks/common.py``'s f32 configs (copied; vocab
   256, seq 48, N 8, its step counts halved), one fleet's uploads
   shared.
   Checks each ``comm_bytes`` against its formula; DeepFusion at 6
   steps with kernels against ``use_kernels=False`` (histories and
   ``log_ppl`` within METHODS_*_RTOL; the MoE's only when nothing
   dropped; the plain run launches no kernel, the kernel run's tune and
   eval launch the MoE's), and FedKMT at least METHODS_KMT_MARGIN
   log_ppl limits from DeepFusion;
11. fleet: the fleet extensions on the pipeline phase's four full-width
   devices (batch 4 x 1024): ``train_fleet_async`` 3 rounds x 2 steps
   on an ideal fleet against ``train_fleet`` 6 steps, every upload bit
   for bit; a straggler fleet (``build_fleet(traffic="harsh")``, int8
   moments, participation 0.75, deadline 2 s, stale late reports, 4
   rounds x 2 steps) held to the schedule the host predicts from the
   traffic draws (its ``rounds`` log, lost reports, each device's loss
   count and the step each round starts from), offline devices' state
   unchanged bit for bit, each bucket's aggregate against its f64
   closed form (and the same reports without the staleness discount
   breaking it); the resident fleet state and a round's peak, fp32
   against int8 moments; ``launch/train.py --fleet 8 --async-rounds 3
   --steps-per-round 2 --straggler-profile mild --check-sync`` in
   process, which must print ``check-sync OK``.  Flash and kd_loss
   launch in every device step, every bf16 kd_loss launch in wgmma.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without either when
there is no CUDA device or the port is not beside this script.
f32 matrix products run in full f32 (TF32 off) throughout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

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


def _over_limit(out: torch.Tensor, want: torch.Tensor):
    """(|out - want|, the largest error in units of ``check_close``'s
    limit)."""
    out, ref = out.float(), want.float()
    err = (out - ref).abs()
    limit = torch.full_like(ref, F32_TOL)
    if want.dtype != torch.float32:
        _, e = torch.frexp(ref)     # |ref| in [2**(e-1), 2**e)
        ulp = torch.ldexp(torch.full_like(ref, torch.finfo(want.dtype).eps),
                          e - 1)
        limit += 2 * ulp
    return err, (err / limit).max().item()


def check_close(case: str, out: torch.Tensor, want: torch.Tensor) -> dict:
    """Holds a kernel's output to its plain version's, element by element.
    Both accumulate in f32 and round once to the output dtype, so in bf16
    an element differs by about one bf16 ulp of its own value, plus the
    f32 sum-order difference: the limit is two ulps of |want| + F32_TOL.
    A small output (a long row's average) gets a small limit.  f32
    outputs: F32_TOL.  Returns the largest error and its share of the
    limit."""
    err, worst = _over_limit(out, want)
    ref = want.float()
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

CARD = ""   # nvidia-smi's name and power limit, printed with numbers


def phase_card():
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
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
    # the autograd engine runs a CUDA backward on a thread of its own,
    # whose cuBLAS handle takes a workspace from the caching allocator
    # that lives until the process ends: taken by the first backward of a
    # phase, it is cut from whatever large segment is free then and keeps
    # that segment reserved for every later phase (16.6 GiB after
    # serve_sharded's layer check, which left train_mla short).  One tiny
    # backward here takes it while nothing is cached
    a = torch.ones((8, 8), device="cuda", requires_grad=True)
    (a @ a).sum().backward()
    torch.cuda.synchronize()


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


def _terms_seen(name, want, plain, kw):
    """Each term of a windowed or capped case reaches the output: the
    plain version run without it (``window=0``, ``softcap=0``) must miss
    the limit the kernel is held to, or the check could not see that
    term.  Returns each miss in units of the limit."""
    row = {}
    for term in ("window", "softcap"):
        if kw[term]:
            worst = _over_limit(plain(**{**kw, term: 0}), want)[1]
            row[f"without_{term}_over_limit"] = worst
            if not worst > 1.0:
                fail(f"{name}: the plain version without its {term} is "
                     f"within the limit ({worst:.3g}x): the check cannot "
                     f"see the {term}")
    return row


def _max_score(q, k, qpos, kpos, window):
    """The largest |q.k| / sqrt(D) over the visible (query, key) pairs,
    one query head at a time: q (B, Sq, H, D), k (B, Sk, KH, D), qpos
    (B, Sq) and kpos (Sk,) absolute positions."""
    B, Sq, H, D = q.shape
    g = H // k.shape[2]
    ok = kpos[None, None, :] <= qpos[:, :, None]
    if window:
        ok = ok & (kpos[None, None, :] > qpos[:, :, None] - window)
    best = 0.0
    for h in range(H):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(),
                         k[:, :, h // g].float()).abs() / math.sqrt(D)
        best = max(best, s.masked_fill(~ok, 0).max().item())
    return best


def flash_case(gen, B, S, H, KH, D, dtype, *, window=0, softcap=0.0,
               timed=False, q_scale=1.0, terms=False, causal=True):
    """``q_scale`` scales q so that scores reach a softcap's range;
    ``terms`` also shows that the window and the softcap each reach the
    output (``_terms_seen``).  ``causal=False`` (the encoder's mode): the
    plain version with a causal mask must miss the limit, so the check
    sees the keys above the diagonal."""
    from repro_torch.kernels.flash_attention import ops, ref
    q = (_randn(gen, (B, S, H, D), torch.float32) * q_scale).to(dtype)
    k = _randn(gen, (B, S, KH, D), dtype)
    v = _randn(gen, (B, S, KH, D), dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    name = (f"flash B={B} S={S} H={H} KH={KH} D={D} {str(dtype)[6:]} "
            f"{'causal' if causal else 'bidirectional'} "
            f"window={window} softcap={softcap}"
            + (f" q_scale={q_scale}" if q_scale != 1.0 else ""))
    row = check_close(name, out, want)
    if not causal:
        worst = _over_limit(ref.flash_attention_ref(
            q, k, v, **{**kw, "causal": True}), want)[1]
        row["causal_mask_over_limit"] = worst
        if not worst > 1.0:
            fail(f"{name}: the plain version with a causal mask is within "
                 f"the limit ({worst:.3g}x): the check cannot see the keys "
                 f"above the diagonal")
    if terms:
        pos = torch.arange(S, device="cuda")
        row["max_abs_score"] = _max_score(q, k, pos[None].expand(B, S), pos,
                                          window)
        row.update(_terms_seen(name, want, lambda **c: (
            ref.flash_attention_ref(q, k, v, **c)), kw))
    if timed:
        # visible (q, k) pairs, 4*D flops each: every pair without the
        # causal mask, the lower triangle (or the window's band) with it
        if not causal:
            pairs = S * S
        else:
            pairs = S * (S + 1) / 2 if not window else sum(
                min(i + 1, window) for i in range(S))
        flops = 4 * D * pairs * B * H
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row.update(
            ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
            library_ms=(time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
                if not (window or softcap) else None))
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, dtype)
    return row


def paged_case(gen, ctx, C, H, KH, D, bl, dtype, *, window=0, softcap=0.0,
               timed=False, q_scale=1.0, terms=False):
    """len(ctx) slots; slot b holds ctx[b] cached positions (its queries
    are the last C of them).  Blocks are scattered over the pool in a
    random order; table entries past a slot's blocks point at block 0.
    ``q_scale`` and ``terms`` as in ``flash_case``."""
    from repro_torch.kernels.paged_attn import ops, ref
    from repro_torch.models.layers import paged_gather
    B = len(ctx)
    bt, n_blocks = _pool_table(gen, ctx, bl)
    nbt = bt.shape[1]
    pos = torch.tensor([c - C for c in ctx], dtype=torch.int32,
                       device="cuda")
    q = (_randn(gen, (B, C, H, D), torch.float32) * q_scale).to(dtype)
    kp = _randn(gen, (n_blocks, bl, KH, D), dtype)
    vp = _randn(gen, (n_blocks, bl, KH, D), dtype)
    kw = dict(window=window, softcap=softcap)
    out = ops.paged_decode_attention(q, kp, vp, bt, pos, **kw)
    want = ref.paged_attention_ref(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    name = (f"paged slots={B} ctx={min(ctx)}-{max(ctx)} C={C} H={H} KH={KH} "
            f"D={D} bl={bl} {str(dtype)[6:]} window={window} "
            f"softcap={softcap}"
            + (f" q_scale={q_scale}" if q_scale != 1.0 else ""))
    row = check_close(name, out, want)
    _check_repeat(name, out, lambda: ops.paged_decode_attention(
        q, kp, vp, bt, pos, **kw))
    if terms:
        qpos = (pos.long()[:, None]
                + torch.arange(C, device="cuda")[None, :])
        row["max_abs_score"] = _max_score(
            q, paged_gather(kp, bt), qpos,
            torch.arange(nbt * bl, device="cuda"), window)
        row.update(_terms_seen(name, want, lambda **c: (
            ref.paged_attention_ref(q, kp, vp, bt, pos, **c)), kw))
    if timed:
        row["split"] = _split(ops, q, kp, bt)
        # every visible K/V row read once (a window hides the rows left
        # of its first query's), q read and out written once
        rows = sum(c - max(0, c - C - window + 1) if window else c
                   for c in ctx)
        nbytes = (2 * rows * KH * D + 2 * q.numel()) * q.element_size() \
            + bt.numel() * 4 + pos.numel() * 4
        flops = 4 * D * H * sum(
            min(p + 1, window) if window else p + 1
            for c in ctx for p in range(c - C, c))
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
# timed (the check still runs it once); the KD case at V 151936 needs 7.5 GB
PLAIN_TIMED_BYTES = 8e9


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
    (Dt 1024, V 32000), at the tune step's vocabulary, and in KD mode at
    the distill step's shape (a loss chunk of 4 x 512 tokens, Ds = Dt =
    2048, V 151936, τ 2: the kernels line's ``kd_loss_kd`` row); the
    wgmma instance on ragged T, V
    and D; the general instance (V not a multiple of 8, rows too narrow
    for TMA, hs off alignment); f32; planted ties in each instance."""
    bf, f32 = torch.bfloat16, torch.float32
    return [kd_case(gen, 2048, 2048, 0, 32000, bf, timed=True),
            kd_case(gen, 2048, 2048, 1024, 32000, bf, tau=2.0, timed=True),
            kd_case(gen, 2048, 2048, 0, 151936, bf, timed=True),
            kd_case(gen, 2048, 2048, 2048, 151936, bf, tau=2.0, timed=True),
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
# the same layer in a serve_moe decode step: 8 slots, capacity
# max(ceil(8*4/60)*2, 8) = 8 slots per expert
MOE_DECODE_T = 8
MOE_DECODE_CAP = max(-(-MOE_DECODE_T * MOE_K // MOE_E) * 2, 8)


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
           ffn_case(gen, 2, 130, 256, 200, bf, act="gelu", off="wo"),
           # the decode shape (serve_moe): every expert's weights read
           # for at most 8 filled rows each
           ffn_case(gen, E, MOE_DECODE_CAP, D, Fh, bf, timed=True)]
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
    # the decode shape (serve_moe): 8 tokens, top-4 of 60
    gsa += [gsa_case(gen, m, MOE_DECODE_T, E, k, D, bf, timed=True)
            for m in ("dispatch", "combine")]
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
    64-1088, H 32 over KH 4, D 64, block_len 16, bf16 out; timed), C = 4
    (int8 timed),
    GQA with window and softcap in f32, and D = 24, whose int8/fp8 rows
    (24 bytes) take 8-byte loads; int8 and fp8 each; int8 timed at 8
    slots x ctx LONG_CTX."""
    bf, f32 = torch.bfloat16, torch.float32
    ctx = [int(c) for c in np.linspace(64, 1088, 8)]
    rows = []
    for kv in ("int8", "fp8"):
        rows += [paged_quant_case(gen, ctx, 1, 32, 4, 64, 16, bf, kv,
                                  timed=True),
                 # speculative decode's verify chunk (k 3): 4 rows a slot
                 paged_quant_case(gen, ctx, 4, 32, 4, 64, 16, bf, kv,
                                  timed=kv == "int8"),
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
             flash_case(gen, 1, 130, 4, 1, 128, f32),
             flash_case(gen, 1, 1024, 24, 2, 128, bf)]
    ctx = [int(c) for c in np.linspace(64, 1088, 8)]
    paged = [paged_case(gen, ctx, 1, 32, 4, 64, 16, bf, timed=True),
             paged_case(gen, ctx, 4, 32, 4, 64, 16, bf, timed=True),
             paged_case(gen, [5, 40, 17], 3, 8, 2, 32, 4, f32, window=12,
                        softcap=30.0),
             paged_case(gen, [1, 200], 1, 4, 4, 128, 16, f32),
             paged_case(gen, [LONG_CTX] * 8, 1, 32, 4, 64, 16, bf,
                        timed=True),
             # serve_moe's heads: the MoEs' 16 x 128 (group 1), and
             # StarCoder2's 24 over 2 kv heads (12 query rows a kv head)
             paged_case(gen, ctx, 1, 16, 16, 128, 16, bf),
             paged_case(gen, ctx, 1, 24, 2, 128, 16, bf)]
    pq = quant_cases(gen)
    hd_flash, hd_paged, hd_quant = head_dim_cases(gen)
    flash += flash_bf16_cases(gen)
    kd = kd_cases(gen)
    ffn, gmm, split, gsa = moe_cases(gen)
    ssd = ssd_cases(gen)
    # the hybrid and ssm training slice's shapes: Zamba2's shared attention
    # (H 32 = KH, D 112) in prefill and in training, and in decode; CE on
    # the tied heads of Mamba2 (V 50280) and Zamba2 (D 3584, V 32000); the
    # scan at Zamba2's prefill (H 112, N 64) and Mamba2's train step (B 4)
    hybrid = [flash_case(gen, 1, 1024, 32, 32, 112, bf, timed=True),
              flash_case(gen, 4, 1024, 32, 32, 112, bf, timed=True),
              paged_case(gen, ctx, 1, 32, 32, 112, 16, bf, timed=True),
              kd_case(gen, 2048, 2048, 0, 50280, bf, timed=True),
              kd_case(gen, 2048, 3584, 0, 32000, bf, timed=True),
              ssd_case(gen, 1, 1024, 112, 64, 64, 1, bf, timed=True,
                       inst="tc"),
              ssd_case(gen, 1, 1024, 112, 64, 64, 1, bf, slow=True,
                       inst="tc"),
              ssd_case(gen, 4, 1024, 64, 64, 128, 1, bf, timed=True,
                       inst="tc"),
              ssd_case(gen, 4, 1024, 64, 64, 128, 1, bf, slow=True,
                       inst="tc")]
    chunked = chunked_admission_cases(gen)
    wide = mla_cases(gen)
    gemma = gemma_cases(gen)
    encdec = encdec_cases(gen)
    # speculative decode's draft block: one query against one key a slot
    # (TinyLlama's heads, 8 slots), in bf16 and f32
    draft = [flash_case(gen, 8, 1, 32, 4, 64, bf, timed=True),
             flash_case(gen, 8, 1, 32, 4, 64, f32)]
    for row in (flash + paged + pq + hd_flash + hd_paged + hd_quant + kd
                + ffn + gmm + split + gsa + ssd + hybrid + chunked + wide
                + gemma + encdec + draft):
        print("kernel " + json.dumps(row))
    return {"flash_attention": flash[0], "paged_attn": paged[0],
            "paged_attn_quant": pq[0], "kd_loss": kd[0], "kd_loss_kd": kd[3],
            "grouped_ffn": ffn[0],
            "grouped_matmul": gmm[0], "split_f32": split[0],
            "gather_scatter_add": gsa[0],
            "ssd_scan": ssd[0], "paged_attn_chunk": chunked[0],
            "ssd_scan_h0": chunked[4], "flash_attention_bidir": encdec[0]}


def chunked_admission_cases(gen):
    """Bucketed chunked admission's shapes (one slot, CHUNK_LEN rows a
    chunk): kernel 2 with 256 query rows at TinyLlama's serve heads (H 32
    over KH 4, D 64) at the longest prompt's last chunk (ctx 1024, timed)
    and its first (ctx 256), at Zamba2's (H 32 = KH, D 112, timed) and
    at Qwen1.5-MoE's (H 16 = KH, D 128, timed);
    kernel 7 from a carried state (h0) over one 256-row chunk at
    Mamba2's serve shape (H 64, P 64, N 128) and Zamba2's (H 112, N 64),
    timed, each again with slow decay, where h0 must show."""
    bf = torch.bfloat16
    C = CHUNK_LEN
    return [paged_case(gen, [1024], C, 32, 4, 64, 16, bf, timed=True),
            paged_case(gen, [C], C, 32, 4, 64, 16, bf),
            paged_case(gen, [1024], C, 32, 32, 112, 16, bf, timed=True),
            paged_case(gen, [1024], C, 16, 16, 128, 16, bf, timed=True),
            ssd_case(gen, 1, C, 64, 64, 128, 1, bf, with_h0=True,
                     timed=True, inst="tc"),
            ssd_case(gen, 1, C, 64, 64, 128, 1, bf, with_h0=True, slow=True,
                     inst="tc"),
            ssd_case(gen, 1, C, 112, 64, 64, 1, bf, with_h0=True,
                     timed=True, inst="tc"),
            ssd_case(gen, 1, C, 112, 64, 64, 1, bf, with_h0=True,
                     slow=True, inst="tc")]


# serve_gemma's shapes: Gemma-2-9B's heads (H 16 over KH 8, D 256) with
# its local layers' window of 4096 and the attention softcap of 50, and
# PaliGemma's (H 8 over KH 1, D 256).  q is scaled so that scores reach
# about 150, where the cap bites (at unit scale tanh(s/50)*50 differs
# from s by about 1e-4 of s, which no limit could see).
GEMMA_WINDOW, GEMMA_CAP = 4096, 50.0
GEMMA_Q_SCALE = {"flash": 25.0, "paged": 30.0}


def gemma_cases(gen):
    """Kernel 1 at B 1, S 8192 with the window and the cap (timed; no
    library call has a softcap) and at PaliGemma's prefill, S 1280
    (timed beside SDPA); kernel 2 at C 1 over 8 slots of ctx 4100-8192
    (whole slices left of the window) and at C 256 over ctx 4608, both
    with the window and the cap, timed.  Each windowed or capped case
    shows that both terms reach its output."""
    bf = torch.bfloat16
    term = dict(window=GEMMA_WINDOW, softcap=GEMMA_CAP, timed=True,
                terms=True)
    ctx = [int(c) for c in np.linspace(4100, 8192, 8)]
    return [flash_case(gen, 1, 8192, 16, 8, 256, bf,
                       q_scale=GEMMA_Q_SCALE["flash"], **term),
            flash_case(gen, 1, 1280, 8, 1, 256, bf, timed=True),
            paged_case(gen, ctx, 1, 16, 8, 256, 16, bf,
                       q_scale=GEMMA_Q_SCALE["paged"], **term),
            paged_case(gen, [4608], CHUNK_LEN, 16, 8, 256, 16, bf,
                       q_scale=GEMMA_Q_SCALE["paged"], **term)]


# DeepSeek-V3's expert layer (serve_mla): 256 routed experts of width 2048
# over D 7168, top-8; capacity max(ceil(T*8/256)*2, 8): 8 slots an expert
# in an 8-slot decode step, 64 in a 1024-token prefill.  Each expert stack
# is 256 x 7168 x 2048 = 3.76 G elements, past 2^31.
V3_E, V3_K, V3_D, V3_F, V3_V = 256, 8, 7168, 2048, 129280


def _wide_stack(gen, shape, scale):
    """A bf16 (E, ...) expert stack ~N(0, scale^2), drawn 32 experts at a
    time (an f32 draw of the whole stack would take 15 GB)."""
    t = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
    for e in range(0, shape[0], 32):
        n = min(32, shape[0] - e)
        t[e:e + n] = (torch.randn((n,) + tuple(shape[1:]), generator=gen,
                                  device="cuda") * scale).to(torch.bfloat16)
    return t


def ffn_wide_cases(gen):
    """Kernel 4 at DeepSeek-V3's expert stacks with C 8 (decode) and C 64
    (a 1024-token prefill), timed as ``ffn_case``; expert 255's rows held
    apart by the same rule (an int32 offset would wrap there first)."""
    from repro_torch.kernels.moe_gemm import ops, ref
    bf = torch.bfloat16
    E, D, Fh = V3_E, V3_D, V3_F
    wg, wu = (_wide_stack(gen, (E, D, Fh), D ** -0.5) for _ in "gu")
    wo = _wide_stack(gen, (E, Fh, D), Fh ** -0.5)
    rows = []
    for C in (8, 64):
        x = _randn(gen, (E, C, D), bf)
        out = ops.grouped_ffn_fwd(x, wg, wu, wo)
        want = ref.grouped_ffn_ref(x, wg, wu, wo)
        torch.cuda.synchronize()
        name = f"grouped_ffn E={E} C={C} D={D} F={Fh} bfloat16 silu"
        row = check_close(name, out, want)
        last = check_close(name + " expert 255", out[E - 1], want[E - 1])
        if not want[E - 1].abs().max() > 0:
            fail(f"{name}: expert 255's plain rows are 0")
        row.update(expert_255_max_abs_err=last["max_abs_err"],
                   expert_255_err_over_limit=last["err_over_limit"])
        del want

        def library():  # a torch.bmm chain in bf16
            return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wo)

        row.update(ms=time_ms(lambda: ops.grouped_ffn_fwd(x, wg, wu, wo)),
                   plain_ms=time_ms(lambda: ref.grouped_ffn_ref(x, wg, wu,
                                                                wo), iters=5),
                   library_ms=time_ms(library))
        row["bound_ms"], row["bound_by"] = bound_ms(
            _nbytes(x, wg, wu, wo, out), 6 * E * C * D * Fh, bf)
        rows.append(row)
        del x, out
    del wg, wu, wo
    torch.cuda.empty_cache()
    return rows


def mla_cases(gen):
    """The kernels at serve_mla's and train_mla's new shapes: kernel 4 at
    DeepSeek-V3's expert stacks (``ffn_wide_cases``), kernel 6's dispatch
    and combine at a 1024-token prefill (T 1024, top-8 of 256, D 7168:
    rows of 14,336 bytes), and kernel 3's CE at two 1024-token rows of
    train_mla (T 2048, D 7168, V 129,280), each timed."""
    bf = torch.bfloat16
    rows = ffn_wide_cases(gen)
    rows += [gsa_case(gen, m, 1024, V3_E, V3_K, V3_D, bf, timed=True)
             for m in ("dispatch", "combine")]
    rows.append(kd_case(gen, 2048, V3_D, 0, V3_V, bf, timed=True))
    return rows


# Whisper-small's shapes (serve_encdec, train_encdec): the encoder's
# 1500 frames over 12 heads of 64 (1500 = 23 x 64 + 28: a ragged last key
# tile), the decoder's self-attention over 8 slots, bucketed chunks of
# ENCDEC_CHUNK rows, and the tied head's CE over a train step's loss
# chunk (4 rows of 448 tokens, D 768, V 51,865)
ENCDEC_FRAMES, ENCDEC_H, ENCDEC_D = 1500, 12, 64
ENCDEC_CHUNK = 64
ENCDEC_V, ENCDEC_DM = 51865, 768


def encdec_cases(gen):
    """Kernel 1 bidirectional at the encoder's shape, B 1, S 1500, H 12 =
    KH, D 64, bf16 (timed beside SDPA with ``is_causal=False``: the
    kernels line's ``flash_attention_bidir`` row) and f32 (timed), each
    with the plain version under a causal mask missing the limit; kernel
    2 at the decoder's heads over 8 slots of ctx 32-320 (timed), at
    ENCDEC_CHUNK rows over ctx 192, and from an int8 pool (timed); kernel
    3's CE at T 1792, D 768, V 51,865 (timed) in the ``general`` instance,
    the one the train path takes: rows of 51,865 bf16 are no multiple of
    TMA's 16 bytes."""
    bf, f32 = torch.bfloat16, torch.float32
    S, H, D = ENCDEC_FRAMES, ENCDEC_H, ENCDEC_D
    ctx = [int(c) for c in np.linspace(32, 320, 8)]
    return [flash_case(gen, 1, S, H, H, D, bf, causal=False, timed=True),
            flash_case(gen, 1, S, H, H, D, f32, causal=False, timed=True),
            paged_case(gen, ctx, 1, H, H, D, 16, bf, timed=True),
            paged_case(gen, [192], ENCDEC_CHUNK, H, H, D, 16, bf,
                       timed=True),
            paged_quant_case(gen, ctx, 1, H, H, D, 16, bf, "int8",
                             timed=True),
            kd_case(gen, 4 * 448, ENCDEC_DM, 0, ENCDEC_V, bf, timed=True,
                    inst="general")]


# ---------------------------------------------------------------------------
# phase 4: serve full-width TinyLlama-1.1B
# ---------------------------------------------------------------------------

def check_logits(params, cfg, M, prompt):
    """Prefill last-token logits and one paged decode step's logits,
    kernel path against plain path on the same weights and cache; the
    kernel path must launch flash and paged, the plain path nothing."""
    plain = cfg.replace(use_kernels=False)
    toks = torch.as_tensor(prompt, device="cuda")
    (lk, pc), n_k = _launched(lambda: M.prefill(params, cfg,
                                                 {"tokens": toks}))
    (lp, _), n_p = _launched(lambda: M.prefill(params, plain,
                                               {"tokens": toks}))
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
    cache2 = M._map(torch.clone, cache)
    (dk, _), m_k = _launched(lambda: M.decode_step(
        params, cfg, cache, tok, pos, block_tables=bt))
    (dp, _), m_p = _launched(lambda: M.decode_step(
        params, plain, cache2, tok, pos, block_tables=bt))
    if not (n_k["flash_attention"] and m_k["paged_attn"]) or any(
            n_p.values()) or any(m_p.values()):
        fail(f"logit check: kernel path launched {n_k} / {m_k}, plain path "
             f"{n_p} / {m_p}")
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

        def make_engine(ps=prompts, **kw):
            eng = PagedServeEngine(params, cfg, n_slots=n_slots,
                                   block_len=bl, seg_len=seg_len,
                                   max_len=max(lens) + max_new,
                                   device="cuda", **kw)
            for p in ps:
                eng.submit({"tokens": p}, max_new=max_new)
            return eng

        # warm-up run (allocator, cuBLAS handles, kernel first launches):
        # two requests launch every kernel of the path
        make_engine(prompts[:2]).run()
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
    unbucketed = _serve_readings(eng, comps, wall, peak_gb, seg_len)
    del eng      # its pool must not count in the bucketed run's peak
    with torch.no_grad():
        _, chunk_launches = _bucketed_serve(
            "serve", make_engine, prompts[:2], prompts, lens, max_new, cfg,
            seg_len, unbucketed, n_attn=cfg.n_layers)
        # on 8 of the 16 requests, every other: the script's time limit
        _f32_token_identity("serve", params, cfg, PagedServeEngine,
                            prompts[1::2], max_new, n_slots=n_slots,
                            block_len=bl, seg_len=seg_len,
                            max_len=max(lens) + max_new)
        # speculative decode (k SPEC_K) through a seeded MTP head, and the
        # samplers
        params["mtp"] = _mtp_head(M, cfg, 1)
        cfg_s = cfg.replace(n_mtp=1)

        def make_spec(ps=prompts, **kw):
            eng = PagedServeEngine(params, cfg_s, n_slots=n_slots,
                                   block_len=bl, seg_len=seg_len,
                                   max_len=max(lens) + max_new,
                                   device="cuda", **kw)
            for p in ps:
                eng.submit({"tokens": p}, max_new=max_new)
            return eng

        _, spec_launches = _spec_bf16_run(
            "serve", make_spec, prompts, lens, max_new, cfg_s, seg_len,
            _tokens(comps), n_attn=cfg.n_layers)
        _spec_f32_identity("serve", M, params, cfg_s, prompts[1::2],
                           max_new, n_slots=n_slots, bl=bl, seg_len=seg_len,
                           max_len=max(lens) + max_new)
        _sampler_checks("serve", params, cfg_s, prompts[:2], bl=bl)
        del params["mtp"]
    phase_profile(params, cfg, prompts[-1], make_engine, seg_len)
    return _sum_counts(launches, chunk_launches, spec_launches)


def profile(fn, top: int = 8, groups=None, ranges=()):
    """One call of ``fn`` under torch.profiler: host wall time, summed
    device kernel time (one stream, so kernels do not overlap), the
    device's idle share of the wall, and the kernels that took most.
    ``groups`` maps a name to kernel-name fragments; each group's summed
    device time is reported under ``group_ms``.  ``ranges`` names
    ``record_function`` ranges opened inside ``fn``: the device time of
    the kernels launched in each is reported under ``range_ms``."""
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
    # sums straight from the trace's events: key_averages() builds a
    # Python object for every op and kernel, tens of seconds for one
    # decode segment of a deep model
    by_name, launched_at, kernels = {}, {}, []
    spans = {r: [] for r in ranges}
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == DeviceType.CUDA:
            # device-side events only count (a CPU op's device time
            # repeats its kernels'); a range's device-side copy spans its
            # kernels, gaps included: not a kernel
            if name in ranges:
                continue
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + evt.duration_ns() / 1e3, n + 1)
            kernels.append((evt.correlation_id(), evt.duration_ns()))
        elif name in ranges:
            spans[name].append((evt.start_thread_id(), evt.start_ns(),
                                evt.end_ns()))
        elif ranges and name.startswith("cu"):
            # a CUDA API call (cudaLaunchKernel, cuLaunchKernel, ...):
            # its correlation id is its kernel's
            launched_at[evt.correlation_id()] = (evt.start_thread_id(),
                                                 evt.start_ns())
    range_ms = {}
    for r, sp in spans.items():
        # the device time of the kernels launched inside the range, on
        # the range's own thread
        ns = [d for c, d in kernels if c in launched_at and any(
            t == launched_at[c][0] and a <= launched_at[c][1] <= b
            for t, a, b in sp)]
        if sp and not ns:
            fail(f"the profile links no kernel to the range {r}")
        range_ms[r] = sum(ns) / 1e6
    rows = [(us, k, n) for k, (us, n) in by_name.items()]
    if not rows:
        fail("the profiler recorded no device events")
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    group_ms = {g: sum(us for us, k, _ in rows if any(f in k for f in frags))
                / 1e3 for g, frags in (groups or {}).items()}
    group_n = {g: sum(n for _, k, n in rows if any(f in k for f in frags))
               for g, frags in (groups or {}).items()}
    out = {"range_ms": range_ms} if ranges else {}
    return {**out, "wall_ms": wall * 1e3, "device_ms": device_ms,
            "group_ms": group_ms, "group_launches": group_n,
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
# bucketed chunked admission, run inside the serve phases
# ---------------------------------------------------------------------------

# the serve phases' prefill chunk: Mamba2's and Zamba2's ssm_chunk, so a
# prefill chunk is one scan chunk from the carried state.  The default
# ladder over the serve traffic (max_len 1088): 256, 512, 1024, 2048
CHUNK_LEN = 256
# the MoE's kernel-vs-plain check of prefill_chunked: chunks of 8 rows,
# whose capacity max(ceil(8 * 4 / 60) * 2, 8) = 8 holds every assignment,
# so the kernel path computes the plain path's dropless function
MOE_CHECK_CHUNK = 8
MOE_CHECK_LENS = (21, 13)


def _engine_run(make_engine):
    """One run of a fresh engine from counts at 0 and a reset peak:
    (engine, completions, wall s, launches, peak GB)."""
    eng = make_engine()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    comps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (eng, comps, wall, _counts(),
            torch.cuda.max_memory_allocated() / 1e9)


def _serve_readings(eng, comps, wall, peak_gb, seg_len):
    """The serving metrics of one engine run."""
    st = eng.stats
    steps = st["segments"] * seg_len
    ttft = sorted(c.ttft_s for c in comps.values())
    return {"requests": len(comps), "wall_s": wall,
            "tok_per_s": st["generated_tokens"] / wall,
            "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
            "admit_s": st["admit_s"], "ttft_p50_s": ttft[len(ttft) // 2],
            "ttft_max_s": ttft[-1], "peak_mem_gb": peak_gb,
            "prefills": st["prefills"],
            "prefill_chunks": st["prefill_chunks"], "decode_steps": steps}


def _check_served(label, eng, comps, lens, max_new, vocab):
    """Every request completed with max_new in-vocabulary tokens (one count
    for all, or a list by uid); a paged engine's pool drained."""
    if sorted(comps) != list(range(len(lens))):
        fail(f"{label}: completed {sorted(comps)}")
    for uid, c in comps.items():
        n = max_new[uid] if isinstance(max_new, (list, tuple)) else max_new
        if len(c.tokens) != n or c.prompt_len != lens[uid]:
            fail(f"{label} request {uid}: {len(c.tokens)} tokens, prompt "
                 f"{c.prompt_len}")
        if (c.tokens < 0).any() or (c.tokens >= vocab).any():
            fail(f"{label} request {uid}: token ids out of range")
    alloc = getattr(eng, "alloc", None)
    if alloc is not None and (alloc.n_free != eng.n_blocks - 1
                              or eng._slot_blocks):
        fail(f"{label}: the block pool did not drain")


def _bucketed_launches(label, eng, launches, seg_len, *, n_attn, n_ssm=0,
                       n_moe=0):
    """The bucketed run went through chunked admission alone: per prefill
    chunk n_attn paged launches of CHUNK_LEN rows, n_ssm scans from a
    carried state, a MoE layer's grouped FFN and two dispatch/combine;
    per decode step n_attn paged launches of one row and the MoE's; no
    flash (no one-shot prefill)."""
    chunks = eng.stats["prefill_chunks"]
    steps = eng.stats["segments"] * seg_len
    calls = chunks + steps
    want = {**dict.fromkeys(launches, 0),
            "paged_attn": n_attn * calls, "paged_attn_chunk": n_attn * chunks,
            "ssd_scan": n_ssm * chunks, "ssd_scan_h0": n_ssm * chunks,
            "grouped_ffn": n_moe * calls,
            "gather_scatter_add": 2 * n_moe * calls}
    if launches != want or not (chunks and steps):
        fail(f"{label}: bucketed launches {launches} != expected {want} "
             f"({chunks} prefill chunks, {steps} decode steps)")


def _bucketed_serve(label, make_engine, warm, prompts, lens, max_new, cfg,
                    seg_len, unbucketed, warm_new=None, **n):
    """The phase's traffic through its engine with chunk_len CHUNK_LEN
    (default ladder), after a warm-up on ``warm`` (generating
    ``warm_new`` tokens a request where ``make_engine`` takes ``new``):
    the completions, the launches (``_bucketed_launches``), the readings
    beside the unbucketed run's (``unbucketed``, from
    ``_serve_readings``).  Returns (readings, launches)."""
    make_engine(warm, chunk_len=CHUNK_LEN,
                **({} if warm_new is None else {"new": warm_new})).run()
    eng, comps, wall, launches, peak = _engine_run(
        lambda: make_engine(prompts, chunk_len=CHUNK_LEN))
    if eng.buckets != (256, 512, 1024, 2048):
        fail(f"{label}: ladder {eng.buckets}")
    _check_served(f"{label} bucketed", eng, comps, lens, max_new,
                  cfg.vocab_size)
    _bucketed_launches(f"{label} bucketed", eng, launches, seg_len, **n)
    res = {"chunk_len": CHUNK_LEN, "ladder": list(eng.buckets),
           "bucketed": _serve_readings(eng, comps, wall, peak, seg_len),
           "unbucketed": unbucketed, "launches": launches}
    print(f"{label} bucketed ({CARD}) " + json.dumps(res))
    return res, launches


def _f32_token_identity(label, params, cfg, cls, prompts, max_new, *,
                        chunk_len=CHUNK_LEN, **kw):
    """The f32 model (these weights cast) served unbucketed and bucketed
    (chunks of ``chunk_len``) through ``cls`` on the same traffic (token
    arrays, or request batches whose frontend rows the engine casts):
    the completions must be equal token for token."""
    from repro_torch.utils.pytree import tree_map
    p32 = tree_map(lambda t: t.float(), params)
    c32 = cfg.replace(dtype="float32")
    runs = []
    for bkw in ({}, {"chunk_len": chunk_len}):
        eng = cls(p32, c32, device="cuda", **kw, **bkw)
        for p in prompts:
            eng.submit(p if isinstance(p, dict) else {"tokens": p},
                       max_new=max_new)
        runs.append({u: c.tokens.tolist() for u, c in eng.run().items()})
        del eng
    del p32
    torch.cuda.empty_cache()
    plain, bucketed = runs
    diff = [(u, next(i for i, (a, b) in enumerate(zip(t, bucketed[u]))
                     if a != b))
            for u, t in plain.items() if t != bucketed[u]]
    res = {"requests": len(plain), "tokens": sum(map(len, plain.values())),
           "requests_differing": len(diff)}
    print(f"{label} f32 bucketed vs unbucketed ({CARD}) " + json.dumps(res))
    if diff or sorted(plain) != sorted(bucketed):
        fail(f"{label}: f32 bucketed completions differ from unbucketed "
             f"ones at (request, first position) {diff}")
    return res


def _chunked_prefill_logits(M, params, cfg, toks, C, bl=16):
    """``prefill_chunked`` of one prompt toks (1, P) in chunks of C through
    a fresh one-slot paged cache (rung: P rounded up to C): the last real
    token's logits (1, V)."""
    P = toks.shape[1]
    rung = -(-P // C) * C
    W = -(-rung // bl)
    cache = M.init_paged_cache(cfg, 1, W + 1, bl, device="cuda")
    table = torch.arange(1, W + 1, dtype=torch.int32, device="cuda")[None]
    padded = torch.zeros((1, rung), dtype=torch.int32, device="cuda")
    padded[:, :P] = toks
    logits, _ = M.prefill_chunked(params, cfg, cache, {"tokens": padded}, P,
                                  chunk_len=C, block_tables=table)
    return logits


def _sum_counts(*runs):
    """Launch counts of several runs, summed by name."""
    out = {}
    for run in runs:
        for k, v in run.items():
            out[k] = out.get(k, 0) + v
    return out


def _rms(a, b):
    return (a.float() - b.float()).pow(2).mean().sqrt().item()


# ---------------------------------------------------------------------------
# speculative MTP decode and the samplers, inside phase_serve (TinyLlama with
# a seeded MTP head) and phase_serve_mla (DeepSeek-V3's own head)
# ---------------------------------------------------------------------------

SPEC_K = 3                 # drafts a step (the launcher's --n-draft)
# the oracle runs' max_new: 1 + 15 x (k+1), so that every live step can
# emit k+1 tokens; a greedy run's first 61 tokens are its 64-token run's
SPEC_ORACLE_NEW = 61
# DeepSeek-V3's f32 identity at 2 slots: 4 requests, 1 + 8 x (k+1) tokens
SPEC_MLA_NEW = 33
SPEC_T = 0.8               # the samplers' temperature
SPEC_TOPK = 40
SPEC_SAMPLE_NEW = 16
# the reference's test of _residual_verify: V 6, N 20,000, atol 0.02
SPEC_MARGINAL_N = 20000
SPEC_MARGINAL_ATOL = 0.02
# TopK at the model's V over this many draws: a uniform that rounds to 1
# (a 24-bit map's largest) emits a masked token about (V - k) * 2**-24 of
# draws, 0.0019 at V 32,000, so about 31 expected here
SPEC_TOPK_ROWS = 16384
SPEC_LOGITS = (1.2, -0.3, 0.7, 2.0, -1.0, 0.1)


class _Oracle:
    """Replaces ``model._mtp_draft`` while in use (a ``with`` block): the
    draft called at position p for the request in slot s proposes the
    token its plain run emitted at position p + 2 (``plain`` {uid:
    tokens}, ``pos0`` {uid: its first decode position}); with
    ``wrong_depth`` the drafts of that chain depth are off by one.  Its
    logits are one-hot; the hidden it passes on is its input."""

    def __init__(self, M, eng, plain, pos0, wrong_depth=None):
        self.M, self.own, self.eng = M, M._mtp_draft, eng
        self.wrong, self.calls = wrong_depth, 0
        n, L = max(plain) + 1, max(map(len, plain.values()))
        seq = torch.zeros((n + 1, L), dtype=torch.long)
        first = torch.zeros((n + 1,), dtype=torch.long)
        for u, t in plain.items():
            seq[u, :len(t)] = torch.as_tensor(t)
            first[u] = pos0[u]
        self.seq, self.pos0, self.free = seq.cuda(), first.cuda(), n

    def __call__(self, params, cfg, h, tok, pos):
        depth = self.calls % self.eng.speculate
        self.calls += 1
        uid = torch.as_tensor(self.eng.slot_uid, device="cuda")
        uid = torch.where(uid < 0, self.free, uid)
        i = pos.long() + 2 - self.pos0[uid]
        L = self.seq.shape[1]
        t = self.seq[uid, i.clamp(0, L - 1)]
        t = torch.where((i >= 0) & (i < L), t, 0)
        if depth == self.wrong:
            t = (t + 1) % cfg.vocab_size
        logits = torch.zeros((tok.shape[0], cfg.vocab_size), device="cuda")
        return logits.scatter_(1, t[:, None], 1.0), h

    def __enter__(self):
        self.M._mtp_draft = self
        return self

    def __exit__(self, *exc):
        self.M._mtp_draft = self.own


def _tokens(comps):
    return {u: c.tokens.tolist() for u, c in comps.items()}


def _first_divergence(got, want):
    """{uid: first position where two runs' completions differ}, for the
    requests that differ."""
    return {u: next((i for i, (a, b) in enumerate(zip(t, want[u]))
                     if a != b), min(len(t), len(want[u])))
            for u, t in got.items() if t != want[u]}


def _spec_stats(eng):
    st = eng.stats
    return {"acceptance": eng.spec_acceptance(),
            "spec_steps": st["spec_steps"],
            "spec_extra_tokens": st["spec_extra_tokens"]}


def _nonzero_past_frontier(M, cfg, eng):
    """Nonzero elements of a contiguous engine's sequence leaves in the
    rows past each slot's final position."""
    from repro_torch.utils.pytree import tree_leaves
    n = 0
    for leaf, sax in zip(tree_leaves(eng.cache), tree_leaves(
            M.decode_cache_seq_axes(cfg, eng.policy))):
        if sax < 0:
            continue
        for s in range(eng.n_slots):
            n += int(leaf[:, s, int(eng.pos[s]) + 1:].count_nonzero())
    return n


def _mtp_head(M, cfg, seed):
    """A seeded MTP head for ``cfg``, drawn on the card (from a one-layer
    model with ``n_mtp=1``)."""
    return M.init_params(cfg.replace(n_mtp=1, n_layers=1),
                         generator=torch.Generator(
                             device="cuda").manual_seed(seed))["mtp"]


def _oracle_runs(label, M, make, prompts, want, pos0):
    """The oracle drafter through ``make(new=...)``'s engine: drafts equal
    to the plain tokens ``want`` all accepted (acceptance exactly 1.0,
    every live step k+1 tokens), then one chain depth wrong (acceptance
    strictly between 0 and 1); the tokens equal ``want`` in both."""
    new = len(next(iter(want.values())))
    res = {}
    for wrong in (None, 1):
        eng = make(new=new)
        with _Oracle(M, eng, want, pos0, wrong):
            got = _tokens(eng.run())
        r = _spec_stats(eng)
        res["right" if wrong is None else "wrong_depth_1"] = r
        steps = len(prompts) * ((new - 1) // (SPEC_K + 1))
        if got != want:
            fail(f"{label}: the oracle drafter's tokens differ from plain "
                 f"decode at {_first_divergence(got, want)}")
        if wrong is None and not (r["acceptance"] == 1.0
                                  and r["spec_steps"] == steps):
            fail(f"{label}: the right oracle's acceptance {r} (expected "
                 f"1.0 over {steps} live steps)")
        if wrong is not None and not 0.0 < r["acceptance"] < 1.0:
            fail(f"{label}: a wrong oracle's acceptance {r['acceptance']}")
    return res


def _spec_f32_identity(label, M, params, cfg, prompts, max_new, *, n_slots,
                       bl, seg_len, max_len):
    """The f32 model (these weights cast, the MTP head's too): speculative
    (k SPEC_K) completions equal the plain greedy ones token for token
    through both engines, unbucketed and bucketed; the oracle drafter
    (``_oracle_runs``) through the paged engine; after a wrong-oracle run
    of the contiguous engine no nonzero row past any slot's frontier, and
    with the scrub skipped, some (or other tokens)."""
    from repro_torch.serve import PagedServeEngine, ServeEngine
    from repro_torch.utils.pytree import tree_map
    t0 = time.perf_counter()
    p32 = tree_map(lambda t: t.float(), params)
    c32 = cfg.replace(dtype="float32")

    def make(cls, ps=prompts, new=max_new, **kw):
        extra = {"block_len": bl} if cls is PagedServeEngine else {}
        eng = cls(p32, c32, n_slots=n_slots, seg_len=seg_len,
                  max_len=max_len, device="cuda", **extra, **kw)
        for p in ps:
            eng.submit({"tokens": p}, max_new=new)
        return eng

    res, plain = {}, {}
    for cls in (PagedServeEngine, ServeEngine):
        plain[cls] = _tokens(make(cls).run())
        for bkw in ({}, {"chunk_len": CHUNK_LEN}):
            eng = make(cls, speculate=SPEC_K, **bkw)
            got = _tokens(eng.run())
            tag = cls.__name__ + (" bucketed" if bkw else "")
            diff = _first_divergence(got, plain[cls])
            res[tag] = {**_spec_stats(eng), "requests_differing": len(diff),
                        "ms_per_decode_step": 1e3 * eng.stats["decode_s"]
                        / (eng.stats["segments"] * seg_len)}
            if diff or not eng.stats["spec_steps"]:
                fail(f"{label}: f32 speculative completions ({tag}) differ "
                     f"from plain ones at (request, position) {diff}")
            del eng
    pos0 = {u: M.decode_pos0(c32, p.shape[1]) for u, p in enumerate(prompts)}
    want = {cls: {u: t[:SPEC_ORACLE_NEW] for u, t in plain[cls].items()}
            for cls in plain}
    res["oracle"] = _oracle_runs(
        label, M, lambda new: make(PagedServeEngine, new=new,
                                   speculate=SPEC_K),
        prompts, want[PagedServeEngine], pos0)
    scrub = {}
    for on in (True, False):
        own = M._spec_zero_rejected
        if not on:
            M._spec_zero_rejected = lambda *a, **kw: None
        try:
            eng = make(ServeEngine, new=SPEC_ORACLE_NEW, speculate=SPEC_K)
            with _Oracle(M, eng, want[ServeEngine], pos0, 1):
                got = _tokens(eng.run())
        finally:
            M._spec_zero_rejected = own
        scrub["scrubbed" if on else "not_scrubbed"] = {
            "nonzero_past_frontier": _nonzero_past_frontier(M, c32, eng),
            "tokens_equal": got == want[ServeEngine]}
        del eng
    res["scrub"] = scrub
    res["wall_s"] = time.perf_counter() - t0
    del p32
    torch.cuda.empty_cache()
    print(f"{label} f32 speculative vs plain ({CARD}) " + json.dumps(res))
    ok, bad = scrub["scrubbed"], scrub["not_scrubbed"]
    if ok["nonzero_past_frontier"] or not ok["tokens_equal"]:
        fail(f"{label}: after the scrub {ok}")
    if not (bad["nonzero_past_frontier"] or not bad["tokens_equal"]):
        fail(f"{label}: skipping the scrub leaves the tokens and the rows "
             f"past the frontier as they were: the check cannot see it")
    return res


def _spec_bf16_run(label, make_engine, prompts, lens, max_new, cfg, seg_len,
                   plain, *, n_attn):
    """The traffic speculatively (k SPEC_K) from counts at 0: the
    completions, the launches (per decode step n_attn paged launches of
    k+1 rows and k flash launches at S 1, the draft block's; per prefill
    n_attn flash), the readings, acceptance and each request's first
    divergence from ``plain`` ({uid: tokens})."""
    eng, comps, wall, launches, peak = _engine_run(
        lambda: make_engine(prompts, speculate=SPEC_K))
    _check_served(f"{label} speculative", eng, comps, lens, max_new,
                  cfg.vocab_size)
    steps = eng.stats["segments"] * seg_len
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": n_attn * eng.stats["prefills"]
            + SPEC_K * steps,
            "paged_attn": n_attn * steps, "paged_attn_chunk": n_attn * steps}
    if launches != want or not eng.stats["spec_steps"]:
        fail(f"{label} speculative: launches {launches} != expected {want}")
    diff = _first_divergence(_tokens(comps), plain)
    res = {"k": SPEC_K, **_serve_readings(eng, comps, wall, peak, seg_len),
           **_spec_stats(eng), "first_divergence": diff,
           "requests_equal": len(comps) - len(diff), "launches": launches}
    print(f"{label} speculative bf16 ({CARD}) " + json.dumps(res))
    return res, launches


def _sampler_checks(label, params, cfg, prompts, *, bl):
    """The samplers on the card: Temperature(SPEC_T) and TopK(SPEC_TOPK,
    SPEC_T) through the paged engine (2 slots, the requests given), the
    same tokens at seg_len 8 and 3 (speculative verification's marginal
    is held below); the stream's draws on the card equal the CPU's bit
    for bit; TopK at the model's V over SPEC_TOPK_ROWS draws emits no
    token outside the top k, where a 24-bit uniform map must;
    ``_residual_verify``'s empirical marginal (V 6, N SPEC_MARGINAL_N)
    within SPEC_MARGINAL_ATOL of the target, acceptance p(draft), no
    rejection emitting the draft, where accepting without the uniform
    must miss."""
    from repro_torch.serve import PagedServeEngine, Temperature, TopK
    from repro_torch.serve import sampling as S
    from repro_torch.utils import rng as R
    t0 = time.perf_counter()
    max_len = max(p.shape[1] for p in prompts) + SPEC_SAMPLE_NEW
    runs = {}
    for sampler in (Temperature(SPEC_T), TopK(SPEC_TOPK, SPEC_T)):
        outs = []
        for seg in (8, 3):
            eng = PagedServeEngine(params, cfg, n_slots=2, block_len=bl,
                                   seg_len=seg, max_len=max_len,
                                   sampler=sampler, device="cuda", seed=5)
            for p in prompts:
                eng.submit({"tokens": p}, max_new=SPEC_SAMPLE_NEW)
            outs.append(_tokens(eng.run()))
        tag = type(sampler).__name__
        runs[tag] = {"equal_at_seg_len_8_and_3": outs[0] == outs[1],
                     "tokens": sum(map(len, outs[0].values()))}
        if outs[0] != outs[1]:
            fail(f"{label} {tag}: tokens differ between seg_len 8 and 3 "
                 f"at {_first_divergence(outs[1], outs[0])}")
    V = cfg.vocab_size
    keys = [R.stream_key(0, u) for u in range(8)]
    streams = [R.Stream.of(keys, list(range(8)), d).advance(5).at(2)
               for d in ("cuda", "cpu")]
    bits = [st.bits(site, V).cpu() for st in streams for site in (0, 1)]
    logits = torch.randn((8, V), generator=torch.Generator().manual_seed(0))
    toks = [smp(st, logits.to(st.key.device)).cpu()
            for st in streams for smp in (Temperature(SPEC_T),
                                          TopK(SPEC_TOPK, SPEC_T))]
    draws = {"bits_equal": torch.equal(bits[0], bits[2])
             and torch.equal(bits[1], bits[3]),
             "sampled_equal": torch.equal(toks[0], toks[2])
             and torch.equal(toks[1], toks[3])}
    if not draws["bits_equal"]:
        fail(f"{label}: the stream's draws on the card differ from the CPU's")

    def outside_topk():
        g = torch.Generator(device="cuda").manual_seed(1)
        n, rows = 0, 4096
        for c in range(SPEC_TOPK_ROWS // rows):
            lg = torch.randn((rows, V), device="cuda", generator=g)
            st = R.Stream.of([R.stream_key(9, c * rows + i)
                              for i in range(rows)], [0] * rows, "cuda")
            tok = TopK(SPEC_TOPK, SPEC_T)(st, lg).long()
            kth = torch.topk(lg, SPEC_TOPK, -1).values[:, -1]
            n += int((lg.gather(1, tok[:, None])[:, 0] < kth).sum())
        return n

    own = R.bits_to_uniform
    R.bits_to_uniform = lambda b: ((b >> 8).float() + 0.5) * 2.0 ** -24
    try:
        fault = outside_topk()
    finally:
        R.bits_to_uniform = own
    draws["topk_outside"] = {"draws": SPEC_TOPK_ROWS, "V": V,
                             "emitted": outside_topk(),
                             "24-bit map": fault}
    if draws["topk_outside"]["emitted"]:
        fail(f"{label}: TopK emitted tokens outside its top k "
             f"{draws['topk_outside']}")
    if not fault:
        fail(f"{label}: a 24-bit uniform map emits no token outside the "
             f"top k: the check cannot see a uniform of 1")
    N = SPEC_MARGINAL_N
    lg = torch.tensor(SPEC_LOGITS, device="cuda").expand(N, -1).contiguous()
    target = torch.softmax(torch.tensor(SPEC_LOGITS, dtype=torch.float64)
                           / SPEC_T, -1)
    st = R.Stream.of([R.stream_key(3, i) for i in range(N)], [0] * N, "cuda")

    def marginal(d, fault):
        draft = torch.full((N,), d, dtype=torch.int32, device="cuda")
        u_acc = (torch.zeros(N, device="cuda") if fault
                 else st.uniform(0, 1)[:, 0])
        tok, acc = S._residual_verify(u_acc, st.uniform(1, lg.shape[1]), lg,
                                      draft, SPEC_T)
        emp = torch.bincount(tok.long(), minlength=lg.shape[1]).double() / N
        return {"max_marginal_err": (emp.cpu() - target).abs().max().item(),
                "acceptance_err": abs(acc.double().mean().item()
                                      - target[d].item()),
                "rejection_emits_draft": bool((tok[~acc] == d).any())}

    def holds(r):
        return (r["max_marginal_err"] <= SPEC_MARGINAL_ATOL
                and r["acceptance_err"] <= SPEC_MARGINAL_ATOL
                and not r["rejection_emits_draft"])

    verify = {f"draft {d}": marginal(d, False) for d in (3, 4)}
    verify["accept without the uniform"] = marginal(3, True)
    res = {"engines": runs, "stream": draws, "residual_verify": verify,
           "wall_s": time.perf_counter() - t0}
    print(f"{label} samplers ({CARD}) " + json.dumps(res))
    if not (holds(verify["draft 3"]) and holds(verify["draft 4"])):
        fail(f"{label}: _residual_verify's marginal on the card {verify}")
    if holds(verify["accept without the uniform"]):
        fail(f"{label}: accepting without the uniform holds the marginal "
             f"check: it cannot see the acceptance draw")
    return res


def _mla_spec_f32(M, p32, c32, prompts):
    """DeepSeek-V3's f32 model at 2 slots (a verify chunk's 8 rows fit
    every expert's capacity of 8, so nothing drops): speculative (k
    SPEC_K) completions of 4 requests equal plain greedy ones, and the
    oracle drafter's too, at acceptance 1.0."""
    from repro_torch.serve import PagedServeEngine
    t0 = time.perf_counter()
    ps = prompts[:4]
    max_len = max(p.shape[1] for p in ps) + SPEC_MLA_NEW

    def make(new=SPEC_MLA_NEW, **kw):
        eng = PagedServeEngine(p32, c32, n_slots=2, block_len=16, seg_len=8,
                               max_len=max_len, device="cuda", **kw)
        for p in ps:
            eng.submit({"tokens": p}, max_new=new)
        return eng

    plain = _tokens(make().run())
    eng = make(speculate=SPEC_K)
    got = _tokens(eng.run())
    res = {"slots": 2, "requests": len(ps), **_spec_stats(eng),
           "first_divergence": _first_divergence(got, plain)}
    if got != plain:
        fail(f"serve_mla: f32 speculative completions differ from plain "
             f"ones at {res['first_divergence']}")
    pos0 = {u: M.decode_pos0(c32, p.shape[1]) for u, p in enumerate(ps)}
    res["oracle"] = _oracle_runs(
        "serve_mla f32", M, lambda new: make(new, speculate=SPEC_K), ps,
        plain, pos0)
    res["wall_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# phase 5a: serve full-width TinyLlama-1.1B from a quantized (int8/fp8) KV pool
# ---------------------------------------------------------------------------

KV_QUANT = ("int8", "fp8")
KV_CHECK_STEPS = 8
# TinyLlama-1.1B at full width, its depth cut from 22 layers to 11 to keep
# the whole script's time (the host's launch chain, not the card, sets a
# decode step's time, about in proportion to depth); the limits below
# were set from readings at 22 layers
SERVE_KV_LAYERS = 11
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
        for stack in cache.values():
            for e in stack.values():
                for key, leaf in e.items():
                    if key.endswith("_scale"):
                        leaf.fill_(1.0)
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
    branch of the paged kernel once a layer a decode step and the
    unquantized branch never.  TinyLlama is cut to SERVE_KV_LAYERS of its
    22 layers.  Reports tok/s, ms per decode step, TTFT,
    the pool's bytes, peak memory and agreement with the first bf16 run's
    tokens; then the logit checks, the equal-bytes reading and a profile
    of an int8 decode segment."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.models import model as M
    from repro_torch.models import quant
    from repro_torch.serve import PagedServeEngine

    cfg = get_config("tinyllama-1.1b", variant="full").replace(
        n_layers=SERVE_KV_LAYERS)
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
        h, _, _, _ = M.backbone(params, cfg, {"tokens": toks})
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

    res = {"len": S, "max_abs_logit": q32.abs().max().item(),
           "f32_kernel_vs_plain": (k32 - q32).abs().max().item(),
           "f32_kernel_to_f64_scan": (k32 - o64).abs().max().item(),
           "f32_plain_to_f64_scan": (q32 - o64).abs().max().item(),
           "bf16_kernel_to_f32_rms": _rms(kb, q32),
           "bf16_plain_to_f32_rms": _rms(qb, q32),
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


def _ssd_on_tensor_cores(by_instance, n, phase="serve_ssm"):
    """Every scan launch of the phase's run took the tc instance: the
    model's bf16 views of its conv output (Mamba2: row stride 4352
    elements, B and C at byte offsets 8192 and 8448), none on the CUDA
    cores."""
    want = {"tc": n, "general": 0, "f32": 0}
    print(f"{phase}: ssd_scan launches by instance {by_instance}")
    if by_instance != want:
        fail(f"{phase}: ssd_scan launches by instance {by_instance}, "
             f"expected {want}")


def phase_serve_ssm():
    """Full-width, full-depth Mamba2-1.3B (bf16, random weights from seed
    0) behind ``PagedServeEngine`` with 8 slots: 8 of the 16 greedy
    requests of 128-1024 prompt tokens (every other, for the script's
    time limit), 64 new tokens each, after a warm-up run.
    Checks the completions, the SSD kernel's launches on that run (48 per
    prefill, every one in the tc instance), the logit checks (i)-(iii) on
    two prompts, and profiles one 1024-token prefill and one decode
    segment."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine, ServeEngine

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
        # the main path on 8 of the 16 requests, every other
        max_len = max(lens) + max_new
        prompts, lens = prompts[1::2], lens[1::2]

        def make_engine(ps=prompts):
            eng = PagedServeEngine(params, cfg, n_slots=n_slots,
                                   seg_len=seg_len, max_len=max_len,
                                   device="cuda")
            for p in ps:
                eng.submit({"tokens": p}, max_new=max_new)
            return eng

        # warm-up: two requests launch every kernel of the path
        make_engine(prompts[:2]).run()
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

    # bucketed admission through the contiguous engine (the unbucketed
    # run's paged engine holds no pool for this family: the same layout)
    def make_contiguous(ps, **kw):
        e = ServeEngine(params, cfg, n_slots=n_slots, seg_len=seg_len,
                        max_len=max_len, device="cuda", **kw)
        for p in ps:
            e.submit({"tokens": p}, max_new=max_new)
        return e

    unbucketed = _serve_readings(eng, comps, wall, peak_gb, seg_len)
    del eng      # its state must not count in the bucketed run's peak
    with torch.no_grad():
        _, chunk_launches = _bucketed_serve(
            "serve_ssm", make_contiguous, prompts[:2], prompts, lens,
            max_new, cfg, seg_len, unbucketed, n_attn=0, n_ssm=cfg.n_layers)
        _ssd_on_tensor_cores(dict(ssd_ops.LAUNCHES_BY_INSTANCE),
                             chunk_launches["ssd_scan"], "serve_ssm bucketed")
        _f32_token_identity("serve_ssm", params, cfg, ServeEngine,
                            prompts, max_new, n_slots=n_slots,
                            seg_len=seg_len, max_len=max_len)

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
    return _sum_counts(launches, chunk_launches)


# ---------------------------------------------------------------------------
# phase 5c: serve the paper's two global MoEs, and StarCoder2-3B
# ---------------------------------------------------------------------------

SERVE_MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
# DeepSeek-MoE-16B on 14 of its 28 layers (the script's time limit, for
# serve_sharded); Qwen1.5-MoE-A2.7B at full depth
SERVE_MOE_LAYERS = {"deepseek-moe-16b": 14}
MOE_DECODE_STEPS = 4        # (b): decode steps from one shared cache
MOE_DEAD_SLOT = 3           # the freed slot of the dead-lane check
STARCODER_REQUESTS = 4


def _launched(fn):
    """(fn's result, the kernel launches it made, by name)."""
    n0 = _counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - n0[k] for k, v in _counts().items()}


class _RouteTap:
    """Wraps ``moe.route`` while in use (a ``with`` block): ``record``
    collects each call's (x, w, idx), or idx alone with ``ids_only``, or
    (idx, live) with ``with_live``;
    ``replay`` (a list of another run's idx, in call order: forward,
    then remat's recompute) makes the run take those expert choices,
    with weights and load-balance loss from its own router
    probabilities at them, and counts in ``replaced`` the tokens whose
    choice it changed."""

    def __init__(self, moe, *, ids_only=False, replay=None, with_live=False):
        self.moe, self.own = moe, moe.route
        self.ids_only, self.replay = ids_only, replay
        self.with_live = with_live
        self.record, self.replaced = [], []

    def __call__(self, p, c, x, live=None):
        w, idx, aux = self.own(p, c, x, live)
        if self.replay is not None:
            want = self.replay[len(self.replaced)]
            self.replaced.append(int((torch.sort(idx, -1).values != torch.sort(
                want, -1).values).any(-1).sum()))
            probs = torch.softmax(x.float() @ p["router"], dim=-1)
            w = probs.gather(-1, want)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            if live is not None:
                w = torch.where(live[:, None], w, torch.zeros_like(w))
            idx, aux = want, self.moe.load_balance_loss(c, probs, want)
        self.record.append((idx, live) if self.with_live else
                           idx if self.ids_only else (x, w, idx))
        return w, idx, aux

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.own


def _check_layers(n_moe):
    """The MoE layers the layer checks read: the first, middle and last."""
    return sorted({0, n_moe // 2, n_moe - 1})


def _moe_layer_check(cfg, p, x, w, idx, label):
    """(a): one MoE layer's routed FFN on the path's own inputs (x, w, idx
    as the kernel run routed them), each stage of ``moe_ffn`` against its
    plain version by the kernels phase's per-element rule: the dispatch
    and the combine against ``gather_scatter_add_ref`` on the same
    layouts (f32 sums rounded once, as ``gsa_case`` holds them), the
    grouped FFN against ``grouped_ffn_ref`` on the kernel's buffer.
    ``moe_ffn`` itself must equal the staged kernels bit for bit; its
    distance to ``moe_ffn_capacity_ref`` (the same capacity from the
    reference's plain pieces, whose scatter-adds round each product to
    bf16) is reported."""
    from repro_torch.kernels.moe_dispatch import ops as md
    from repro_torch.kernels.moe_dispatch.ref import gather_scatter_add_ref
    from repro_torch.kernels.moe_gemm import ops as mg
    from repro_torch.kernels.moe_gemm import ref as mref
    T, D = x.shape
    k = idx.shape[1]
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    E = wg.shape[0]
    cap = max(-(-T * k // E) * 2, 8)
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device=x.device) // k
    pos, keep = md.capacity_positions(flat_e, cap)
    slot = flat_e * cap + pos
    lay = md.routing_layouts(flat_tok, slot, keep, E * cap, T, k=k)
    by_slot, by_token = lay
    tag = f"{label} T={T} E={E} k={k} cap={cap}"
    buf = md.token_dispatch(x, flat_tok, slot, keep, E * cap, layouts=lay)
    rows = [check_close(f"{tag} dispatch", buf, gather_scatter_add_ref(
        x, by_token.ids, by_slot.ids, keep.float(), E * cap))]
    xb = buf.reshape(E, cap, D)
    y = mg.grouped_ffn_fwd(xb, wg, wu, wo, act=cfg.act).reshape(E * cap, D)
    rows.append(check_close(f"{tag} grouped_ffn", y, mref.grouped_ffn_ref(
        xb, wg, wu, wo, act=cfg.act).reshape(E * cap, D)))
    wf = w.reshape(-1)
    out = md.token_combine(y, flat_tok, slot, keep, wf, T, layouts=lay)
    rows.append(check_close(f"{tag} combine", out, gather_scatter_add_ref(
        y, by_slot.ids, by_token.ids, torch.where(keep, wf, 0.0), T)))
    whole = mg.moe_ffn(x, w, idx, wg, wu, wo, act=cfg.act)
    if not torch.equal(whole, out.to(x.dtype)):
        fail(f"{tag}: moe_ffn differs from its own stages")
    plain = mref.moe_ffn_capacity_ref(x, w, idx, wg, wu, wo, act=cfg.act)
    return {"layer": label, "T": T, "cap": cap,
            "dropped": int((~keep).sum()),
            "stage_err_over_limit": [round(r["err_over_limit"], 4)
                                     for r in rows],
            "moe_ffn_vs_capacity_ref_max_abs": (
                whole.float() - plain.float()).abs().max().item(),
            "max_abs_out": plain.float().abs().max().item()}


def _moe_decode_checks(M, moe, mg_ops, params, cfg, eng, n_moe):
    """(b), the dead-lane check and (a) at the decode shape, from the
    engine's cache with its 8 slots live: MOE_DECODE_STEPS greedy steps
    on the kernel path and the same tokens on the plain path
    (``use_kernels=False``, replaying the kernel run's expert choices:
    a near-tied choice resolved the other way by rounding would change
    which experts a token meets), each from its own copy of the cache;
    logits of every step within LOGIT_TOL.  Then one decode step twice
    with slot MOE_DEAD_SLOT freed (trash block, position 0, live False)
    and different garbage in it (token, trash block contents): the live
    rows' logits bit-identical, the dead row's routed output exactly 0
    in every MoE layer."""
    eng._pre_segment()   # claims the blocks of the coming writes
    dev = "cuda"
    bt = torch.as_tensor(eng.block_tables, device=dev)
    tok0 = torch.as_tensor(eng.tok, device=dev)
    pos0 = torch.as_tensor(eng.pos, device=dev)
    plain = cfg.replace(use_kernels=False)
    cache_k, cache_p = (M._map(torch.clone, eng.cache) for _ in "kp")

    def steps(c, cache, feed=None):
        tok, pos, out, fed = tok0.clone(), pos0.clone(), [], []
        for s in range(MOE_DECODE_STEPS):
            logits, _ = M.decode_step(params, c, cache, tok[:, None], pos,
                                      block_tables=bt)
            out.append(logits)
            fed.append(tok)
            tok = (feed[s + 1] if feed is not None and s + 1 < len(feed)
                   else torch.argmax(logits, -1).to(torch.int32))
            pos = pos + 1
        return out, fed

    with _RouteTap(moe) as tap_k:
        (lk, fed), n_k = _launched(lambda: steps(cfg, cache_k))
    with _RouteTap(moe, replay=[i for _, _, i in tap_k.record]) as tap_p:
        (lp, _), n_p = _launched(lambda: steps(plain, cache_p, fed))
    errs = [(a - b).abs().max().item() for a, b in zip(lk, lp)]
    # MLA's latent cache is read through the block-table gather
    paged_ok = (n_k["paged_attn"] == 0 if cfg.attn_type == "mla"
                else n_k["paged_attn"] > 0)
    if not (paged_ok and n_k["grouped_ffn"]
            and n_k["gather_scatter_add"]) or any(n_p.values()):
        fail(f"decode check: kernel run launched {n_k}, plain run {n_p}")
    if not all(math.isfinite(e) and e <= LOGIT_TOL for e in errs):
        fail(f"decode logits, kernel vs plain path: {errs} > {LOGIT_TOL}")
    del cache_p
    decode_rows = [_moe_layer_check(cfg, M._layer(
        params["blocks"]["sub0"]["moe"], g), *tap_k.record[g],
        f"moe layer {g} decode") for g in _check_layers(n_moe)]

    # the dead lane, twice with different garbage
    d = MOE_DEAD_SLOT
    live = torch.ones_like(tok0, dtype=torch.bool)
    live[d] = False
    bt_d, pos_d = bt.clone(), pos0.clone()
    bt_d[d], pos_d[d] = 0, 0
    routed, own_ffn = [], mg_ops.moe_ffn

    def recording_ffn(*a, **kw):
        out = own_ffn(*a, **kw)
        routed.append(out)
        return out
    outs = []
    mg_ops.moe_ffn = recording_ffn
    try:
        for garbage in (11, cfg.vocab_size - 7):
            for leaf in (M._leaves(cache_k)):
                leaf[:, 0].normal_()       # new garbage in the trash block
            t = tok0.clone()
            t[d] = garbage
            lg, _ = M.decode_step(params, cfg, cache_k, t[:, None], pos_d,
                                  block_tables=bt_d, live=live)
            outs.append(lg)
    finally:
        mg_ops.moe_ffn = own_ffn
    torch.cuda.synchronize()
    if len(routed) != 2 * n_moe:
        fail(f"dead lane: {len(routed)} routed outputs, expected {2 * n_moe}")
    dead_nonzero = sum(int((r[d] != 0).sum()) for r in routed)
    live_same = torch.equal(outs[0][live], outs[1][live])
    dead_moved = not torch.equal(outs[0][d], outs[1][d])
    if dead_nonzero or not live_same or not dead_moved:
        fail(f"dead lane: {dead_nonzero} nonzero routed elements in the "
             f"dead row, live rows bit-identical {live_same}, the garbage "
             f"moved the dead row's logits {dead_moved}")
    return {"decode_logit_err_per_step": errs,
            "plain_choices_replaced_per_call": sum(tap_p.replaced),
            "kernel_run_launches": n_k, "plain_run_launches": n_p,
            "dead_lane": {"live_rows_bit_identical": live_same,
                          "dead_routed_nonzero": dead_nonzero}}, decode_rows


class _LiveTap(_RouteTap):
    """A route tap recording each call's (idx, live), and in ``chunk`` the
    (x, w, idx, live) of the first ``n`` calls of CHUNK_LEN rows: every
    MoE layer of the first prefill chunk (no host sync to pick it)."""

    def __init__(self, moe, n):
        super().__init__(moe)
        self.n, self.chunk = n, []

    def __call__(self, p, c, x, live=None):
        w, idx, aux = self.own(p, c, x, live)
        self.record.append((idx, live))
        if x.shape[0] == CHUNK_LEN and len(self.chunk) < self.n:
            self.chunk.append((x, w, idx, live))
        return w, idx, aux


def _paged_layers(cfg):
    """Attention layers that read the paged pools through kernel 2: every
    layer, but none for MLA (the latent cache is read through the
    block-table gather)."""
    return 0 if cfg.attn_type == "mla" else cfg.n_layers


def _dropped_live(idx, live, n_experts):
    """(assignments of live rows that ``moe_ffn``'s capacity drops, live
    assignments) for one call.  Dead rows (bucket pads) take capacity
    ranks, after every live row of the chunk: they never crowd one out."""
    from repro_torch.kernels.moe_dispatch.ops import capacity_positions
    T, k = idx.shape
    _, keep = capacity_positions(idx.reshape(-1),
                                 max(-(-T * k // n_experts) * 2, 8))
    real = live.reshape(T, 1).expand(T, k).reshape(-1)
    return int((~keep & real).sum()), int(real.sum())


def _moe_chunk_check(M, moe, params, cfg, n_moe):
    """``prefill_chunked`` in chunks of MOE_CHECK_CHUNK rows on two short
    prompts (pads in each last chunk), kernel path against plain path
    (replaying the kernel run's expert choices), last-token logits within
    LOGIT_TOL; nothing dropped; the kernel run launched the paged kernel
    at C rows and the MoE's kernels once a layer a chunk, the plain run
    nothing."""
    rng = np.random.default_rng(7)
    C, rows = MOE_CHECK_CHUNK, []
    for P in MOE_CHECK_LENS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, P)).astype(
            np.int32), device="cuda")
        with _RouteTap(moe, ids_only=True) as tap:
            lk, n_k = _launched(lambda: _chunked_prefill_logits(
                M, params, cfg, toks, C))
        with _RouteTap(moe, replay=tap.record) as tap_p:
            lp, n_p = _launched(lambda: _chunked_prefill_logits(
                M, params, cfg.replace(use_kernels=False), toks, C))
        chunks = -(-P // C)
        n_attn = _paged_layers(cfg)
        want = {**dict.fromkeys(n_k, 0),
                "paged_attn": n_attn * chunks,
                "paged_attn_chunk": n_attn * chunks,
                "grouped_ffn": n_moe * chunks,
                "gather_scatter_add": 2 * n_moe * chunks}
        drops = sum(_dropped(i, cfg.n_experts) for i in tap.record)
        err = (lk - lp).abs().max().item()
        rows.append({"prompt": P, "chunk": C, "chunks": chunks,
                     "logit_max_abs_diff": err,
                     "max_abs_logit": lp.abs().max().item(),
                     "dropped": drops,
                     "plain_choices_replaced": sum(tap_p.replaced)})
        if n_k != want or any(n_p.values()):
            fail(f"chunked MoE check: kernel run launched {n_k} (expected "
                 f"{want}), plain run {n_p}")
        if drops or not (math.isfinite(err) and err <= LOGIT_TOL):
            fail(f"chunked MoE check at C {C}: {drops} dropped, logits "
                 f"kernel vs plain {err} (limit {LOGIT_TOL})")
    return rows


def _moe_bucketed(M, moe, params, cfg, prompts, lens, max_new, make_engine,
                  seg_len, n_moe, unbucketed=None):
    """Bucketed admission on the MoE: the chunk check, then 8 of the 16
    requests (every other, the longest included) unbucketed and
    bucketed (``unbucketed``: the readings of a run of those 8 already
    made), the assignments the bucketed run's chunks drop (live rows
    only), and the bf16 last-token logits of the longest prompt through
    each path for ``_moe_f32_distance``.  Returns (readings, launches of
    the bucketed run, (bucketed, unbucketed) logits)."""
    ps, ls = prompts[1::2], lens[1::2]
    check = _moe_chunk_check(M, moe, params, cfg, n_moe)
    if unbucketed is None:
        eng, comps, wall, _, peak = _engine_run(lambda: make_engine(ps))
        unbucketed = _serve_readings(eng, comps, wall, peak, seg_len)
        del eng
    with _LiveTap(moe, n_moe) as tap:
        res, launches = _bucketed_serve(
            f"serve_moe {cfg.name}", make_engine, ps[:1], ps, ls, max_new,
            cfg, seg_len, unbucketed, n_attn=_paged_layers(cfg),
            n_moe=n_moe)
    # (a) at the bucketed chunk's shape: the first prompt's one chunk
    # (ls[0] real rows, the rest bucket pads, dead in ``live``) as the
    # engine routed it, each MoE stage against its plain version
    if len(tap.chunk) != n_moe:
        fail(f"serve_moe bucketed: {len(tap.chunk)} chunk calls recorded")
    dead = CHUNK_LEN - int(tap.chunk[0][3].sum())
    if dead != CHUNK_LEN - ls[0]:
        fail(f"serve_moe bucketed: {dead} dead rows in the first chunk, "
             f"expected {CHUNK_LEN - ls[0]}")
    chunk_rows = [{**_moe_layer_check(cfg, M._layer(
        params["blocks"]["sub0"]["moe"], g), *tap.chunk[g][:3],
        f"moe layer {g} bucketed chunk"), "dead_rows": dead}
        for g in _check_layers(n_moe)]
    for r in chunk_rows:
        print(f"serve_moe layer check ({cfg.name}) " + json.dumps(r))
    b = res["bucketed"]
    calls = n_moe * (b["prefill_chunks"] + b["decode_steps"])
    chunk_calls = [(i, lv) for i, lv in tap.record[-calls:]
                   if i.shape[0] == CHUNK_LEN]
    if len(chunk_calls) != n_moe * b["prefill_chunks"]:
        fail(f"serve_moe bucketed: {len(chunk_calls)} chunk routing calls")
    dropped, real = map(sum, zip(*(_dropped_live(i, lv, cfg.n_experts)
                                   for i, lv in chunk_calls)))
    toks = torch.as_tensor(prompts[-1], device="cuda")
    logits = (_chunked_prefill_logits(M, params, cfg, toks, CHUNK_LEN),
              M.prefill(params, cfg, {"tokens": toks})[0])
    out = {"chunk_check": check, "chunk_layer_check": chunk_rows,
           "dropped_per_chunk": dropped
           / b["prefill_chunks"], "dropped_share_in_chunks": dropped / real,
           "chunks": b["prefill_chunks"]}
    print(f"serve_moe bucketed drops and chunk check ({CARD}) "
          + json.dumps(out))
    return {**res, **out}, launches, logits


# the bf16 MoE's bucketed (chunks of 256) and unbucketed prefill logits,
# each to the f32 model on its own path (RMS): the bucketed path's
# distance at most this many times the unbucketed path's, as the hybrid's
# SSM_BF16_RATIO.  Reading on an H100 (700 W): 0.0237 / 0.0420 = 0.565
MOE_BF16_RATIO = 1.5


def _moe_f32_distance(M, cfg, toks, logits_bf16, extra=None,
                      ratio_limit=MOE_BF16_RATIO, also=None):
    """The f32 model, the same seed's draws unrounded (the bf16 weights
    are their rounding; it does not fit beside them), through each path
    on the longest prompt: each bf16 path's RMS distance to it, and that
    of each of ``extra`` ({name: bf16 one-shot prefill logits}); the
    bucketed path's distance at most ``ratio_limit`` times the
    unbucketed one's (None: reported).  ``also(p32, c32)``, run on the
    f32 model before it is freed, gives ``res["also"]``."""
    c32 = cfg.replace(dtype="float32")
    p32 = M.init_params(
        c32, generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        t = torch.as_tensor(toks, device="cuda")
        l32 = (_chunked_prefill_logits(M, p32, c32, t, CHUNK_LEN),
               M.prefill(p32, c32, {"tokens": t})[0])
        more = also(p32, c32) if also is not None else None
    del p32
    torch.cuda.empty_cache()
    lb, lu = logits_bf16
    res = {"bf16_bucketed_to_f32_rms": _rms(lb, l32[0]),
           "bf16_unbucketed_to_f32_rms": _rms(lu, l32[1]),
           "f32_bucketed_vs_unbucketed_rms": _rms(l32[0], l32[1]),
           "max_abs_logit": l32[1].abs().max().item(),
           **{f"{k}_to_f32_rms": _rms(v, l32[1])
              for k, v in (extra or {}).items()}}
    res["ratio"] = (res["bf16_bucketed_to_f32_rms"]
                    / res["bf16_unbucketed_to_f32_rms"])
    if more is not None:
        res["also"] = more
    print(f"serve_moe {cfg.name} bf16 paths to the f32 model ({CARD}) "
          + json.dumps(res))
    if not torch.isfinite(l32[0]).all() or (
            ratio_limit is not None and not res["ratio"] <= ratio_limit):
        fail(f"serve_moe: the bucketed bf16 path is {res['ratio']:.3f}x as "
             f"far from the f32 model as the unbucketed (limit "
             f"{ratio_limit})")
    return res


def _serve_moe_model(arch):
    """One global MoE at full width (depth: SERVE_MOE_LAYERS) behind
    ``PagedServeEngine`` (8 slots, block_len 16, seg_len 8), bf16, random
    weights from seed 0 drawn on the card: the checks (a)-(c) and the dead lane, a profile
    of one decode segment, then 8 of the serve phase's 16 requests (every
    other, the longest included) with every launch counted."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve import PagedServeEngine
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config(arch, variant="full")
    cfg = cfg.replace(n_layers=SERVE_MOE_LAYERS.get(arch, cfg.n_layers))
    if not cfg.use_kernels:
        fail(f"{arch}: the config does not route through the kernels")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    head = {"arch": arch, "n_params": sum(t.numel()
                                          for t in tree_leaves(params)),
            "init_s": time.perf_counter() - t0,
            "weights_gb": torch.cuda.memory_allocated() / 1e9}
    lens, prompts = _serve_prompts(cfg)
    max_new, n_slots, bl, seg_len = 64, 8, 16, 8

    def make_engine(ps=prompts, **kw):
        eng = PagedServeEngine(params, cfg, n_slots=n_slots, block_len=bl,
                               seg_len=seg_len, max_len=max(lens) + max_new,
                               device="cuda", **kw)
        for p in ps:
            eng.submit({"tokens": p}, max_new=max_new)
        return eng

    with torch.no_grad():
        # (c) and (a) at the prefill shape: the longest prompt
        toks = torch.as_tensor(prompts[-1], device="cuda")
        with _RouteTap(moe) as tap:
            (lk, _), n_k = _launched(lambda: M.prefill(params, cfg,
                                                       {"tokens": toks}))
        (lp, _), n_p = _launched(lambda: M.prefill(
            params, cfg.replace(use_kernels=False), {"tokens": toks}))
        if not (n_k["flash_attention"] and n_k["grouped_ffn"]) or any(
                n_p.values()):
            fail(f"{arch} prefill check: kernel run launched {n_k}, plain "
                 f"run {n_p}")
        prefill_rows = [_moe_layer_check(cfg, M._layer(
            params["blocks"]["sub0"]["moe"], g), *tap.record[g],
            f"moe layer {g} prefill") for g in (0, n_moe // 2, n_moe - 1)]
        prefill_check = {
            "logit_max_abs_diff_vs_dropless": (lk - lp).abs().max().item(),
            "max_abs_logit": lp.abs().max().item(),
            "argmax_equal": bool((lk.argmax(-1) == lp.argmax(-1)).all()),
            "dropped_per_layer": [_dropped(i, cfg.n_experts)
                                  for _, _, i in tap.record]}
        if not math.isfinite(prefill_check["logit_max_abs_diff_vs_dropless"]):
            fail(f"{arch}: non-finite prefill logits")
        del tap, lk, lp

        # (b), the dead lane and (a) at the decode shape; the engine then
        # serves as the profile's warm engine
        eng = make_engine()
        eng.step()          # admits the first 8 requests, runs a segment
        decode_check, decode_rows = _moe_decode_checks(
            M, moe, mg_ops, params, cfg, eng, n_moe)
        for r in prefill_rows + decode_rows:
            print(f"serve_moe layer check ({arch}) " + json.dumps(r))
        # one decode segment under the profiler (every slot live)
        seg = profile(eng.step, top=8,
                      groups={"paged_attn": ("paged_fwd",),
                              "grouped_ffn": ("ffn_gate_up_tc",
                                              "ffn_down_tc"),
                              "gather_scatter_add": ("gsa_vec_kernel",
                                                     "gsa_kernel")})
        for g in ("paged_attn", "grouped_ffn", "gather_scatter_add"):
            if not seg["group_ms"][g] > 0:
                fail(f"{arch}: the decode profile shows no device time in {g}")
        seg["launches_per_layer_step"] = seg["device_launches"] / (
            cfg.n_layers * seg_len)
        del eng

        # the main path: 8 of the 16 requests, every other (the longest
        # included; the script's time limit), counts from 0
        ps, ls = prompts[1::2], lens[1::2]
        eng = make_engine(ps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with _RouteTap(moe, ids_only=True) as tap:
            t0 = time.perf_counter()
            comps = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _gsa_all_vec(md_ops, f"serve_moe {arch}")
    st = eng.stats
    if sorted(comps) != list(range(len(ps))):
        fail(f"{arch}: completed {sorted(comps)}")
    for uid, c in comps.items():
        if len(c.tokens) != max_new or c.prompt_len != ls[uid]:
            fail(f"{arch} request {uid}: {len(c.tokens)} tokens")
        if (c.tokens < 0).any() or (c.tokens >= cfg.vocab_size).any():
            fail(f"{arch} request {uid}: token ids out of range")
    if eng.alloc.n_free != eng.n_blocks - 1 or eng._slot_blocks:
        fail(f"{arch}: allocator did not drain")
    steps = st["segments"] * seg_len
    calls = st["prefills"] + steps
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": cfg.n_layers * st["prefills"],
            "paged_attn": cfg.n_layers * steps,
            "grouped_ffn": n_moe * calls,
            "gather_scatter_add": 2 * n_moe * calls}
    if launches != want or steps <= 0:
        fail(f"{arch}: launches {launches} != expected {want}")
    if len(tap.record) != n_moe * calls:
        fail(f"{arch}: {len(tap.record)} routing calls, expected "
             f"{n_moe * calls}")
    # a decode step routes T = n_slots rows, a prefill its prompt's
    drop_pre = sum(_dropped(i, cfg.n_experts) for i in tap.record
                   if i.shape[0] != n_slots)
    drop_dec = sum(_dropped(i, cfg.n_experts) for i in tap.record
                   if i.shape[0] == n_slots)
    ttft = sorted(c.ttft_s for c in comps.values())
    res = {**head, "requests": len(comps),
           "generated_tokens": st["generated_tokens"], "wall_s": wall,
           "tok_per_s": st["generated_tokens"] / wall,
           "decode_steps": steps,
           "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
           "admit_s": st["admit_s"], "decode_s": st["decode_s"],
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "prefills": st["prefills"], "preemptions": st["preemptions"],
           "peak_mem_gb": peak_gb, "launches": launches,
           "dropped_per_prefill": drop_pre / st["prefills"],
           "dropped_per_decode_step": drop_dec / steps,
           "prefill_check": prefill_check, "decode_check": decode_check}
    print(f"serve_moe ({CARD}) " + json.dumps(res))
    print(f"serve_moe profile ({arch}, decode segment of {seg_len} steps) "
          + json.dumps(seg))
    unbucketed = _serve_readings(eng, comps, wall, peak_gb, seg_len)
    del eng, comps, tap
    if arch != SERVE_MOE_ARCHS[0]:
        del params
        torch.cuda.empty_cache()
        return launches
    # bucketed admission on the first MoE (Qwen1.5-MoE-A2.7B), the same 8
    # requests beside the main path's unbucketed run
    with torch.no_grad():
        _, chunk_launches, logits = _moe_bucketed(
            M, moe, params, cfg, prompts, lens, max_new, make_engine,
            seg_len, n_moe, unbucketed)
    _gsa_all_vec(md_ops, f"serve_moe {arch} bucketed")
    del params
    torch.cuda.empty_cache()
    _moe_f32_distance(M, cfg, prompts[-1], logits)
    return _sum_counts(launches, chunk_launches)


def _serve_starcoder():
    """Full-width StarCoder2-3B (30 layers, 24 query heads over 2 kv heads:
    12 query rows a kv head; bf16, random weights from seed 0): the logit
    check of the serve phase (prefill and one paged decode step, kernel
    path against plain path), then STARCODER_REQUESTS requests (prompts
    128-1024 tokens, 64 new, 4 slots) with the launches counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine
    cfg = get_config("starcoder2-3b", variant="full")
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    lens, prompts = _serve_prompts(cfg)
    pick = [0, 5, 10, 15][:STARCODER_REQUESTS]
    max_new, bl, seg_len = 64, 16, 8
    with torch.no_grad():
        errs = check_logits(params, cfg, M, prompts[-1])
        eng = PagedServeEngine(params, cfg, n_slots=STARCODER_REQUESTS,
                               block_len=bl, seg_len=seg_len,
                               max_len=max(lens) + max_new, device="cuda")
        for i in pick:
            eng.submit({"tokens": prompts[i]}, max_new=max_new)
        _zero_counts()
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    st = eng.stats
    steps = st["segments"] * seg_len
    if sorted(comps) != list(range(len(pick))) or any(
            len(c.tokens) != max_new for c in comps.values()):
        fail(f"starcoder2-3b: completions {comps}")
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": cfg.n_layers * st["prefills"],
            "paged_attn": cfg.n_layers * steps}
    if launches != want or steps <= 0:
        fail(f"starcoder2-3b: launches {launches} != expected {want}")
    res = {"arch": cfg.name, "requests": len(comps),
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
           "tok_per_s": st["generated_tokens"] / wall,
           "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
           "launches": launches, "logit_err_prefill": errs[0],
           "logit_err_decode": errs[1]}
    print(f"serve_moe starcoder2 ({CARD}) " + json.dumps(res))
    del params, eng
    torch.cuda.empty_cache()
    return launches


def phase_serve_moe():
    """The paper's two global MoEs served at full width and depth
    (Qwen1.5-MoE-A2.7B, then DeepSeek-MoE-16B with its leading dense
    layer), one after the other, then StarCoder2-3B.  Returns the main
    paths' launches, summed."""
    launches = {}
    for run in [lambda a=a: _serve_moe_model(a) for a in SERVE_MOE_ARCHS] + [
            _serve_starcoder]:
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ---------------------------------------------------------------------------
# phase 5d: serve the hybrid Zamba2-7B at full width and depth
# ---------------------------------------------------------------------------

HYBRID_DECODE_STEPS = 4
# Kernel path against plain path, the prefill's last-token logits and 4
# teacher-forced paged decode steps of the 81-block model.  In bf16 the
# two paths round activations at other points and 81 random blocks
# amplify that (first reading on an H100, 700 W: 2.58 on logits of at
# most 5.3, the argmax moved), so as for Mamba2 the limit is held in
# f32, and each bf16 path is held to the f32 model by its RMS distance
# (the kernel path's at most SSM_BF16_RATIO times the plain path's).
# Limit set from readings on an H100 (700 W), about 3x the worst (1.81e-3
# on logits of at most 5.7).
HYBRID_F32_LOGIT_TOL = 5e-3
# the shared attention must reach the logits: zeroing its output
# projection must move the f32 logits by this many times the limit
HYBRID_ATTN_MARGIN = 3.0


def _path_logits(M, params, cfg, batch, cont):
    """Prefill's last-token logits of one request's ``batch`` (tokens
    (1, P), and a VLM's patches), then ``cont.shape[1]`` paged decode
    steps fed ``cont`` (teacher-forced) from ``decode_pos0``: (1 +
    steps, V) f32."""
    P, n, bl = batch["tokens"].shape[1], cont.shape[1], 16
    pos0 = M.decode_pos0(cfg, P)
    logits, pc = M.prefill(params, cfg, batch)
    n_pb, nb = -(-pos0 // bl), -(-(pos0 + n) // bl)
    cache = M.init_paged_cache(cfg, 1, nb + 1, bl, device="cuda")
    sub = M.prefill_into_cache(cfg, M.init_decode_cache(
        cfg, 1, n_pb * bl, device="cuda"), pc)
    del pc
    M.scatter_prefill_paged(cfg, cache, sub, 0, list(range(1, n_pb + 1)),
                            [True] * n_pb, block_len=bl)
    del sub
    bt = torch.arange(1, nb + 1, dtype=torch.int32, device="cuda")[None]
    out = [logits[0]]
    for j in range(n):
        lg, cache = M.decode_step(params, cfg, cache, cont[:, j:j + 1],
                                  torch.tensor([pos0 + j], device="cuda"),
                                  block_tables=bt)
        out.append(lg[0])
    return torch.stack(out)


def hybrid_logit_check(M, params, cfg, prompt, seed):
    """On one prompt: (i) the f32 model's kernel-path logits against its
    plain path's (kernel run: flash and kernel 7 in prefill, the paged
    kernel in decode; plain run: no kernel), and the shared attention's
    reach there (the kernel path with the shared block's ``wo`` zeroed);
    (ii) the bf16 model's kernel and plain paths against the f32 model
    (plain path), the kernel path's RMS distance at most SSM_BF16_RATIO
    times the plain path's."""
    from repro_torch.utils.pytree import tree_map
    toks = torch.as_tensor(prompt, device="cuda")
    cont = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, HYBRID_DECODE_STEPS)).astype(np.int32),
        device="cuda")
    _, n_groups, tail = M._hybrid_layout(cfg)
    n_attn = n_groups + (1 if tail else 0)
    want = {"flash_attention": n_attn, "ssd_scan": cfg.n_layers,
            "paged_attn": n_attn * HYBRID_DECODE_STEPS}

    def paths(p, c):
        lk, n_k = _launched(lambda: _path_logits(M, p, c, {"tokens": toks},
                                                 cont))
        lp, n_p = _launched(lambda: _path_logits(
            M, p, c.replace(use_kernels=False), {"tokens": toks}, cont))
        if {k: n_k[k] for k in want} != want or any(
                v for k, v in n_k.items() if k not in want) or \
                any(n_p.values()):
            fail(f"serve_hybrid logits ({c.dtype}): kernel path launched "
                 f"{n_k} (expected {want}), plain path {n_p}")
        return lk, lp

    # bucketed admission's prefill: chunks of CHUNK_LEN, no flash
    chunks = -(-toks.shape[1] // CHUNK_LEN)
    want_c = {"paged_attn": n_attn * chunks, "paged_attn_chunk": n_attn * chunks,
              "ssd_scan": cfg.n_layers * chunks,
              "ssd_scan_h0": cfg.n_layers * chunks}

    def chunked(p, c):
        lc, n_c = _launched(lambda: _chunked_prefill_logits(
            M, p, c, toks, CHUNK_LEN))
        if {**dict.fromkeys(n_c, 0), **want_c} != n_c:
            fail(f"serve_hybrid chunked logits ({c.dtype}): launched {n_c} "
                 f"(expected {want_c})")
        return lc[0]

    kb, qb = paths(params, cfg)
    cb = chunked(params, cfg)
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    k32, q32 = paths(p32, cfg32)
    c32 = chunked(p32, cfg32)
    wo = p32["shared_attn"]["attn"]["wo"]
    wo.zero_()
    a32 = _path_logits(M, p32, cfg32, {"tokens": toks}, cont)
    del p32

    err = (k32 - q32).abs().max(-1).values
    reach = (k32 - a32).abs().max(-1).values
    res = {"len": toks.shape[1], "max_abs_logit": q32.abs().max().item(),
           "f32_prefill_kernel_vs_plain": err[0].item(),
           "f32_decode_kernel_vs_plain": err[1:].max().item(),
           "f32_attn_reach_min": reach.min().item(),
           "bf16_kernel_to_f32_rms": _rms(kb, q32),
           "bf16_plain_to_f32_rms": _rms(qb, q32),
           "bf16_kernel_vs_plain_max": (kb - qb).abs().max().item(),
           "bf16_argmax_equal": bool((kb.argmax(-1) == qb.argmax(-1)).all()),
           "f32_bucketed_prefill_vs_plain": (c32 - q32[0]).abs().max().item(),
           "bf16_bucketed_prefill_to_f32_rms": _rms(cb, q32[0]),
           "bf16_unbucketed_prefill_to_f32_rms": _rms(kb[0], q32[0])}
    res["bf16_rms_ratio"] = (res["bf16_kernel_to_f32_rms"]
                             / res["bf16_plain_to_f32_rms"])
    res["bf16_bucketed_rms_ratio"] = (
        res["bf16_bucketed_prefill_to_f32_rms"]
        / res["bf16_unbucketed_prefill_to_f32_rms"])
    print(f"serve_hybrid logits ({CARD}) " + json.dumps(res))
    if not (torch.isfinite(kb).all() and torch.isfinite(k32).all()) or \
            not err.max() <= HYBRID_F32_LOGIT_TOL:
        fail(f"serve_hybrid: f32 kernel-path logits differ from the plain "
             f"path's by {err.max().item()} > {HYBRID_F32_LOGIT_TOL}")
    if not reach.min() >= HYBRID_ATTN_MARGIN * HYBRID_F32_LOGIT_TOL:
        fail(f"serve_hybrid: the shared attention moves the logits by only "
             f"{reach.min().item()}: the check would not see it")
    if not res["bf16_rms_ratio"] <= SSM_BF16_RATIO:
        fail(f"serve_hybrid: the bf16 kernel path is "
             f"{res['bf16_rms_ratio']:.3f}x as far from the f32 model as "
             f"the plain path (limit {SSM_BF16_RATIO})")
    if not (torch.isfinite(c32).all()
            and res["f32_bucketed_prefill_vs_plain"] <= HYBRID_F32_LOGIT_TOL):
        fail(f"serve_hybrid: f32 bucketed prefill logits differ from the "
             f"plain path's by {res['f32_bucketed_prefill_vs_plain']} > "
             f"{HYBRID_F32_LOGIT_TOL}")
    if not res["bf16_bucketed_rms_ratio"] <= SSM_BF16_RATIO:
        fail(f"serve_hybrid: the bf16 bucketed prefill is "
             f"{res['bf16_bucketed_rms_ratio']:.3f}x as far from the f32 "
             f"model as the unbucketed (limit {SSM_BF16_RATIO})")
    return res


def phase_serve_hybrid():
    """Full-width, full-depth Zamba2-7B (bf16, random weights from seed 0)
    behind ``PagedServeEngine`` with 8 slots: 8 of the serve cell's 16
    greedy requests of 128-1024 prompt tokens (every other, the longest
    included), 64 new tokens each, unbucketed and bucketed.  Checks the
    completions, the block pool, the launches on that run (flash 14 and
    kernel 7 81 a prefill, all tc; the paged kernel 14 a decode step), the
    logit check on the longest prompt, and profiles one decode
    segment."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine

    cfg = get_config("zamba2-7b", variant="full")
    period, n_groups, tail = M._hybrid_layout(cfg)
    if not (cfg.use_kernels and M.has_paged_leaves(cfg)) or \
            (period, n_groups, tail) != (6, 13, 3):
        fail(f"zamba2 config: kernels {cfg.use_kernels}, layout "
             f"{(period, n_groups, tail)}")
    n_attn = n_groups + 1
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in convert.flatten(params).values())
    print(f"serve_hybrid: {cfg.name} {n_params / 1e9:.3f}B params "
          f"{cfg.dtype}, {cfg.n_layers} Mamba-2 blocks, {n_attn} shared "
          f"attention applications, init {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(1)
    lens = [int(p) for p in np.linspace(128, 1024, 16)]
    prompts = [rng.integers(0, cfg.vocab_size, (1, p)).astype(np.int32)
               for p in lens]
    max_new, n_slots, seg_len = 64, 8, 8

    with torch.no_grad():
        checks = [hybrid_logit_check(M, params, cfg, prompts[15], 15)]
        torch.cuda.empty_cache()

        def make_engine(ps, new=max_new, **kw):
            eng = PagedServeEngine(params, cfg, n_slots=n_slots,
                                   seg_len=seg_len,
                                   max_len=max(lens) + max_new,
                                   device="cuda", **kw)
            for p in ps:
                eng.submit({"tokens": p}, max_new=new)
            return eng

        # the main path: 8 of the 16 requests, every other (the longest
        # included; the script's time limit), the unbucketed run beside
        # the bucketed one below
        pick = list(range(1, len(prompts), 2))
        ps, ls = [prompts[i] for i in pick], [lens[i] for i in pick]
        make_engine(prompts[:2], seg_len).run()   # warm-up
        eng = make_engine(ps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        comps = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _counts().items() if v}
        by_instance = dict(ssd_ops.LAUNCHES_BY_INSTANCE)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    st = eng.stats
    if sorted(comps) != list(range(len(ps))):
        fail(f"zamba2 completed {sorted(comps)}")
    for uid, c in comps.items():
        if len(c.tokens) != max_new or c.prompt_len != ls[uid]:
            fail(f"zamba2 request {uid}: {len(c.tokens)} tokens, prompt "
                 f"{c.prompt_len}")
        if (c.tokens < 0).any() or (c.tokens >= cfg.vocab_size).any():
            fail(f"zamba2 request {uid}: token ids out of range")
    if not st["fresh_blocks"] or eng.alloc.n_free != eng.n_blocks - 1:
        fail(f"zamba2: block pool not used or not returned: {st}")
    steps = st["segments"] * seg_len
    want = {"flash_attention": n_attn * st["prefills"],
            "ssd_scan": cfg.n_layers * st["prefills"],
            "paged_attn": n_attn * steps}
    if launches != want or st["prefills"] != len(ps):
        fail(f"zamba2 launches {launches} != expected {want} "
             f"({st['prefills']} prefills, {steps} decode steps)")
    _ssd_on_tensor_cores(by_instance, want["ssd_scan"], "serve_hybrid")
    ttft = sorted(c.ttft_s for c in comps.values())
    res = {"requests": len(comps), "prompt_lens": ls,
           "generated_tokens": st["generated_tokens"], "wall_s": wall,
           "tok_per_s": st["generated_tokens"] / wall,
           "decode_steps": steps,
           "ms_per_decode_step": 1e3 * st["decode_s"] / steps,
           "admit_s": st["admit_s"], "decode_s": st["decode_s"],
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "ttft_min_s": ttft[0], "prefills": st["prefills"],
           "peak_live_blocks": st["peak_live_blocks"],
           "preemptions": st["preemptions"],
           "launches": launches, "peak_mem_gb": peak_gb,
           "weights_gb": 2 * n_params / 1e9, "n_params": n_params,
           "kv_bytes_per_token": M.cache_nbytes(cfg, 1, 2) - M.cache_nbytes(
               cfg, 1, 1),
           "recurrent_bytes_per_slot": M.cache_nbytes(cfg, 1, 0),
           "logit_checks": checks}
    print(f"serve_hybrid ({CARD}) " + json.dumps(res))

    # bucketed admission on the same 8 requests, beside the main path's
    # unbucketed run
    unbucketed = _serve_readings(eng, comps, wall, peak_gb, seg_len)
    del eng      # its pool must not count in the bucketed run's peak
    with torch.no_grad():
        _, chunk_launches = _bucketed_serve(
            "serve_hybrid", make_engine, ps[:1], ps, ls, max_new, cfg,
            seg_len, unbucketed, n_attn=n_attn, n_ssm=cfg.n_layers)
        _ssd_on_tensor_cores(dict(ssd_ops.LAUNCHES_BY_INSTANCE),
                             chunk_launches["ssd_scan"],
                             "serve_hybrid bucketed")

    with torch.no_grad():
        eng = make_engine(ps)
        eng.step()        # admits the 8 requests, runs a segment
        seg = decode_profile(eng, cfg, seg_len, "serve_hybrid decode")
    seg["launches_per_step"] = seg["device_launches"] / seg_len
    print("profile " + json.dumps({"hybrid_decode_segment_8_steps": seg}))
    del params, eng
    torch.cuda.empty_cache()
    return _sum_counts(launches, chunk_launches)


# ---------------------------------------------------------------------------
# phase 5e: serve DeepSeek-V3 (MLA's latent cache) at full width
# ---------------------------------------------------------------------------

# DeepSeek-V3 at full width, its depth cut from 61 layers to the 3
# leading dense ones and 1 MoE layer; the MTP head is built (serving does
# not run it): 15.80 B parameters, 31.60 GB in bf16.
MLA_LAYERS = 4
MLA_DECODE_STEPS = 4
# One full-width MLA layer in f32 (the first dense layer's and the MTP
# block's), x ~ N(0, 1) at 1024 positions: ``mla_full``'s rows against
# the absorbed-matrix decode over a paged latent pool (the first 1020
# positions written in chunks of CHUNK_LEN, bucketed admission's path,
# then MLA_DECODE_STEPS single-token steps), max |d| over the rows'
# largest |out|.  Both sum in f32, in other orders and groupings (512
# latent features against 128 nope ones per head).  Readings on an H100
# (700 W): 1.61e-6 (dense layer 0) and 1.95e-6 (MTP block), the single
# steps 1.1e-7 and 1.3e-7; the limit about 3x the worst.
MLA_F32_REL = 6e-6
# each planted fault (wk_b's transpose absorbed into the query, RoPE on
# the nope half of the query) must read this many times a limit
MLA_FAULT_MARGIN = 3.0
# the bf16 model's prefill logits (the longest prompt), RMS distance to
# the f32 model on the same path: one-shot, and bucketed (chunks of 256).
# A bucketed chunk's capacity (16 an expert) drops about half its
# assignments, and the drops follow the routing order, so one choice that
# rounding moves moves other tokens' drops: the f32 model's bucketed and
# one-shot prefills differ by 0.039 RMS themselves, and the bucketed bf16
# path sits at about that distance (serve_moe's ratio of the two paths is
# reported, not held).  Readings on an H100 (700 W): 0.0142 one-shot,
# 0.0446 bucketed, on logits of at most 4.2; limits about 3x those.  RoPE
# on the nope half read 0.72.
MLA_BF16_RMS_TOL = {"unbucketed": 0.045, "bucketed": 0.15}
# int8/fp8 latent pools: KV_CHECK_STEPS decode steps after the longest
# prompt, logits' relative RMS from the bf16 pool's; the same with every
# scale dropped must read KV_DROPPED_MARGIN times the limit.  Readings on
# an H100 (700 W): int8 0.0149, fp8 0.0428, dropped scales 1.23; limits
# about 3x.
MLA_KV_REL_RMS_TOL = {"int8": 0.045, "fp8": 0.13}


def _rope_on_nope_half(layers):
    """A faulty ``layers._mla_queries``: RoPE on the first rope_head_dim
    features of each query head (inside its nope part), not the last."""
    def queries(p, cfg, x, positions):
        B, S, _ = x.shape
        H, nd, pr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
        q = layers.mm(layers.apply_norm(p["q_norm"], layers.mm(
            x, p["wq_a"])), p["wq_b"]).reshape(B, S, H, nd + pr)
        q = torch.cat([layers.apply_rope(q[..., :pr], positions,
                                         cfg.rope_theta), q[..., pr:]], -1)
        return q[..., :nd], q[..., nd:]
    return queries


def _mla_decode_rows(layers, M, cfg, p, x, bl=16):
    """``layers.mla_decode`` of x (1, P, D) through a fresh one-slot paged
    latent pool: positions up to P - MLA_DECODE_STEPS in chunks of
    CHUNK_LEN, then one a step; the outputs (1, P, D)."""
    P = x.shape[1]
    W = -(-P // bl)
    cache = M._attn_cache_struct(cfg, (), W + 1, bl, device="cuda")
    table = torch.arange(1, W + 1, dtype=torch.int32, device="cuda")[None]
    pos = torch.arange(P, dtype=torch.int32, device="cuda")[None]
    head = P - MLA_DECODE_STEPS
    cuts = sorted(set(range(0, head, CHUNK_LEN)) | set(range(head, P + 1)))
    return torch.cat([layers.mla_decode(p, cfg, x[:, lo:hi], pos[:, lo:hi],
                                        cache, block_table=table)[0]
                      for lo, hi in zip(cuts, cuts[1:])], 1)


def mla_layer_check(layers, M, cfg, p, label, seed):
    """One full-width MLA layer ``p`` in f32: the absorbed-matrix decode
    (chunks, then single steps) against ``mla_full``'s rows within
    MLA_F32_REL of the largest |out|; wk_b's transpose absorbed and RoPE
    on the nope half of the query (in the decode only) must each read
    MLA_FAULT_MARGIN times the limit."""
    from repro_torch.utils.pytree import tree_map
    c32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), p)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((1, 1024, cfg.d_model), generator=gen, device="cuda")
    pos = torch.arange(1024, device="cuda")[None]
    want, _ = layers.mla_full(p32, c32, x, pos)
    scale = want.abs().max().item()

    def rel(got, rows=slice(None)):
        return ((got[:, rows] - want[:, rows]).abs().max().item() / scale)

    got = _mla_decode_rows(layers, M, c32, p32, x)
    head = 1024 - MLA_DECODE_STEPS
    res = {"layer": label, "max_abs_out": scale, "rel_err": rel(got),
           "rel_err_chunks": rel(got, slice(0, head)),
           "rel_err_steps": rel(got, slice(head, None))}
    wk = p32["wk_b"]
    res["fault_wk_b_transposed"] = rel(_mla_decode_rows(
        layers, M, c32, dict(p32, wk_b=wk.transpose(1, 2).reshape(wk.shape)),
        x))
    own = layers._mla_queries
    layers._mla_queries = _rope_on_nope_half(layers)
    try:
        res["fault_rope_on_nope_half"] = rel(_mla_decode_rows(
            layers, M, c32, p32, x))
    finally:
        layers._mla_queries = own
    print(f"serve_mla layer check ({CARD}) " + json.dumps(res))
    if not res["rel_err"] <= MLA_F32_REL:
        fail(f"serve_mla {label}: the absorbed decode differs from "
             f"mla_full by {res['rel_err']:.3g} of the largest |out| > "
             f"{MLA_F32_REL}")
    for k in ("fault_wk_b_transposed", "fault_rope_on_nope_half"):
        if not res[k] >= MLA_FAULT_MARGIN * MLA_F32_REL:
            fail(f"serve_mla {label}: {k} reads only {res[k]:.3g}: the check "
                 f"would not see it")
    return res


def _mla_pool_logits(M, params, cfg, prompt):
    """KV_CHECK_STEPS teacher-forced decode steps after the longest prompt
    from a bf16, int8 and fp8 latent pool (quantized once at the graft),
    and from each quantized pool with its scales dropped: each one's
    relative RMS from the bf16 pool's logits, held to MLA_KV_REL_RMS_TOL
    and, dropped, to KV_DROPPED_MARGIN times it."""
    from repro_torch.models import quant
    toks = torch.as_tensor(prompt, device="cuda")
    P = toks.shape[1]
    feed = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, KV_CHECK_STEPS), dtype=torch.int32, device="cuda")
    _, pc = M.prefill(params, cfg, {"tokens": toks})
    base = _kv_decode_logits(M, params, cfg, pc, P, feed, None)
    res = {"prompt_len": P, "steps": KV_CHECK_STEPS,
           "max_abs_logit": base.abs().max().item()}
    for kv in KV_QUANT:
        pol = quant.CachePolicy(kv)
        lq = _kv_decode_logits(M, params, cfg, pc, P, feed, pol)
        ld = _kv_decode_logits(M, params, cfg, pc, P, feed, pol, dropped=True)
        res[f"{kv}_rel_rms"] = _rel_rms(lq, base)
        res[f"{kv}_top1_agreement"] = (
            lq.argmax(-1) == base.argmax(-1)).float().mean().item()
        res[f"{kv}_dropped_scale_rel_rms"] = _rel_rms(ld, base)
    print(f"serve_mla latent pool logits ({CARD}) " + json.dumps(res))
    for kv in KV_QUANT:
        r, dr = res[f"{kv}_rel_rms"], res[f"{kv}_dropped_scale_rel_rms"]
        if not r <= MLA_KV_REL_RMS_TOL[kv]:
            fail(f"serve_mla {kv} pool: logits {r:.4f} relative RMS from the "
                 f"bf16 pool's (limit {MLA_KV_REL_RMS_TOL[kv]})")
        if not dr > KV_DROPPED_MARGIN * MLA_KV_REL_RMS_TOL[kv]:
            fail(f"serve_mla {kv} pool: dropping the scales moves the logits "
                 f"only {dr:.4f}: the limit would not see it")
    return res


def _mla_spec_runs(M, moe, md_ops, cfg, make_engine, prompts, lens, max_new,
                   seg_len, n_slots, n_moe, plain_tok):
    """DeepSeek-V3 speculatively (k SPEC_K, its own MTP head) from the
    bf16, int8 and fp8 latent pools on 8 of the requests: completions,
    launches (kernels 4 and 6 once a MoE layer a prefill or verify step;
    the draft block is dense, its attention MLA's plain ``mla_full``),
    readings, acceptance, each request's first divergence from the plain
    run of its pool, and the assignments of live rows each verify chunk
    (n_slots x (k+1) rows) drops."""
    picks = list(range(0, len(prompts), 2))
    ps, ls = [prompts[i] for i in picks], [lens[i] for i in picks]
    rows = n_slots * (SPEC_K + 1)
    out, paths = {}, []
    for kv in ("", "int8", "fp8"):
        tag = kv or "bf16"
        with _RouteTap(moe, with_live=True) as tap:
            eng, comps, wall, launches, peak = _engine_run(
                lambda: make_engine(ps, kv_dtype=kv, speculate=SPEC_K))
        _gsa_all_vec(md_ops, f"serve_mla speculative {tag}")
        _check_served(f"serve_mla speculative {tag}", eng, comps, ls,
                      max_new, cfg.vocab_size)
        steps = eng.stats["segments"] * seg_len
        calls = eng.stats["prefills"] + steps
        want = {**dict.fromkeys(launches, 0), "grouped_ffn": n_moe * calls,
                "gather_scatter_add": 2 * n_moe * calls}
        if launches != want or len(tap.record) != n_moe * calls:
            fail(f"serve_mla speculative {tag}: launches {launches} != "
                 f"expected {want}, {len(tap.record)} routing calls")
        drops = [_dropped_live(i, live, cfg.n_experts)
                 for i, live in tap.record if i.shape[0] == rows]
        plain = {u: plain_tok[tag][i] for u, i in enumerate(picks)}
        diff = _first_divergence(_tokens(comps), plain)
        out[tag] = {**_serve_readings(eng, comps, wall, peak, seg_len),
                    **_spec_stats(eng), "first_divergence": diff,
                    "verify_chunks": len(drops),
                    "dropped_live_per_verify_chunk":
                        sum(d for d, _ in drops) / max(len(drops), 1),
                    "live_assignments_per_verify_chunk":
                        sum(n for _, n in drops) / max(len(drops), 1),
                    "launches": launches}
        paths.append(launches)
        del eng, comps, tap
    print(f"serve_mla speculative ({CARD}) " + json.dumps(out))
    return out, paths


def phase_serve_mla():
    """DeepSeek-V3 at full width, MLA_LAYERS deep (the 3 leading dense
    layers and 1 MoE layer of 256 experts, top-8; bf16, random weights
    from seed 0 drawn on the card) behind ``PagedServeEngine`` (8 slots,
    block_len 16, seg_len 8): the f32 layer checks, the prefill and
    decode MoE checks (kernel against plain, the dead lane), the serve
    cell's 16 requests from a bf16, an int8 and an fp8 latent pool, the
    pools' decode logits, 8 requests unbucketed and bucketed, and the
    bf16 model's distance to the f32 model.  MLA launches neither flash
    nor paged attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.models import layers, moe
    from repro_torch.models import model as M
    from repro_torch.models import quant
    from repro_torch.serve import PagedServeEngine
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config("deepseek-v3-671b", variant="full").replace(
        n_layers=MLA_LAYERS)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    if not (cfg.use_kernels and cfg.attn_type == "mla" and cfg.n_mtp
            and n_moe == 1 and (cfg.n_experts, cfg.top_k) == (V3_E, V3_K)):
        fail(f"deepseek-v3 config: {cfg}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    head = {"arch": cfg.name, "layers": cfg.n_layers, "n_params": n_params,
            "init_s": time.perf_counter() - t0,
            "weights_gb": torch.cuda.memory_allocated() / 1e9,
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"serve_mla ({CARD}) " + json.dumps(head))
    lens, prompts = _serve_prompts(cfg)
    max_new, n_slots, bl, seg_len = 64, 8, 16, 8

    def make_engine(ps=prompts, **kw):
        eng = PagedServeEngine(params, cfg, n_slots=n_slots, block_len=bl,
                               seg_len=seg_len, max_len=max(lens) + max_new,
                               device="cuda", **kw)
        for p in ps:
            eng.submit({"tokens": p}, max_new=max_new)
        return eng

    with torch.no_grad():
        layer_checks = [
            mla_layer_check(layers, M, cfg, M._layer(
                params["dense_blocks"]["sub0"]["attn"], 0), "dense layer 0",
                1),
            mla_layer_check(layers, M, cfg, params["mtp"]["block"]["attn"],
                            "mtp block", 2)]
        torch.cuda.empty_cache()
        # the longest prompt's prefill: kernel path (with drops) against
        # the dropless plain path (reported), the MoE layer's stages at
        # the prefill shape against their plain versions
        toks = torch.as_tensor(prompts[-1], device="cuda")
        with _RouteTap(moe) as tap:
            (lk, _), n_k = _launched(lambda: M.prefill(params, cfg,
                                                       {"tokens": toks}))
        (lp, _), n_p = _launched(lambda: M.prefill(
            params, cfg.replace(use_kernels=False), {"tokens": toks}))
        want = {**dict.fromkeys(n_k, 0), "grouped_ffn": n_moe,
                "gather_scatter_add": 2 * n_moe}
        if n_k != want or any(n_p.values()):
            fail(f"serve_mla prefill check: kernel run launched {n_k} "
                 f"(expected {want}), plain run {n_p}")
        prefill_rows = [_moe_layer_check(cfg, M._layer(
            params["blocks"]["sub0"]["moe"], g), *tap.record[g],
            f"moe layer {g} prefill") for g in _check_layers(n_moe)]
        prefill_check = {
            "logit_max_abs_diff_vs_dropless": (lk - lp).abs().max().item(),
            "max_abs_logit": lp.abs().max().item(),
            "argmax_equal": bool((lk.argmax(-1) == lp.argmax(-1)).all()),
            "dropped_per_layer": [_dropped(i, cfg.n_experts)
                                  for _, _, i in tap.record],
            "assignments_per_layer": toks.numel() * cfg.top_k}
        if not math.isfinite(prefill_check["logit_max_abs_diff_vs_dropless"]):
            fail("serve_mla: non-finite prefill logits")
        del tap, lk, lp
        # decode kernel vs plain, the dead lane, the stages at the decode
        # shape (every expert's weights read, expert 255's included)
        eng = make_engine()
        eng.step()
        decode_check, decode_rows = _moe_decode_checks(
            M, moe, mg_ops, params, cfg, eng, n_moe)
        del eng
        for r in prefill_rows + decode_rows:
            print(f"serve_mla layer check ({cfg.name}) " + json.dumps(r))

        # the main path: the 16 requests from a bf16, an int8 and an fp8
        # latent pool, counts from 0 for each
        runs, paths, plain_tok = {}, [], {}
        for kv in ("", "int8", "fp8"):
            tag = kv or "bf16"
            with _RouteTap(moe, ids_only=True) as tap:
                eng, comps, wall, launches, peak = _engine_run(
                    lambda: make_engine(kv_dtype=kv))
            _gsa_all_vec(md_ops, f"serve_mla {tag}")
            _check_served(f"serve_mla {tag}", eng, comps, lens, max_new,
                          cfg.vocab_size)
            st = eng.stats
            steps = st["segments"] * seg_len
            calls = st["prefills"] + steps
            want = {**dict.fromkeys(launches, 0),
                    "grouped_ffn": n_moe * calls,
                    "gather_scatter_add": 2 * n_moe * calls}
            if launches != want or len(tap.record) != n_moe * calls:
                fail(f"serve_mla {tag}: launches {launches} != expected "
                     f"{want}, {len(tap.record)} routing calls")
            if (eng.cache["blocks"]["sub0"]["ckv"].dtype
                    != quant.CachePolicy(kv).storage_dtype(torch.bfloat16)):
                fail(f"serve_mla {tag}: pool in "
                     f"{eng.cache['blocks']['sub0']['ckv'].dtype}")
            r = _serve_readings(eng, comps, wall, peak, seg_len)
            r.update(
                pool_bytes=M.paged_cache_nbytes(cfg, n_slots, eng.n_blocks,
                                                bl, policy=eng.policy),
                n_blocks=eng.n_blocks,
                dropped_per_prefill=sum(
                    _dropped(i, cfg.n_experts) for i in tap.record
                    if i.shape[0] != n_slots) / st["prefills"],
                dropped_per_decode_step=sum(
                    _dropped(i, cfg.n_experts) for i in tap.record
                    if i.shape[0] == n_slots) / steps,
                launches=launches)
            runs[tag] = r
            plain_tok[tag] = _tokens(comps)
            paths.append(launches)
            del eng, comps, tap
        spec, spec_paths = _mla_spec_runs(M, moe, md_ops, cfg, make_engine,
                                          prompts, lens, max_new, seg_len,
                                          n_slots, n_moe, plain_tok)
        paths += spec_paths
        per_tok = {tag: (M.cache_nbytes(cfg, 1, 2, quant.CachePolicy(kv))
                         - M.cache_nbytes(cfg, 1, 1, quant.CachePolicy(kv)))
                   // cfg.n_layers
                   for tag, kv in (("bf16", ""), ("int8", "int8"),
                                   ("fp8", "fp8"))}
        if per_tok != {"bf16": 1152, "int8": 584, "fp8": 584}:
            fail(f"serve_mla: latent bytes a token and layer {per_tok}")
        res = {**head, "runs": runs, "speculative": spec,
               "latent_bytes_per_token_layer": per_tok,
               "gqa_shaped_bytes_per_token_layer":
                   2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2,
               "prefill_check": prefill_check, "decode_check": decode_check,
               "layer_checks": layer_checks}
        print(f"serve_mla ({CARD}) " + json.dumps(res))
        pool_logits = _mla_pool_logits(M, params, cfg, prompts[-1])

        # bucketed admission: the chunk check at C 8, 8 requests
        # unbucketed and bucketed, the chunks' drops
        _, chunk_launches, logits = _moe_bucketed(
            M, moe, params, cfg, prompts, lens, max_new, make_engine,
            seg_len, n_moe)
        _gsa_all_vec(md_ops, "serve_mla bucketed")
        paths.append(chunk_launches)
        # a planted fault the bf16 model's distance to the f32 one must see
        own = layers._mla_queries
        layers._mla_queries = _rope_on_nope_half(layers)
        try:
            fault = M.prefill(params, cfg, {"tokens": toks})[0]
        finally:
            layers._mla_queries = own
    del params
    torch.cuda.empty_cache()
    dist = _moe_f32_distance(M, cfg, prompts[-1], logits,
                             extra={"bf16_rope_on_nope_half": fault},
                             ratio_limit=None,
                             also=lambda p32, c32: _mla_spec_f32(
                                 M, p32, c32, prompts))
    print(f"serve_mla bf16 to f32 ({CARD}) " + json.dumps(
        {"pool_logits": pool_logits, **dist}))
    for path, tol in MLA_BF16_RMS_TOL.items():
        d = dist[f"bf16_{path}_to_f32_rms"]
        if not d <= tol:
            fail(f"serve_mla: the bf16 model's {path} prefill logits are "
                 f"{d:.4f} RMS from the f32 model's (limit {tol})")
    if not (dist["bf16_rope_on_nope_half_to_f32_rms"]
            >= MLA_FAULT_MARGIN * max(MLA_BF16_RMS_TOL.values())):
        fail(f"serve_mla: RoPE on the nope half moves the bf16 logits only "
             f"{dist['bf16_rope_on_nope_half_to_f32_rms']:.4f} RMS from the "
             f"f32 model: the limits would not see it")
    return _sum_counts(*paths)


# ---------------------------------------------------------------------------
# phase 5f: serve the gemma family (Gemma-2-9B, Gemma-2-27B) and the VLM
# (PaliGemma-3B)
# ---------------------------------------------------------------------------

# the long request: a prompt past the local layers' window of 4096, so its
# prefill masks in kernel 1 and its decode reads kernel 2 past the window
GEMMA_LONG = 4608
GEMMA_DECODE_STEPS = 4
GEMMA_SLOTS, GEMMA_SEG = 8, 8
# f32 kernel path against plain path: the long request's prefill logits
# and GEMMA_DECODE_STEPS teacher-forced paged decode steps (PaliGemma: its
# longest request).  Readings on an H100 (700 W): prefill 2.34e-5 (9B),
# 2.26e-5 (27B, 8 layers), 8.2e-6 (PaliGemma), decode at most 9.9e-6, on
# logits of at most 10.9, 23.3 and 16.1; the limit about 4x the worst.
GEMMA_F32_LOGIT_TOL = 1e-4
# the planted fault (Gemma: the same weights with sliding_window=0;
# PaliGemma: the patches zeroed) must move the f32 kernel path's logits
# by this many times the limit
GEMMA_FAULT_MARGIN = 3.0
# Gemma-2-27B at full width, its depth cut from 46 layers to 8 (full
# depth would hold 54.4 GB of bf16 weights); Gemma-2-9B's served on 22
# of its 42 layers (the script's time limit, for serve_sharded); its f32
# token identity on 14 (the f32 copy of all 42 is 37 GB)
GEMMA27_LAYERS = 8
GEMMA9_LAYERS = 22
GEMMA_F32_IDENTITY_LAYERS = 14


def _cut_depth(params, cfg, n_layers):
    """The first ``n_layers`` of a dense stack: views of ``blocks``' first
    groups (nothing copied), and the config at that depth."""
    from repro_torch.utils.pytree import tree_map
    g = n_layers // cfg.layers_per_scan
    return ({**params, "blocks": tree_map(lambda t: t[:g], params["blocks"])},
            cfg.replace(n_layers=n_layers))


def _f32(b):
    """A batch's float leaves in f32 (the f32 model's inputs)."""
    return {k: v.float() if v.is_floating_point() else v for k, v in b.items()}


def _on_card(b):
    return {k: torch.as_tensor(v).to("cuda") for k, v in b.items()}


def f32_logit_check(label, M, params, cfg, batch, *, want, faults, tol,
                    seed):
    """On one request, the f32 model (these weights cast): (i) the kernel
    path's logits (prefill + GEMMA_DECODE_STEPS paged decode steps) against
    the plain path's, the kernel run launching ``want``, the plain run
    nothing; (ii) each planted fault of ``faults`` ({name: fn(f32 params,
    f32 config, f32 batch, continuation) -> logits}, on the kernel path)
    at least GEMMA_FAULT_MARGIN limits (``tol``) from the plain path;
    (iii) the bf16 model's kernel and plain paths' RMS distance to the f32
    model, the kernel path's at most SSM_BF16_RATIO times the plain
    path's."""
    from repro_torch.utils.pytree import tree_map
    cont = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, GEMMA_DECODE_STEPS)).astype(np.int32),
        device="cuda")

    def paths(p, c, b):
        lk, n_k = _launched(lambda: _path_logits(M, p, c, b, cont))
        lp, n_p = _launched(lambda: _path_logits(
            M, p, c.replace(use_kernels=False), b, cont))
        if {**dict.fromkeys(n_k, 0), **want} != n_k or any(n_p.values()):
            fail(f"{label} {cfg.name} logits ({c.dtype}): kernel path "
                 f"launched {n_k} (expected {want}), plain path {n_p}")
        return lk, lp

    b16 = _on_card(batch)
    kb, qb = paths(params, cfg, b16)
    cfg32 = cfg.replace(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    b32 = _f32(b16)
    k32, q32 = paths(p32, cfg32, b32)
    fault = {name: (fn(p32, cfg32, b32, cont) - q32).abs().max(-1).values
             for name, fn in faults.items()}
    del p32
    torch.cuda.empty_cache()
    err = (k32 - q32).abs().max(-1).values
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "prompt_len": batch["tokens"].shape[1],
           "max_abs_logit": q32.abs().max().item(),
           "f32_prefill_kernel_vs_plain": err[0].item(),
           "f32_decode_kernel_vs_plain": err[1:].max().item(),
           **{f"f32_fault_{n}_min": f.min().item() for n, f in fault.items()},
           "bf16_kernel_to_f32_rms": _rms(kb, q32),
           "bf16_plain_to_f32_rms": _rms(qb, q32),
           "bf16_kernel_vs_plain_max": (kb - qb).abs().max().item(),
           "launches_kernel_path": want}
    res["bf16_rms_ratio"] = (res["bf16_kernel_to_f32_rms"]
                             / res["bf16_plain_to_f32_rms"])
    print(f"{label} logits ({CARD}) " + json.dumps(res))
    if not (torch.isfinite(kb).all() and torch.isfinite(k32).all()) or \
            not err.max() <= tol:
        fail(f"{label} {cfg.name}: f32 kernel-path logits differ from the "
             f"plain path's by {err.max().item()} > {tol}")
    for n, f in fault.items():
        if not f.min() >= GEMMA_FAULT_MARGIN * tol:
            fail(f"{label} {cfg.name}: the planted fault ({n}) moves the "
                 f"logits by only {f.min().item()}: the check would not "
                 f"see it")
    if not res["bf16_rms_ratio"] <= SSM_BF16_RATIO:
        fail(f"{label} {cfg.name}: the bf16 kernel path is "
             f"{res['bf16_rms_ratio']:.3f}x as far from the f32 model as "
             f"the plain path (limit {SSM_BF16_RATIO})")
    return res


def gemma_logit_check(M, params, cfg, batch, fault_cfg, fault_batch, seed):
    """``f32_logit_check`` of a gemma-family model: flash once a layer in
    the prefill, the paged kernel once a layer-step; the planted fault is
    ``fault_cfg`` / ``fault_batch`` on the kernel path."""
    def fault(p32, c32, b32, cont):
        return _path_logits(M, p32, fault_cfg.replace(dtype="float32"),
                            _f32(_on_card(fault_batch)), cont)

    return f32_logit_check(
        "serve_gemma", M, params, cfg, batch,
        want={"flash_attention": cfg.n_layers,
              "paged_attn": cfg.n_layers * GEMMA_DECODE_STEPS},
        faults={"fault": fault}, tol=GEMMA_F32_LOGIT_TOL, seed=seed)


def _gemma_make(cls, params, cfg, batches, max_new, max_len):
    """An engine factory over the phase's slots and segments:
    ``make(batches, new=max_new, **kw)`` submits each batch with ``new``
    tokens to generate (a warm-up takes one segment's)."""
    def make(bs=batches, new=max_new, **kw):
        eng = cls(params, cfg, n_slots=GEMMA_SLOTS, seg_len=GEMMA_SEG,
                  max_len=max_len, device="cuda", **kw)
        for b in bs:
            eng.submit(b, max_new=new)
        return eng
    return make


def _gemma_run(label, M, make, batches, lens, max_new, cfg):
    """One timed run of ``make``'s engine on the batches: completions,
    the block pool, launches (flash once a layer a prefill; the paged
    engine's paged kernel once a layer a decode step; nothing else) and
    the serving readings with the pool's bytes.  Returns (readings,
    completions, launches)."""
    eng, comps, wall, launches, peak = _engine_run(lambda: make(batches))
    _check_served(label, eng, comps, lens, max_new, cfg.vocab_size)
    st = eng.stats
    steps = st["segments"] * GEMMA_SEG
    paged = hasattr(eng, "alloc")
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": cfg.n_layers * st["prefills"],
            "paged_attn": cfg.n_layers * steps if paged else 0}
    if launches != want or st["prefills"] != len(batches):
        fail(f"{label}: launches {launches} != expected {want} "
             f"({st['prefills']} prefills, {steps} decode steps)")
    res = _serve_readings(eng, comps, wall, peak, GEMMA_SEG)
    res["pool_bytes"] = (M.paged_cache_nbytes(cfg, GEMMA_SLOTS, eng.n_blocks,
                                              eng.block_len) if paged else
                         M.cache_nbytes(cfg, GEMMA_SLOTS, eng.max_len))
    res["launches"] = {k: v for k, v in launches.items() if v}
    return res, {u: c.tokens.tolist() for u, c in comps.items()}, launches


def _gemma_init(cfg, label):
    """Weights from seed 0 drawn on the card, ``label`` printed with their
    count; (params, parameters, init peak GB)."""
    from repro_torch import convert
    from repro_torch.models import model as M
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in convert.flatten(params).values())
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label}: {n / 1e9:.3f}B params {cfg.dtype}, "
          f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f}s, "
          f"init peak {peak:.2f} GB")
    return params, n, peak


def _same_tokens(a, b):
    """Requests whose completions two runs agree on, token for token."""
    return sum(a[u] == b[u] for u in a)


def _serve_gemma2(arch, n_layers, picks):
    """Gemma-2 at full width, ``n_layers`` deep: the logit checks on the
    long request, then the serve traffic's requests ``picks`` plus the
    long request through the paged and the contiguous engine.  Returns
    (readings, launches, params, cfg, the picked traffic)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine, ServeEngine
    cfg = get_config(arch, variant="full")
    if not (cfg.use_kernels and cfg.sliding_window == GEMMA_WINDOW
            and cfg.attn_logit_softcap == GEMMA_CAP
            and cfg.final_logit_softcap == 30.0 and cfg.post_block_norm
            and cfg.attn_pattern == ("local", "full")):
        fail(f"{arch} config: {cfg}")
    cfg = cfg.replace(n_layers=n_layers)
    params, n_params, init_peak = _gemma_init(cfg, f"serve_gemma {arch}")
    lens, prompts = _serve_prompts(cfg)
    long = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, GEMMA_LONG)).astype(np.int32)
    lens = [lens[i] for i in picks] + [GEMMA_LONG]
    batches = [{"tokens": prompts[i]} for i in picks] + [{"tokens": long}]
    max_new = 64
    max_len = GEMMA_LONG + max_new
    with torch.no_grad():
        check = gemma_logit_check(M, params, cfg, {"tokens": long},
                                  cfg.replace(sliding_window=0),
                                  {"tokens": long}, seed=9)
        runs, toks, counts = {}, {}, []
        for name, cls in (("paged", PagedServeEngine),
                          ("contiguous", ServeEngine)):
            make = _gemma_make(cls, params, cfg, batches, max_new, max_len)
            make(batches[:2], GEMMA_SEG).run()      # warm-up
            runs[name], toks[name], c = _gemma_run(
                f"serve_gemma {arch} {name}", M, make, batches, lens, max_new,
                cfg)
            counts.append(c)
    res = {"arch": arch, "layers": n_layers, "n_params": n_params,
           "weights_gb": 2 * n_params / 1e9, "init_peak_gb": init_peak,
           "kv_bytes_per_token": M.cache_nbytes(cfg, 1, 2)
           - M.cache_nbytes(cfg, 1, 1), "prompt_lens": lens,
           "runs": runs,
           "paged_vs_contiguous_equal_requests": _same_tokens(
               toks["paged"], toks["contiguous"])}
    print(f"serve_gemma {arch} ({CARD}) " + json.dumps(res))
    res["logit_check"] = check
    return res, _sum_counts(*counts), params, cfg, (lens, batches)


def _serve_gemma9():
    """Gemma-2-9B at full width on GEMMA9_LAYERS layers: 8 of the 16
    requests (every other, for the script's time limit) and the long one
    through both engines, then the 8 unbucketed and bucketed, then the
    f32 token identity on GEMMA_F32_IDENTITY_LAYERS layers."""
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine
    res, launches, params, cfg, (lens, batches) = _serve_gemma2(
        "gemma2-9b", GEMMA9_LAYERS, list(range(1, 16, 2)))
    ps, ls = batches[:-1], lens[:-1]     # all but the long request
    max_new = 64
    make = _gemma_make(PagedServeEngine, params, cfg, ps, max_new,
                       max(ls) + max_new)
    with torch.no_grad():
        e8, c8, w8, _, pk8 = _engine_run(lambda: make(ps))
        unbucketed = _serve_readings(e8, c8, w8, pk8, GEMMA_SEG)
        del e8
        _, chunk_launches = _bucketed_serve(
            "serve_gemma gemma2-9b", make, ps[:1], ps, ls, max_new, cfg,
            GEMMA_SEG, unbucketed, warm_new=GEMMA_SEG, n_attn=cfg.n_layers)
        cut, ccfg = _cut_depth(params, cfg, GEMMA_F32_IDENTITY_LAYERS)
        _f32_token_identity(
            f"serve_gemma gemma2-9b ({GEMMA_F32_IDENTITY_LAYERS} layers)",
            cut, ccfg, PagedServeEngine, [b["tokens"] for b in ps], max_new,
            n_slots=GEMMA_SLOTS, seg_len=GEMMA_SEG, max_len=max(ls) + max_new)
    del params, cut
    torch.cuda.empty_cache()
    return res, _sum_counts(launches, chunk_launches)


def _vlm_prefix_blocks(M, params, cfg, batch, other):
    """A paged engine admits ``batch`` twice and ``batch``'s text behind
    ``other`` patches: the first two must hold the same full prompt
    blocks, the third none of theirs; then all three complete, the
    first two with equal tokens."""
    from repro_torch.serve import PagedServeEngine
    P = batch["tokens"].shape[1]
    n_full = M.decode_pos0(cfg, P) // 16
    eng = PagedServeEngine(params, cfg, n_slots=3, seg_len=GEMMA_SEG,
                           max_len=M.decode_capacity(cfg, P, 16),
                           device="cuda")
    for b in (batch, batch, {"tokens": batch["tokens"], "patches": other}):
        eng.submit(b, max_new=16)
    eng._admit()
    a, b, c = (eng._slot_blocks[u][:n_full] for u in range(3))
    comps = eng.run()
    res = {"full_prompt_blocks": n_full, "shared_blocks":
           eng.stats["shared_blocks"],
           "same_patches_share_all": a == b,
           "other_patches_share_none": not set(a) & set(c),
           "same_patches_equal_tokens":
           comps[0].tokens.tolist() == comps[1].tokens.tolist()}
    if not (res["same_patches_share_all"] and res["other_patches_share_none"]
            and res["same_patches_equal_tokens"]
            and res["shared_blocks"] == n_full):
        fail(f"serve_gemma paligemma-3b prefix sharing: {res}")
    return res


def _serve_paligemma():
    """PaliGemma-3B at full width and depth: 8 requests of 256 stub patch
    rows and 187-1024 text tokens (every other of the 16, for the
    script's time limit) through both engines, unbucketed and
    bucketed; the logit check on the longest with the patches zeroed as
    the fault; the prefix blocks keyed by the patches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine, ServeEngine
    cfg = get_config("paligemma-3b", variant="full")
    if not (cfg.use_kernels and cfg.arch_type == "vlm"
            and M.decode_offset(cfg) == 256):
        fail(f"paligemma config: {cfg}")
    params, n_params, init_peak = _gemma_init(cfg,
                                               "serve_gemma paligemma-3b")
    rng = np.random.default_rng(2)
    lens = [int(p) for p in np.linspace(128, 1024, 16)]
    batches = [prompt_batch(cfg, rng, P) for P in lens]
    lens, batches = lens[1::2], batches[1::2]
    max_new = 64
    max_len = M.decode_capacity(cfg, max(lens), max_new)
    runs, toks, counts = {}, {}, []
    with torch.no_grad():
        long = batches[-1]
        check = gemma_logit_check(
            M, params, cfg, long, cfg,
            {**long, "patches": torch.zeros_like(long["patches"])}, seed=2)
        for name, cls in (("paged", PagedServeEngine),
                          ("contiguous", ServeEngine)):
            make = _gemma_make(cls, params, cfg, batches, max_new, max_len)
            make(batches[:2], GEMMA_SEG).run()      # warm-up
            runs[name], toks[name], c = _gemma_run(
                f"serve_gemma paligemma-3b {name}", M, make, batches, lens,
                max_new, cfg)
            # the contiguous engine's decode and chunks read the cache
            # in plain PyTorch: no kernel there
            bk, c2 = _bucketed_serve(
                f"serve_gemma paligemma-3b {name}", make, batches[:2],
                batches, lens, max_new, cfg, GEMMA_SEG, runs[name],
                warm_new=GEMMA_SEG,
                n_attn=cfg.n_layers if name == "paged" else 0)
            runs[f"{name}_bucketed"] = bk["bucketed"]
            counts += [c, c2]
        prefix = _vlm_prefix_blocks(M, params, cfg, batches[0],
                                    batches[1]["patches"])
    res = {"arch": cfg.name, "n_params": n_params,
           "weights_gb": 2 * n_params / 1e9, "init_peak_gb": init_peak,
           "frontend_rows": M.decode_offset(cfg), "text_lens": lens,
           "runs": runs, "prefix_sharing": prefix,
           "paged_vs_contiguous_equal_requests": _same_tokens(
               toks["paged"], toks["contiguous"])}
    print(f"serve_gemma paligemma-3b ({CARD}) " + json.dumps(res))
    res["logit_check"] = check
    del params
    torch.cuda.empty_cache()
    return _sum_counts(*counts)


def phase_serve_gemma():
    """Gemma-2-9B at full width on GEMMA9_LAYERS layers (its long request
    past the window), Gemma-2-27B at full width on GEMMA27_LAYERS layers (three
    of the serve requests and the long one), PaliGemma-3B at full width
    and depth; each freed before the next."""
    _, l9 = _serve_gemma9()
    _, l27, params, _, _ = _serve_gemma2("gemma2-27b", GEMMA27_LAYERS,
                                         [0, 7, 15])
    del params
    torch.cuda.empty_cache()
    return _sum_counts(l9, l27, _serve_paligemma())


# ---------------------------------------------------------------------------
# phase 5g: serve Whisper-small (the encoder-decoder family) at full width
# and depth
# ---------------------------------------------------------------------------

# 8 slots of Whisper's decoder context; 16 requests of 4-192 prompt tokens
# and 32-128 new ones, each with its own 1500 stub frames; requests 0-3
# share a 64-token prefix and their frames, 4 and 5 that prefix with other
# frames
ENCDEC_SLOTS, ENCDEC_SEG, ENCDEC_MAX_LEN = 8, 8, 448
ENCDEC_REQUESTS, ENCDEC_PREFIX = 16, 64
# f32 kernel path against plain path, a 192-token request's prefill logits
# and GEMMA_DECODE_STEPS teacher-forced paged decode steps.
# Readings on an H100 (700 W): 1.04e-6 (prefill), 1.19e-6 (decode) on
# logits of at most 2.33; the limit about 4x the worst.  The causal
# encoder moved them by 1.71, zeroed frames by 0.0106 (2,100 limits).
ENCDEC_F32_LOGIT_TOL = 5e-6
# the f32 token identity, bucketed against unbucketed: these requests
ENCDEC_F32_IDENTITY = 8


def _encdec_traffic(cfg):
    """(prompt lengths, max_new by request, request batches): prompts of
    4-192 tokens and 32-128 new tokens (seed 5), stub frames normal x 0.05
    in the model's dtype; requests 0-3 and 4-5 start with one 64-token
    prefix, 0-3 with one set of frames, 4 and 5 each with its own."""
    from repro_torch.launch.serve import prompt_batch
    rng = np.random.default_rng(5)
    lens = [int(p) for p in np.linspace(4, 192, ENCDEC_REQUESTS)][::-1]
    news = [int(n) for n in np.linspace(32, 128, ENCDEC_REQUESTS)]
    batches = [prompt_batch(cfg, rng, P) for P in lens]
    prefix = batches[0]["tokens"][:, :ENCDEC_PREFIX]
    for i in range(6):
        batches[i]["tokens"][:, :ENCDEC_PREFIX] = prefix
        if 0 < i < 4:
            batches[i]["frames"] = batches[0]["frames"]
    if not all(P + n <= ENCDEC_MAX_LEN for P, n in zip(lens, news)):
        fail(f"serve_encdec traffic past {ENCDEC_MAX_LEN}: {lens} {news}")
    return lens, news, batches


def _encdec_prefix_blocks(params, cfg, batches, lens):
    """A paged engine admits requests 0-5 at once: 0-3 (equal frames)
    must hold the same blocks for the shared prefix, 4 and 5 (other
    frames) none of theirs nor each other's."""
    from repro_torch.serve import PagedServeEngine
    n_full = ENCDEC_PREFIX // 16
    eng = PagedServeEngine(params, cfg, n_slots=6, seg_len=ENCDEC_SEG,
                           max_len=max(lens[:6]) + 8, device="cuda")
    for b in batches[:6]:
        eng.submit(b, max_new=8)
    eng._admit()
    held = [eng._slot_blocks[u][:n_full] for u in range(6)]
    eng.run()
    res = {"prefix_blocks": n_full, "shared_blocks":
           eng.stats["shared_blocks"],
           "equal_frames_share_all": all(h == held[0] for h in held[:4]),
           "other_frames_share_none": not (
               set(held[4]) & (set(held[0]) | set(held[5]))
               or set(held[5]) & set(held[0]))}
    if not (res["equal_frames_share_all"] and res["other_frames_share_none"]
            and res["shared_blocks"] == 3 * n_full):
        fail(f"serve_encdec prefix sharing: {res}")
    return res


def _encdec_make(cls, params, cfg, batches, news):
    """An engine factory: ``make(indices, new=None, **kw)`` submits those
    requests with their own max_new, or ``new`` each."""
    def make(idx=range(ENCDEC_REQUESTS), new=None, **kw):
        eng = cls(params, cfg, n_slots=ENCDEC_SLOTS, seg_len=ENCDEC_SEG,
                  max_len=ENCDEC_MAX_LEN, device="cuda", **kw)
        for i in idx:
            eng.submit(batches[i], max_new=new or news[i])
        return eng
    return make


def _encdec_run(label, M, make, lens, news, cfg, **kw):
    """One timed run of the 16 requests: completions, the block pool,
    launches (flash once an encoder layer bidirectional and once a
    decoder layer causal a one-shot prefill, or the encoder's alone and
    the paged kernel once a decoder layer a chunk when bucketed; the paged
    engine's paged kernel once a decoder layer a decode step, from the
    quantized branch for an int8 pool) and the readings.  Returns
    (readings, completions, launches)."""
    eng, comps, wall, launches, peak = _engine_run(lambda: make(**kw))
    _check_served(label, eng, comps, lens, news, cfg.vocab_size)
    st = eng.stats
    steps = st["segments"] * ENCDEC_SEG
    chunks = st["prefill_chunks"]
    paged = hasattr(eng, "alloc")
    quant = eng.policy.quantized
    L, E = cfg.n_layers, cfg.n_enc_layers
    calls = (steps + chunks) * L if paged else 0
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": (E + (0 if chunks else L)) * st["prefills"],
            "flash_attention_bidir": E * st["prefills"],
            "paged_attn": 0 if quant else calls,
            "paged_attn_quant": calls if quant else 0,
            "paged_attn_chunk": chunks * L if paged else 0}
    if launches != want or st["prefills"] != ENCDEC_REQUESTS or not steps:
        fail(f"{label}: launches {launches} != expected {want} "
             f"({st['prefills']} prefills, {chunks} chunks, {steps} decode "
             f"steps)")
    res = _serve_readings(eng, comps, wall, peak, ENCDEC_SEG)
    res["pool_bytes"] = (M.paged_cache_nbytes(cfg, ENCDEC_SLOTS, eng.n_blocks,
                                              eng.block_len, eng.policy)
                         if paged else M.cache_nbytes(
                             cfg, ENCDEC_SLOTS, eng.max_len, eng.policy))
    res["shared_blocks"] = st.get("shared_blocks", 0)
    res["launches"] = {k: v for k, v in launches.items() if v}
    return res, {u: c.tokens.tolist() for u, c in comps.items()}, launches


def _causal_encoder(M, p32, c32, b32, cont):
    """The kernel path's logits with the encoder's blocks run causally
    (``_block_full`` called with ``causal=True``): a planted fault."""
    orig = M._block_full

    def causal(*a, **kw):
        return orig(*a, **{**kw, "causal": True})

    M._block_full = causal
    try:
        return _path_logits(M, p32, c32, b32, cont)
    finally:
        M._block_full = orig


def phase_serve_encdec():
    """Whisper-small at full width and depth (12 encoder and 12 decoder
    layers, d_model 768, 12 heads of 64, V 51,865, 1,500 stub frames;
    bf16, random weights from seed 0): the f32 logit check with a causal
    encoder and zeroed frames as planted faults, the prefix blocks keyed
    by the frames, then the 16 requests through the paged engine (bf16),
    the contiguous engine, the paged engine bucketed (chunks of
    ENCDEC_CHUNK: a 192-token prompt takes three after one encode) and
    the paged engine from an int8 pool; then the f32 model's completions
    bucketed and unbucketed on ENCDEC_F32_IDENTITY requests, equal token
    for token."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import PagedServeEngine, ServeEngine
    cfg = get_config("whisper-small", variant="full")
    if not (cfg.use_kernels and cfg.arch_type == "encdec"
            and cfg.frontend_tokens == ENCDEC_FRAMES
            and M.decode_offset(cfg) == 0):
        fail(f"whisper-small config: {cfg}")
    params, n_params, init_peak = _gemma_init(cfg,
                                               "serve_encdec whisper-small")
    lens, news, batches = _encdec_traffic(cfg)
    L, E = cfg.n_layers, cfg.n_enc_layers
    runs, toks, counts = {}, {}, []
    with torch.no_grad():
        long = batches[0]

        def zeroed(p32, c32, b32, cont):
            return _path_logits(M, p32, c32, {
                **b32, "frames": torch.zeros_like(b32["frames"])}, cont)

        check = f32_logit_check(
            "serve_encdec", M, params, cfg, long,
            want={"flash_attention": E + L, "flash_attention_bidir": E,
                  "paged_attn": L * GEMMA_DECODE_STEPS},
            faults={"causal_encoder": lambda *a: _causal_encoder(M, *a),
                    "zeroed_frames": zeroed},
            tol=ENCDEC_F32_LOGIT_TOL, seed=5)
        prefix = _encdec_prefix_blocks(params, cfg, batches, lens)
        for name, cls, kw in (
                ("paged", PagedServeEngine, {}),
                ("contiguous", ServeEngine, {}),
                ("paged_bucketed", PagedServeEngine,
                 {"chunk_len": ENCDEC_CHUNK}),
                ("paged_int8", PagedServeEngine, {"kv_dtype": "int8"})):
            make = _encdec_make(cls, params, cfg, batches, news)
            make(range(2), ENCDEC_SEG, **kw).run()      # warm-up
            runs[name], toks[name], c = _encdec_run(
                f"serve_encdec {name}", M, make, lens, news, cfg, **kw)
            counts.append(c)
        if runs["paged_bucketed"]["prefill_chunks"] != sum(
                -(-P // ENCDEC_CHUNK) for P in lens):
            fail(f"serve_encdec bucketed: {runs['paged_bucketed']}")
        pick = list(range(0, ENCDEC_REQUESTS, 2))[:ENCDEC_F32_IDENTITY]
        identity = _f32_token_identity(
            "serve_encdec whisper-small", params, cfg, PagedServeEngine,
            [batches[i] for i in pick], 32, chunk_len=ENCDEC_CHUNK,
            n_slots=ENCDEC_SLOTS, seg_len=ENCDEC_SEG, max_len=ENCDEC_MAX_LEN)
    Ta, KH, Dh = cfg.frontend_tokens, cfg.n_kv_heads, cfg.resolved_head_dim
    res = {"arch": cfg.name, "n_params": n_params,
           "weights_gb": 2 * n_params / 1e9, "init_peak_gb": init_peak,
           "self_kv_bytes_per_token": M.cache_nbytes(cfg, 1, 2)
           - M.cache_nbytes(cfg, 1, 1),
           "cross_bytes_per_slot": 2 * 2 * L * Ta * KH * Dh,
           "memory_bytes_per_slot": 2 * Ta * cfg.d_model,
           "prompt_lens": lens, "max_new": news, "runs": runs,
           "prefix_sharing": prefix, "f32_identity": identity,
           "paged_vs_contiguous_equal_requests": _same_tokens(
               toks["paged"], toks["contiguous"]),
           "bucketed_vs_unbucketed_equal_requests": _same_tokens(
               toks["paged"], toks["paged_bucketed"])}
    print(f"serve_encdec ({CARD}) " + json.dumps(res))
    res["logit_check"] = check
    del params
    torch.cuda.empty_cache()
    return _sum_counts(*counts)


# ---------------------------------------------------------------------------
# phase 5h: sharded serving, expert parallelism over an NCCL mesh
# ---------------------------------------------------------------------------

SHARDED_ARCH = "qwen2-moe-a2.7b"
SHARDED_IMPLS = ("a2a", "replicated_ep")
# the layer check: the tune step's tokens (4 x 1024) through one MoE
# layer at full width, f32.  capacity_factor 2.0 sizes every path's
# buffers for twice the mean load (dense 548 slots an expert, a2a 552,
# replicated_ep 548), so nothing drops (checked): the paths compute one
# function and their outputs and gradients must agree to f32 sums in
# another order, SHARDED_REL_TOL of each tensor's largest |value|
SHARDED_LAYER_BS = (4, 1024)
SHARDED_CF = 2.0
SHARDED_REL_TOL = 1e-5
# the engine check: f32 on the first 4 layers, the 4 shortest of the
# serve prompts, 16 new tokens, bucketed admission in chunks of 8 rows
# in every engine (a chunk of 8 rows fills at most 8 of the mesh=None
# path's 8 capacity slots an expert, so it drops nothing either)
SHARDED_F32_LAYERS = 4
SHARDED_F32_NEW = 16
SHARDED_CHUNK = 8
# the profiles' kernel groups: NCCL's kernels, kernels 4 and 5 (the f32
# instance runs the grouped FFN as grouped products and a gate pass),
# kernel 6, kernel 2
SHARDED_GROUPS = {"nccl": ("nccl",),
                  "kernels 4-5": ("ffn_", "gmm_", "gate_kernel",
                                  "split_kernel"),
                  "kernel 6": ("gsa_",), "kernel 2": ("paged_fwd",)}


def _nccl_mesh():
    """An NCCL process group of one rank over an in-process store (NCCL
    will not put two ranks on one card), started by the first phase that
    asks and kept for the next (``main`` ends it), and its (1, 1) decode
    mesh."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM
    LM.init_process_group("cuda")
    mesh = LM.make_decode_mesh(device="cuda")
    if tuple(mesh.shape) != (1, 1) or "nccl" not in str(dist.get_backend()):
        fail(f"mesh {tuple(mesh.shape)} on {dist.get_backend()}, expected "
             "(1, 1) on nccl")
    return mesh


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp(min=1e-30)).item()


def _sharded_layer_check(moe, cfg, p, mesh):
    """One full-width MoE layer (f32) through moe_dense on the kernel path
    and through both forced sharded paths on the (1, 1) mesh: output,
    aux loss and every gradient (x, router, experts, shared experts) of
    sum(out * ct) + aux within SHARDED_REL_TOL; kernels 4, 5 and 6
    launched by each sharded path's forward and backward, none by their
    plain versions (``use_kernels=False``, forward held to the same
    limit); each path's forward time and the NCCL kernels' device time
    of a forward and backward."""
    from repro_torch.kernels.moe_dispatch import ops as md
    from repro_torch.utils.pytree import tree_map, tree_paths
    B, S = SHARDED_LAYER_BS
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    ct = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    c = cfg.replace(capacity_factor=SHARDED_CF, moe_dropless=False)
    T, k, E = B * S, c.top_k, c.n_experts
    with torch.no_grad():
        _, idx, _ = moe.route(p, c, x.reshape(T, -1))
    load = int(torch.bincount(idx.reshape(-1), minlength=E).max())
    caps = {"dense": max(-(-T * k // E) * 2, 8),
            "a2a": moe._capacity(c, T, E, align=8),
            "replicated_ep": min(-(-moe._capacity(c, T, E, align=1) // 4)
                                 * 4, max(T, 4))}
    if load > min(caps.values()):
        fail(f"serve_sharded layer check: an expert takes {load} rows, past "
             f"a capacity of {caps}: paths that drop are not comparable")

    def run(impl, use_kernels=True, grads=True):
        cc = c.replace(moe_impl=impl, use_kernels=use_kernels)
        q = tree_map(lambda t: t.detach().requires_grad_(grads),
                     moe.shard_experts({"moe": p}, cc, mesh)["moe"])
        xx = x.detach().requires_grad_(grads)

        def fwd_bwd():
            out, aux = moe.apply_moe(q, cc, xx, mesh)
            if grads:
                ((out * ct).sum() + aux).backward()
            return out.detach(), aux.detach()

        (out, aux), n = _launched(fwd_bwd)
        g = {"x": xx.grad} if grads else {}
        if grads:
            g.update({path: t.grad for path, t in tree_paths(q)})
        return out, aux, g, n

    want, want_aux, want_g, n_dense = run("dense")
    res = {"T": T, "E": E, "top_k": k, "largest_load": load,
           "capacities": caps, "dense_launches": n_dense}
    for impl in SHARDED_IMPLS:
        out, aux, g, n = run(impl)
        errs = {"out": _rel_err(out, want), "aux": _rel_err(aux, want_aux),
                **{f"d{name}": _rel_err(g[name], want_g[name])
                   for name in want_g}}
        worst = max(errs.values())
        if not worst <= SHARDED_REL_TOL or not torch.isfinite(out).all():
            fail(f"serve_sharded layer check {impl}: {errs}")
        if not (n["grouped_ffn"] and n["grouped_matmul"]
                and n["gather_scatter_add"] >= 4):
            fail(f"serve_sharded layer check {impl}: launches {n}")
        pout, _, _, pn = run(impl, use_kernels=False, grads=False)
        if any(pn.values()) or not _rel_err(pout, want) <= SHARDED_REL_TOL:
            fail(f"serve_sharded layer check {impl} plain: launches {pn}, "
                 f"err {_rel_err(pout, want)}")
        cc = c.replace(moe_impl=impl)
        q = moe.shard_experts({"moe": p}, cc, mesh)["moe"]
        with torch.no_grad():
            ms = time_ms(lambda: moe.apply_moe(q, cc, x, mesh), iters=5,
                         warmup=1)
        prof = profile(lambda: run(impl), top=4, groups=SHARDED_GROUPS)
        res[impl] = {"rel_err": errs, "worst_rel_err": worst,
                     "launches_fwd_bwd": {kk: v for kk, v in n.items() if v},
                     "plain_max_rel_err": _rel_err(pout, want),
                     "fwd_ms": ms, "fwd_bwd_device_ms": prof["device_ms"],
                     "group_ms": prof["group_ms"],
                     "group_launches": prof["group_launches"]}
    with torch.no_grad():
        res["dense_fwd_ms"] = time_ms(
            lambda: moe.apply_moe(p, c.replace(moe_impl="dense"), x), iters=5,
            warmup=1)
    res["gsa_instances"] = dict(md.LAUNCHES_BY_INSTANCE)
    return res


def _sharded_engines_f32(M, moe, params, cfg, mesh, prompts, lens):
    """The f32 model cut to SHARDED_F32_LAYERS layers: 4 requests through
    both engines with bucketed admission (chunks of SHARDED_CHUNK), on
    mesh=None and on the mesh through both forced paths; every sharded
    run's tokens equal to mesh=None's, and kernels 4 and 6 launched in
    them."""
    from repro_torch.serve import PagedServeEngine, ServeEngine
    from repro_torch.utils.pytree import tree_map
    p32, c32 = _cut_depth(params, cfg, SHARDED_F32_LAYERS)
    p32 = tree_map(lambda t: t.float(), p32)
    c32 = c32.replace(dtype="float32")
    pick = range(4)
    max_len = max(lens[i] for i in pick) + SHARDED_F32_NEW

    def make(cls, c, on_mesh):
        kw = {"block_len": 16} if cls is PagedServeEngine else {}
        eng = cls(p32, c, n_slots=4, seg_len=8, max_len=max_len,
                  device="cuda", chunk_len=SHARDED_CHUNK,
                  mesh=mesh if on_mesh else None, **kw)
        for i in pick:
            eng.submit({"tokens": prompts[i]}, max_new=SHARDED_F32_NEW)
        return eng

    res = {}
    for cls in (ServeEngine, PagedServeEngine):
        _, comps, wall, _, _ = _engine_run(lambda: make(cls, c32, False))
        want = _tokens(comps)
        row = {"mesh=None_wall_s": wall}
        for impl in SHARDED_IMPLS:
            eng, comps, wall, n, _ = _engine_run(
                lambda: make(cls, c32.replace(moe_impl=impl), True))
            if _tokens(comps) != want:
                fail(f"serve_sharded f32 {cls.__name__} {impl}: tokens "
                     f"{_first_divergence(_tokens(comps), want)} differ "
                     f"from mesh=None")
            if not (n["grouped_ffn"] and n["gather_scatter_add"]):
                fail(f"serve_sharded f32 {cls.__name__} {impl}: launches {n}")
            row[impl] = {"wall_s": wall, "equal": True,
                         "tokens": sum(len(t) for t in want.values()),
                         "grouped_ffn": n["grouped_ffn"],
                         "gather_scatter_add": n["gather_scatter_add"]}
        res[cls.__name__] = row
    del p32
    torch.cuda.empty_cache()
    return res


def _sharded_launcher():
    """``launch/serve.py --sharded --check-unsharded --paged`` in process,
    on the group this phase holds."""
    import contextlib
    import io
    from repro_torch.launch import serve as launch_serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", SHARDED_ARCH, "--variant", "reduced",
                           "--sharded", "--check-unsharded", "--paged"])
    text = out.getvalue()
    if "check-unsharded: completions match" not in text:
        fail(f"serve_sharded launcher: {text[-500:]}")
    return [ln for ln in text.splitlines() if ln.startswith(("sharded:",
                                                             "check-"))]


def phase_serve_sharded():
    """Qwen1.5-MoE-A2.7B at full width with its experts on an NCCL mesh of
    one rank, (1, 1), the MoE forced onto the sharded paths, so that the
    collectives and kernels 4-6 run on the sharded buffer layout: the
    layer check (``_sharded_layer_check``); the f32 engine check
    (``_sharded_engines_f32``); then the bf16 model at full depth, 8 of
    the 16 requests (every other) through the paged engine, mesh=None,
    then the a2a path with every launch counted (the main path): tok/s,
    ms a decode step against mesh=None's, each request's first
    divergence from it (mesh=None's kernel path drops assignments in
    prefill, the sharded path's serving capacity none); the launcher with
    ``--sharded --check-unsharded``.  Returns the a2a run's launches."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve import PagedServeEngine
    mesh = _nccl_mesh()
    cfg = get_config(SHARDED_ARCH, variant="full")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    lens, prompts = _serve_prompts(cfg)
    with torch.no_grad():
        p32 = {k: v.float() for k, v in M._layer(
            params["blocks"]["sub0"]["moe"], 0).items() if k != "shared"}
        p32["shared"] = {k: v.float() for k, v in M._layer(
            params["blocks"]["sub0"]["moe"], 0)["shared"].items()}
    layer = _sharded_layer_check(moe, cfg.replace(dtype="float32"), p32,
                                 mesh)
    del p32
    print(f"serve_sharded layer check ({CARD}) " + json.dumps(layer))
    with torch.no_grad():
        f32 = _sharded_engines_f32(M, moe, params, cfg, mesh, prompts, lens)
    print(f"serve_sharded f32 engines ({CARD}) " + json.dumps(f32))

    ps, ls = prompts[1::2], lens[1::2]
    max_new, n_slots, bl, seg_len = 64, 8, 16, 8

    def make_engine(c, on_mesh):
        eng = PagedServeEngine(params, c, n_slots=n_slots, block_len=bl,
                               seg_len=seg_len, max_len=max(lens) + max_new,
                               device="cuda", mesh=mesh if on_mesh else None)
        for p in ps:
            eng.submit({"tokens": p}, max_new=max_new)
        return eng

    with torch.no_grad():
        eng, comps, wall, _, peak = _engine_run(
            lambda: make_engine(cfg, False))
        base = _serve_readings(eng, comps, wall, peak, seg_len)
        want = _tokens(comps)
        del eng
        c = cfg.replace(moe_impl="a2a")
        eng, comps, wall, launches, peak = _engine_run(
            lambda: make_engine(c, True))
    _check_served("serve_sharded a2a", eng, comps, ls, max_new,
                  cfg.vocab_size)
    st = eng.stats
    steps = st["segments"] * seg_len
    calls = st["prefills"] + steps
    expect = {**dict.fromkeys(launches, 0),
              "flash_attention": cfg.n_layers * st["prefills"],
              "paged_attn": cfg.n_layers * steps,
              "grouped_ffn": n_moe * calls,
              "gather_scatter_add": 2 * n_moe * calls}
    if launches != expect or steps <= 0:
        fail(f"serve_sharded a2a: launches {launches} != {expect}")
    got = _tokens(comps)
    div = _first_divergence(got, want)
    shard = _serve_readings(eng, comps, wall, peak, seg_len)
    del eng
    with torch.no_grad():
        # one decode segment with every slot live, under the profiler
        # (serve_moe profiles mesh=None's on the same card)
        eng = make_engine(c, True)
        eng.step()
        seg = profile(eng.step, top=6, groups=SHARDED_GROUPS)
    seg["launches_per_layer_step"] = seg["device_launches"] / (
        cfg.n_layers * seg_len)
    res = {"arch": SHARDED_ARCH, "mesh": list(mesh.shape),
           "backend": str(dist.get_backend()), "a2a": shard,
           "mesh=None": base,
           "decode_step_ratio": (shard["ms_per_decode_step"]
                                 / base["ms_per_decode_step"]),
           "tok_per_s_ratio": shard["tok_per_s"] / base["tok_per_s"],
           "requests_diverging": len(div), "first_divergence": div,
           "launches": launches}
    print(f"serve_sharded bf16 ({CARD}) " + json.dumps(res))
    print(f"serve_sharded profile (a2a, decode segment of {seg_len} steps) "
          + json.dumps(seg))
    del eng, params
    torch.cuda.empty_cache()
    print("serve_sharded launcher: " + json.dumps(_sharded_launcher()))
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
    del params, opt, steps
    _train_policies(D, M, cfg, corpus, spec, run, losses, kd_ops, fa_ops,
                    want)
    return launches


# the reference's tracking limits (tests/test_quantized.py): each
# policy's losses against the fp32 run's over the same 8 steps
POLICY_LOSS_ATOL = {"bf16": 2e-2, "int8": 5e-2}


def _policy_step(D, M, cfg, corpus, policy):
    """ms of three synchronised steps (after one warm-up) from fresh
    seed-0 weights with ``policy``'s moments, and the peak memory over
    them with the resident state (params, moments) apart."""
    from repro_torch.optim import adamw_init, cosine_schedule
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = M.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = adamw_init(params, policy=policy)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    sched = cosine_schedule(TRAIN_LR, TRAIN_STEPS, warmup=1)
    batches = corpus.device_batches(0, 4, TRAIN_BATCH, TRAIN_SEQ)
    steps = [{k: v[s].cuda() for k, v in batches.items()} for s in range(4)]
    D.train_step(params, opt, cfg, steps[0], sched(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for b in steps[1:]:
        t0 = time.perf_counter()
        D.train_step(params, opt, cfg, b, sched(2))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() - base
    del params, opt, steps
    return ms, resident / 1e9, peak / 1e9


def _train_policies(D, M, cfg, corpus, spec, run, fp32_losses, kd_ops,
                    fa_ops, want):
    """The train phase's run again with bf16 and int8 AdamW moments: the
    launches of each 8-step ``train_device`` (counts from 0), its losses
    against the fp32 run's at the reference's limits, and per policy ms
    per step, tokens/s, the resident state and the peak."""
    rows = []
    for policy in ("", "bf16", "int8"):
        row = {"policy": policy or "fp32"}
        if policy:
            torch.cuda.empty_cache()
            fa_ops.LAUNCHES = 0
            kd_ops.LAUNCHES = 0
            kd_ops.LAUNCHES_BY_INSTANCE.update(dict.fromkeys(
                kd_ops.LAUNCHES_BY_INSTANCE, 0))
            losses = D.train_device(spec, corpus, state_policy=policy,
                                    **run)["losses"]
            torch.cuda.synchronize()
            got = {"flash_attention": fa_ops.LAUNCHES,
                   "kd_loss": kd_ops.LAUNCHES}
            if got != want:
                fail(f"train ({policy}) launches {got} != expected {want}")
            _all_wgmma(kd_ops, f"train ({policy})")
            dev = max(abs(a - b) for a, b in zip(losses, fp32_losses))
            row.update(losses=losses, max_abs_loss_diff=dev,
                       loss_atol=POLICY_LOSS_ATOL[policy])
            if not dev <= POLICY_LOSS_ATOL[policy]:
                fail(f"train ({policy}): losses {losses} stray {dev} from "
                     f"fp32's, past {POLICY_LOSS_ATOL[policy]}")
        ms, resident, peak = _policy_step(D, M, cfg, corpus, policy)
        mid = sorted(ms)[len(ms) // 2]
        row.update(step_ms=ms, ms_per_step=mid,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (mid / 1e3),
                   resident_gb=resident, peak_gb=peak)
        rows.append(row)
    print(f"train policies ({CARD}) " + json.dumps(rows))


def _counts():
    """Every kernel wrapper's launch count, by the kernels line's names."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.LAUNCHES,
            "paged_attn": pa_ops.LAUNCHES,
            "paged_attn_quant": pa_ops.LAUNCHES_QUANT,
            "kd_loss": kd_ops.LAUNCHES_BY_MODE["ce"],
            "kd_loss_kd": kd_ops.LAUNCHES_BY_MODE["kd"],
            "grouped_ffn": mg_ops.LAUNCHES["grouped_ffn"],
            "grouped_matmul": mg_ops.LAUNCHES["grouped_matmul"],
            "split_f32": mg_ops.LAUNCHES["split_f32"],
            "gather_scatter_add": md_ops.LAUNCHES,
            "ssd_scan": ssd_ops.LAUNCHES,
            "paged_attn_chunk": pa_ops.LAUNCHES_CHUNK,
            "ssd_scan_h0": ssd_ops.LAUNCHES_H0,
            "flash_attention_bidir": fa_ops.LAUNCHES_BIDIR}


def _zero_counts():
    """Every count of ``_counts()`` set to 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.kernels.paged_attn import ops as pa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    fa_ops.LAUNCHES = kd_ops.LAUNCHES = md_ops.LAUNCHES = 0
    pa_ops.LAUNCHES = pa_ops.LAUNCHES_QUANT = ssd_ops.LAUNCHES = 0
    pa_ops.LAUNCHES_CHUNK = ssd_ops.LAUNCHES_H0 = 0
    fa_ops.LAUNCHES_BIDIR = 0
    for d in (kd_ops.LAUNCHES_BY_INSTANCE, kd_ops.LAUNCHES_BY_MODE,
              mg_ops.LAUNCHES, mg_ops.LAUNCHES_BY_INSTANCE,
              md_ops.LAUNCHES_BY_INSTANCE, ssd_ops.LAUNCHES_BY_INSTANCE):
        d.update(dict.fromkeys(d, 0))


# ---------------------------------------------------------------------------
# phase 6b/6c: train the ssm family (Mamba2-1.3B) and the hybrid (Zamba2-7B)
# ---------------------------------------------------------------------------

SSM_TRAIN_STEPS = 8
HYBRID_TRAIN_STEPS = 4
# Zamba2-7B trained at full width on 15 of its 81 blocks: two groups of 6
# behind the shared block, then the shared block before a 3-block tail, as
# the full model's 81 = 13 x 6 + 3 ends (the only cut: 6.64 B parameters
# with fp32 AdamW moments do not fit 80 GB)
HYBRID_TRAIN_LAYERS = 15
# the first steps' losses held kernel path against plain path (step 0
# runs at lr 0, so the third is the first after an update)
TRAIN_LOSS_STEPS = 3
# Limits set from readings on an H100 (700 W), each about 3x the worst:
# one full-width Mamba-2 block's gradients, kernel path against plain path
# (relative L2 of each leaf; readings 4.85e-3 bf16, 1.41e-5 f32)
SSM_BLOCK_GRAD_TOL = {"bfloat16": 0.015, "float32": 5e-5}
# ssd_bwd (its f32 recompute) against the same in f64, on the path's scan
# inputs with random cotangents (relative L2 of each gradient; bf16
# inputs get bf16 gradients: readings 2.39e-3 bf16, 1.71e-5 f32)
SSD_BWD_F64_TOL = {"bfloat16": 7e-3, "float32": 5e-5}
# the first TRAIN_LOSS_STEPS bf16 losses, kernel path against plain path:
# 48 (Mamba2) or 15 (Zamba2) blocks of bf16 activations rounded at other
# points (first readings 0.0039 and 0.0112 on losses of about 11)
TRAIN_LOSS_TOL = {"mamba2-1.3b": 0.012, "zamba2-7b": 0.035}
# Zamba2's 15 blocks: the loss (absolute) and every gradient (relative
# L2) on one 1 x 1024 batch.  f32 is the sharp check (readings 3.8e-6 and
# 1.36e-4); in bf16 the two paths' roundings through 15 random blocks
# move every gradient by about a quarter (readings 3.75e-3 and 0.288), as
# they move the served logits (serve_hybrid).
HYBRID_LOSS_TOL = {"float32": 1.5e-5, "bfloat16": 0.012}
HYBRID_GRAD_TOL = {"float32": 4e-4, "bfloat16": 0.9}


def _rel_l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _scan_tap(ssd_ops, seen):
    """``ssd_ops.ssd`` wrapped to keep a detached copy of each call's
    inputs and chunk in ``seen``; returns (the kernel's wrapper, tap)."""
    kernel = ssd_ops.ssd

    def tap(xh, dt, A, Bh, Ch, *, chunk=128, init_state=None):
        if not seen:
            seen.append(([None if t is None else t.detach().clone()
                          for t in (xh, dt, A, Bh, Ch, init_state)], chunk))
        return kernel(xh, dt, A, Bh, Ch, chunk=chunk, init_state=init_state)
    return kernel, tap


def _ssd_bwd_vs_f64(ssd_ops, saved, chunk, label):
    """``ssd_bwd`` on the path's scan inputs against the same backward in
    f64 (the plain version recomputed in f64 and differentiated), with
    random cotangents of y and of the final state."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    xh, Bh = saved[0], saved[3]
    B, S, H, P = xh.shape
    dy = torch.randn(xh.shape, generator=gen, device="cuda").to(xh.dtype)
    dh = torch.randn((B, H, P, Bh.shape[-1]), generator=gen, device="cuda")
    got = ssd_ops.ssd_bwd(saved, dy, dh, chunk=chunk)
    want = ssd_ops.ssd_bwd([None if t is None else t.double() for t in saved],
                           dy.double(), dh.double(), chunk=chunk)
    res = {f"{n}_rel_l2": _rel_l2(g, w)
           for n, g, w in zip(("xh", "dt", "A", "Bh", "Ch", "init_state"),
                              got, want) if w is not None}
    worst, tol = max(res.values()), SSD_BWD_F64_TOL[str(xh.dtype)[6:]]
    print(f"{label}: ssd_bwd vs f64 ({CARD}) " + json.dumps(res))
    if not worst <= tol:
        fail(f"{label}: ssd_bwd differs from its f64 version by {worst} "
             f"(relative L2) > {tol}")
    return worst


def _ssm_block_grad_check(cfg, params, dtype):
    """One full-width Mamba-2 block (layer 0 of ``params``) on x ~ N(0, 1)
    of 2 x 1024 tokens and a random cotangent: the gradients of x and of
    every block parameter, kernel path (kernel 7 under autograd) against
    the plain path (``ssd_chunked``), in ``dtype``.  The kernel run must
    launch kernel 7 once, the plain run nothing.  Then ``ssd_bwd`` on the
    scan inputs caught in the kernel run, against f64."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import layers, ssm
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths
    name = str(dtype)[6:]
    c = cfg.replace(dtype=name)
    bp = tree_map(lambda t: t[0].to(torch.float32 if t.dtype == torch.float32
                                    else dtype).clone(), params["blocks"])
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 1024, cfg.d_model), generator=gen,
                    device="cuda").to(dtype)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    leaves = [t.requires_grad_(True) for t in tree_leaves(bp)]
    x.requires_grad_(True)

    def grads(use_kernels):
        out = x + ssm.ssm_forward(bp["mixer"], c.replace(
            use_kernels=use_kernels), layers.apply_norm(bp["ln"], x))
        return torch.autograd.grad(out, leaves + [x], dy)

    seen = []
    kernel, tap = _scan_tap(ssd_ops, seen)
    ssd_ops.ssd = tap
    try:
        gk, n_k = _launched(lambda: grads(True))
    finally:
        ssd_ops.ssd = kernel
    gp, n_p = _launched(lambda: grads(False))
    if n_k["ssd_scan"] != 1 or any(n_p.values()):
        fail(f"train_ssm block ({name}): kernel path launched {n_k}, plain "
             f"path {n_p}")
    res = {p: _rel_l2(a, b)
           for p, a, b in zip([q for q, _ in tree_paths(bp)] + ["x"], gk,
                              gp)}
    worst = max(res, key=res.get)
    print(f"train_ssm block grads kernel vs plain ({name}, {CARD}) "
          + json.dumps(res))
    if not res[worst] <= SSM_BLOCK_GRAD_TOL[name]:
        fail(f"train_ssm block ({name}): the {worst} gradient differs from "
             f"the plain path's by {res[worst]} (relative L2) > "
             f"{SSM_BLOCK_GRAD_TOL[name]}")
    f64 = _ssd_bwd_vs_f64(ssd_ops, *seen[0], f"train_ssm block ({name})")
    return {f"block_{name}_worst_leaf": worst,
            f"block_{name}_grad_rel_l2": res[worst],
            f"ssd_bwd_vs_f64_{name}": f64}


def _train_flops(M, cfg, batch, seq):
    """Model FLOPs of one training step, PERF.md §2's MFU numerator: 6 x
    the matmul parameters a token passes (the tied head counted, the
    shared block once per application) x tokens, plus causal attention and
    the SSD scan (``ssd_bound_ms``'s count), each forward and twice in the
    backward."""
    if cfg.attn_type == "mla":
        return _mla_train_flops(cfg, batch, seq)
    D, T = cfg.d_model, batch * seq
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    mamba = D * (2 * cfg.d_inner + 2 * G * N + H) + cfg.d_inner * D
    scan = ssd_bound_ms(batch, seq, H, cfg.ssm_head_dim, N, G,
                        min(cfg.ssm_chunk, seq), torch.bfloat16,
                        False)[2] * 1e9
    n_attn = 0
    attn = attn_ops = 0.0
    if cfg.arch_type == "hybrid":
        _, n_groups, tail = M._hybrid_layout(cfg)
        n_attn = n_groups + (1 if tail else 0)
        Ha, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        attn = (2 * D * Ha * Dh + 2 * D * KH * Dh
                + (3 if cfg.mlp_gated else 2) * D * cfg.d_ff)
        attn_ops = 4 * Ha * Dh * batch * seq * (seq + 1) / 2
    return (6 * T * (cfg.n_layers * mamba + n_attn * attn
                     + cfg.vocab_size * D)
            + 3 * (cfg.n_layers * scan + n_attn * attn_ops))


def _step_readings(D, M, cfg, corpus, batch, seq, lr, total,
                   state_policy=""):
    """ms of three synchronised ``train_step``s after a warm-up, from
    fresh seed-0 weights and AdamW moments under ``state_policy``, the
    peak memory over them, and on a fourth step (CUDA events) the share
    of its time spent in ``ssd_bwd``."""
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.optim import adamw_init, cosine_schedule
    torch.cuda.empty_cache()
    params = M.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    opt = adamw_init(params, policy=state_policy)
    sched = cosine_schedule(lr, total, warmup=1)
    bs = corpus.device_batches(0, 5, batch, seq)
    bs = [{k: v[s].cuda() for k, v in bs.items()} for s in range(5)]
    D.train_step(params, opt, cfg, bs[0], sched(1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for b in bs[1:4]:
        t0 = time.perf_counter()
        D.train_step(params, opt, cfg, b, sched(2))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    spans, own = [], ssd_ops.ssd_bwd

    transient = []

    def timed_bwd(*a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev[0].record()
        out = own(*a, **k)
        ev[1].record()
        spans.append(ev)
        transient.append(torch.cuda.max_memory_allocated() - base)
        return out

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ssd_ops.ssd_bwd = timed_bwd
    try:
        ev[0].record()
        D.train_step(params, opt, cfg, bs[4], sched(2))
        ev[1].record()
        torch.cuda.synchronize()
    finally:
        ssd_ops.ssd_bwd = own
    del params, opt, bs
    torch.cuda.empty_cache()
    step_ev = ev[0].elapsed_time(ev[1])
    bwd = sum(a.elapsed_time(b) for a, b in spans)
    ms = sorted(step_ms)[len(step_ms) // 2]
    flops = _train_flops(M, cfg, batch, seq)
    return {"step_ms": step_ms, "ms_per_step": ms,
            "tokens_per_s": batch * seq / (ms / 1e3),
            "mfu": flops / (ms / 1e3) / PEAK_BF16,
            "model_tflop_per_step": flops / 1e12, "peak_mem_gb": peak,
            "events_step_ms": step_ev, "ssd_bwd_ms": bwd,
            "ssd_bwd_calls": len(spans), "ssd_bwd_share": bwd / step_ev,
            "ssd_bwd_transient_gb": max(transient, default=0) / 1e9}


def _train_family(D, M, cfg, corpus, steps, want, label):
    """``train_device`` (the main path, counts from 0) for ``steps`` steps
    of TRAIN_BATCH x TRAIN_SEQ tokens; checks finite, falling losses, the
    launches against ``want`` and every scan launch in the tc instance;
    then the first TRAIN_LOSS_STEPS losses of the plain path (no kernel
    launched) against the kernel path's."""
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    spec = D.DeviceSpec(0, cfg, 0, int(corpus.device_domain[0]))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    up = D.train_device(spec, corpus, steps=steps, batch=TRAIN_BATCH,
                        seq_len=TRAIN_SEQ, lr=TRAIN_LR, seed=0,
                        device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: v for k, v in _counts().items() if k in want}
    others = {k: v for k, v in _counts().items() if k not in want and v}
    by_inst = dict(ssd_ops.LAUNCHES_BY_INSTANCE)
    losses = up["losses"]
    del up
    print(f"{label}: {steps} steps in {wall:.2f}s, losses "
          f"{[round(x, 4) for x in losses]}, launches {got}, scan by "
          f"instance {by_inst}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses}")
    if got != want or others:
        fail(f"{label}: launches {got} (others {others}) != expected {want}")
    if by_inst["tc"] != want["ssd_scan"]:
        fail(f"{label}: scan launches by instance {by_inst}, not all tc")
    _all_wgmma(kd_ops, label)
    plain_spec = dataclasses.replace(spec, cfg=cfg.replace(use_kernels=False))
    plain, n_p = _launched(lambda: _first_losses(
        D, plain_spec, corpus, TRAIN_LOSS_STEPS, steps))
    d = max(abs(a - b) for a, b in zip(losses, plain))
    tol = TRAIN_LOSS_TOL[cfg.name]
    print(f"{label}: first {TRAIN_LOSS_STEPS} losses kernel "
          f"{losses[:TRAIN_LOSS_STEPS]} plain {plain} (max |d| {d})")
    if any(n_p.values()) or not d <= tol:
        fail(f"{label}: plain-path losses {plain} (launches {n_p}) differ "
             f"from the kernel path's by {d} > {tol}")
    return got, losses, wall, d


def _first_losses(D, spec, corpus, steps, total):
    """The first ``steps`` losses of a ``total``-step ``train_device`` run:
    the same seed-0 weights, batches and schedule."""
    params, opt = D._device_init(spec, 0, torch.device("cuda"))
    losses = D.train_round(spec, corpus, params, opt, start=0, steps=steps,
                           total_steps=total, batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, lr=TRAIN_LR,
                           warmup=max(total // 20, 1), device="cuda")
    out = [float(x) for x in losses.cpu()]
    del params, opt
    torch.cuda.empty_cache()
    return out


def phase_train_ssm():
    """``train_device`` on full-width, full-depth Mamba2-1.3B (bf16, remat,
    random weights from seed 0): 8 steps of 4 x 1024 tokens from the train
    cell's corpus, kernel 7 under autograd.  Checks as ``_train_family``,
    one block's gradients kernel vs plain in bf16 and f32 and ``ssd_bwd``
    against f64; reports ms a step, tokens/s, MFU, peak memory and the
    scan backward's share of a step."""
    from repro_torch.configs import get_config
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import device as D
    from repro_torch.models import model as M
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config("mamba2-1.3b", variant="full")
    if not (cfg.use_kernels and cfg.remat):
        fail("mamba2 config does not train through the kernels with remat")
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    chunks = TRAIN_SEQ // cfg.loss_chunk
    # each block and each loss chunk is rematerialised once (cfg.remat)
    want = {"ssd_scan": SSM_TRAIN_STEPS * cfg.n_layers * 2,
            "kd_loss": SSM_TRAIN_STEPS * chunks * 2}
    launches, losses, wall, loss_d = _train_family(
        D, M, cfg, corpus, SSM_TRAIN_STEPS, want, "train_ssm")
    params = M.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    checks = {}
    for dt in (torch.bfloat16, torch.float32):
        checks.update(_ssm_block_grad_check(cfg, params, dt))
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params
    res = {"arch": cfg.name, "steps": SSM_TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "losses": losses, "train_device_wall_s": wall,
           "launches": launches, "n_params": n_params,
           "first_losses_max_abs_diff": loss_d, **checks,
           **_step_readings(D, M, cfg, corpus, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_LR, SSM_TRAIN_STEPS)}
    print(f"train_ssm ({CARD}) " + json.dumps(res))
    return launches


def _hybrid_grad_check(M, cfg, params, batch, dtype):
    """Loss and every gradient of the 15-block Zamba2 on one batch, kernel
    path against plain path, in ``dtype``: the shared block's gradient
    sums its three applications (two groups and the tail), flash's
    backward at D 112.  The kernel run must launch flash, kernel 7 and
    kd_loss; the plain run nothing."""
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_paths
    name = str(dtype)[6:]
    c = cfg.replace(dtype=name)
    p = tree_map(lambda t: t.to(torch.float32 if t.dtype == torch.float32
                                else dtype), params)
    leaves = [t.requires_grad_(True) for t in tree_leaves(p)]
    out = {}
    for uk in (True, False):
        def run():
            loss, _ = M.loss_fn(p, c.replace(use_kernels=uk), batch)
            return loss.item(), torch.autograd.grad(loss, leaves)
        out[uk] = _launched(run)
    (lk, gk), n_k = out[True]
    (lp, gp), n_p = out[False]
    if not (n_k["flash_attention"] and n_k["ssd_scan"] and n_k["kd_loss"]) \
            or any(n_p.values()):
        fail(f"train_hybrid grads ({name}): kernel path launched {n_k}, "
             f"plain {n_p}")
    res = {q: _rel_l2(a, b)
           for (q, _), a, b in zip(tree_paths(p), gk, gp)}
    del p, leaves, gk, gp, out
    worst = max(res, key=res.get)
    shared = max(v for q, v in res.items() if q.startswith("shared_attn"))
    print(f"train_hybrid grads kernel vs plain ({name}, {CARD}): loss "
          f"{lk} / {lp}, " + json.dumps(res))
    if not abs(lk - lp) <= HYBRID_LOSS_TOL[name]:
        fail(f"train_hybrid ({name}): kernel-path loss {lk} differs from "
             f"the plain path's {lp} by more than {HYBRID_LOSS_TOL[name]}")
    if not res[worst] <= HYBRID_GRAD_TOL[name]:
        fail(f"train_hybrid ({name}): the {worst} gradient differs from the "
             f"plain path's by {res[worst]} (relative L2) > "
             f"{HYBRID_GRAD_TOL[name]}")
    return {f"{name}_loss_abs_err": abs(lk - lp),
            f"{name}_grad_worst_leaf": worst,
            f"{name}_grad_worst_rel_l2": res[worst],
            f"{name}_shared_attn_worst_rel_l2": shared}


def phase_train_hybrid():
    """``train_device`` on Zamba2-7B at full width, 15 of its 81 blocks
    (bf16, remat, random weights from seed 0): 4 steps of 4 x 1024 tokens.
    Checks as ``_train_family``, the loss and every gradient of the model
    kernel vs plain on a 1 x 1024 batch, and ``ssd_bwd`` against f64 at
    Zamba2's scan shape; reports ms a step, tokens/s, MFU, peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import device as D
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config("zamba2-7b", variant="full").replace(
        n_layers=HYBRID_TRAIN_LAYERS)
    period, n_groups, tail = M._hybrid_layout(cfg)
    if (period, n_groups, tail) != (6, 2, 3) or not (cfg.use_kernels
                                                     and cfg.remat):
        fail(f"zamba2 cut: {(period, n_groups, tail)}, kernels "
             f"{cfg.use_kernels}, remat {cfg.remat}")
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    chunks = TRAIN_SEQ // cfg.loss_chunk
    n_attn = n_groups + (1 if tail else 0)
    # a step: every block and shared-block application once forward; each
    # group recomputed (remat) short of its last Mamba-2 block, whose
    # input is all the group's backward keeps (torch.utils.checkpoint's
    # early stop), then each Mamba-2 block of a group or the tail
    # recomputed in its own backward
    want = {"ssd_scan": HYBRID_TRAIN_STEPS * (
                cfg.n_layers + n_groups * (2 * period - 1) + tail),
            "flash_attention": HYBRID_TRAIN_STEPS * (n_attn + n_groups),
            "kd_loss": HYBRID_TRAIN_STEPS * chunks * 2}
    launches, losses, wall, loss_d = _train_family(
        D, M, cfg, corpus, HYBRID_TRAIN_STEPS, want, "train_hybrid")
    params = M.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    batch = {k: v[:1].cuda() for k, v in corpus.device_batch(
        0, TRAIN_BATCH, TRAIN_SEQ, step=0).items()}
    check = {}
    for dt in (torch.float32, torch.bfloat16):
        check.update(_hybrid_grad_check(M, cfg, params, batch, dt))
    # ssd_bwd against f64 on the scan inputs of a forward's first block
    seen = []
    kernel, tap = _scan_tap(ssd_ops, seen)
    ssd_ops.ssd = tap
    try:
        with torch.no_grad():
            M.loss_fn(params, cfg, batch)
    finally:
        ssd_ops.ssd = kernel
    check["ssd_bwd_vs_f64"] = _ssd_bwd_vs_f64(ssd_ops, *seen[0],
                                               "train_hybrid")
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, seen
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "steps": HYBRID_TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "losses": losses, "train_device_wall_s": wall,
           "launches": launches, "n_params": n_params,
           "first_losses_max_abs_diff": loss_d, **check,
           **_step_readings(D, M, cfg, corpus, TRAIN_BATCH, TRAIN_SEQ,
                            TRAIN_LR, HYBRID_TRAIN_STEPS)}
    print(f"train_hybrid ({CARD}) " + json.dumps(res))
    return launches


# ---------------------------------------------------------------------------
# phase 6d: train DeepSeek-V3's MLA and MTP loss at full width
# ---------------------------------------------------------------------------

# every matrix at full width, 4 layers (3 dense + 1 MoE) and 32 of the 256
# experts (top-8 kept), so that parameters, gradients and bf16 AdamW
# moments of 5.93 B parameters fit the card's 80 GB
MLA_TRAIN_LAYERS, MLA_TRAIN_EXPERTS = 4, 32
MLA_TRAIN_STEPS, MLA_TRAIN_BATCH = 4, 2
# AdamW's first steps move every weight by about lr, which at fan-in 7168
# changes a layer's output by about lr x 7168 of its scale: on an H100
# the 4-step losses rose at lr 1e-3 (15.95, 15.91, 16.03, 16.92) and at
# the published peak 2.2e-4 (arXiv:2412.19437; ..., 15.94, 16.01), and
# fell at 1e-4 over 6 steps and at 3e-5 over 4 (..., 15.905, 15.901)
MLA_TRAIN_LR = 3e-5


def _mla_train_flops(cfg, batch, seq):
    """PERF.md §2's MFU numerator for an MLA model with an MTP head: 6 x
    the matmul parameters a token passes (the MoE's active ones, the MTP
    projection and block, the head twice: the main CE's pass and the
    MTP's) x tokens, plus MLA's causal attention products (q·k over nope +
    rope, p·v over v_head_dim) in every layer and the MTP block, each
    forward and twice in the backward."""
    D, H, T = cfg.d_model, cfg.n_heads, batch * seq
    r, pr = cfg.kv_lora_rank, cfg.rope_head_dim
    nd, vd, ql = cfg.nope_head_dim, cfg.v_head_dim, cfg.q_lora_rank
    q = D * ql + ql * H * (nd + pr) if ql else D * H * (nd + pr)
    attn = q + D * (r + pr) + H * r * (nd + vd) + H * vd * D
    dense = 3 * D * cfg.d_ff
    routed = D * cfg.n_experts + 3 * D * cfg.moe_d_ff * (
        cfg.top_k + cfg.n_shared_experts)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    per_token = (cfg.n_layers * attn + cfg.first_dense_layers * dense
                 + n_moe * routed + 2 * D * D + attn + dense
                 + 2 * D * cfg.vocab_size)
    attn_ops = 2 * H * (nd + pr + vd) * batch * seq * (seq + 1) / 2
    return 6 * T * per_token + 3 * (cfg.n_layers + 1) * attn_ops


def phase_train_mla():
    """``train_device`` on DeepSeek-V3 cut to MLA_TRAIN_LAYERS layers and
    MLA_TRAIN_EXPERTS experts at full width (bf16, remat, bf16 AdamW
    moments, random weights from seed 0): MLA_TRAIN_STEPS steps of
    MLA_TRAIN_BATCH x 1024 tokens, the loss with its MTP term.  Checks
    finite, falling losses, the launches (kd_loss twice a loss chunk of
    the main CE and of the MTP's, all wgmma; the MoE layer as in tune, its
    products on tensor cores, the dispatch in vec; no flash or paged
    attention), ``mtp_loss`` in the metrics and ``mtp_chain_loss`` at
    depth 1 equal to ``_mtp_loss``, the kernel path's loss and gradients
    against its plain version in bf16 and f32; reports ms a step,
    tokens/s, MFU and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import device as D
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.models import model as M
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = get_config("deepseek-v3-671b", variant="full").replace(
        n_layers=MLA_TRAIN_LAYERS, n_experts=MLA_TRAIN_EXPERTS)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    if not (cfg.use_kernels and cfg.remat and cfg.n_mtp and n_moe == 1
            and cfg.top_k == V3_K):
        fail(f"deepseek-v3 train cut: {cfg}")
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    chunks = TRAIN_SEQ // cfg.loss_chunk
    n = MLA_TRAIN_STEPS
    # a step, each group and loss chunk rematerialised: kd_loss twice a
    # loss chunk of the main CE and of the MTP's; the MoE layer as in tune
    want = {**dict.fromkeys(_counts(), 0), "kd_loss": 2 * 2 * chunks * n,
            "gather_scatter_add": 6 * n_moe * n,
            "grouped_ffn": 2 * n_moe * n, "grouped_matmul": 7 * n_moe * n,
            "split_f32": 3 * n_moe * n}
    spec = D.DeviceSpec(0, cfg, 0, int(corpus.device_domain[0]))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    up = D.train_device(spec, corpus, steps=n, batch=MLA_TRAIN_BATCH,
                        seq_len=TRAIN_SEQ, lr=MLA_TRAIN_LR, seed=0,
                        state_policy="bf16", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = up["losses"]
    del up
    torch.cuda.empty_cache()
    print(f"train_mla: {n} steps in {wall:.2f}s, losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train_mla: non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train_mla: loss did not fall: {losses}")
    if launches != want:
        fail(f"train_mla: launches {launches} != expected {want}")
    _all_wgmma(kd_ops, "train_mla")
    _gmm_on_tensor_cores(mg_ops, n_moe * n, "train_mla")
    _gsa_all_vec(md_ops, "train_mla")

    params = M.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = {k: v[:1].cuda() for k, v in corpus.device_batch(
        0, MLA_TRAIN_BATCH, TRAIN_SEQ, step=0).items()}
    with torch.no_grad():
        _, metrics = M.loss_fn(params, cfg, batch)
        h = M.backbone(params, cfg, batch)[0]
        mtp = M._mtp_loss(params, cfg, h, batch).item()
        chain = M.mtp_chain_loss(params, cfg, batch, depth=1).item()
    mtp_check = {"mtp_loss": metrics["mtp_loss"].item(), "head_mtp": mtp,
                 "chain_depth_1": chain, "ce_loss": metrics["ce_loss"].item()}
    print(f"train_mla mtp ({CARD}) " + json.dumps(mtp_check))
    if not (math.isfinite(mtp) and mtp_check["mtp_loss"] == mtp
            and abs(chain - mtp) <= 1e-6 * abs(mtp)):
        fail(f"train_mla: mtp_loss {mtp_check}")
    del h, metrics
    checks = {"bfloat16": _tune_grad_check(
        M, cfg, params, batch, TUNE_BF16_LOSS_TOL, TUNE_BF16_GRAD_TOL,
        layer=0, attn_leaf="wq_b", label="train_mla")}
    p32 = tree_map(lambda t: t.float(), params)
    del params
    torch.cuda.empty_cache()
    checks["float32"] = _tune_grad_check(
        M, cfg.replace(dtype="float32"), p32, batch, TUNE_LOSS_TOL,
        TUNE_GRAD_TOL, layer=0, attn_leaf="wq_b", label="train_mla")
    del p32
    torch.cuda.empty_cache()
    res = {"arch": cfg.name, "layers": cfg.n_layers,
           "experts": cfg.n_experts, "steps": n, "batch": MLA_TRAIN_BATCH,
           "seq": TRAIN_SEQ, "moments": "bf16", "n_params": n_params,
           "losses": losses, "train_device_wall_s": wall,
           "train_device_peak_gb": peak, "launches": launches,
           "mtp": mtp_check, "grad_checks": checks,
           **_step_readings(D, M, cfg, corpus, MLA_TRAIN_BATCH, TRAIN_SEQ,
                            MLA_TRAIN_LR, n, state_policy="bf16")}
    print(f"train_mla ({CARD}) " + json.dumps(res))
    return launches


# ---------------------------------------------------------------------------
# phase 6e: train Whisper-small at full width and depth under remat "dots"
# ---------------------------------------------------------------------------

ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 6, 4, 448
ENCDEC_TRAIN_LR = 1e-3
# the steps take the launcher's batches of steps 0 and 1 in turn: a
# random model's loss on fresh corpus batches moves by less than the
# spread between batches in 6 steps (about 0.05 of 11.0 on a 1+1-layer
# cut on the CPU), while each batch's own loss falls when it comes back
ENCDEC_TRAIN_BATCHES = 2
# kernel path against plain path on one batch with stub frames, bf16: the
# loss to this absolute limit, each gradient leaf to this relative L2.
# Readings on an H100 (700 W): loss |d| 5.7e-6 (of 11.62); worst leaf
# dec_blocks/xattn/wk at 0.0228 (bf16 activations rounded at other
# points through 24 layers); the limits about 3.5x and 2.2x those.
ENCDEC_LOSS_TOL = 2e-5
ENCDEC_GRAD_TOL = 0.05
# "dots" against full remat and no remat on that batch (kernel path,
# bf16): the same arithmetic, so bit-equality is expected (and was read:
# every leaf equal); the embedding's backward adds rows with atomics in
# an order that may change from run to run, so each leaf is held to this
# relative L2 and the loss to 0
ENCDEC_REMAT_GRAD_TOL = 1e-3


class _CountMM(TorchDispatchMode):
    """Counts the products without batch dims (``aten.mm``, ``aten.addmm``)
    that reach the dispatcher while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _encdec_train_flops(cfg, batch, seq):
    """Model FLOPs of one training step: 6 x the matmul parameters each
    token passes (the encoder's 1500 frames through its blocks and the
    decoder's cross K/V projections; the decoder's tokens through its
    blocks, cross queries and output, and the tied head) x tokens, plus
    the attention's products (bidirectional over the frames, causal over
    the tokens, tokens over frames), each forward and twice in the
    backward."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Ta, L, E = cfg.frontend_tokens, cfg.n_layers, cfg.n_enc_layers
    HD = cfg.n_heads * cfg.resolved_head_dim
    te, td = batch * Ta, batch * seq
    enc = E * (4 * D * HD + 2 * D * F) + L * 2 * D * HD
    dec = L * (4 * D * HD + 2 * D * F + 2 * D * HD) + V * D
    attn = 4 * HD * batch * (E * Ta * Ta + L * seq * (seq + 1) / 2
                             + L * seq * Ta)
    return 6 * (enc * te + dec * td) + 3 * attn


def _encdec_grads(M, cfg, params, batch):
    """(loss, {path: gradient in f32}, mm calls of the backward, peak GB) of
    one ``loss_fn`` and its gradient."""
    from repro_torch import convert
    leaves = convert.flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = M.loss_fn(params, cfg, batch)
    with _CountMM() as mm:
        gs = torch.autograd.grad(loss, list(leaves.values()))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for t in leaves.values():
        t.requires_grad_(False)
    return (loss.item(), {k: g.float() for k, g in zip(leaves, gs)}, mm.n,
            peak)


def _worst_rel(ga, gb):
    """(leaf, relative L2 distance) of the leaf where two gradient dicts
    differ most."""
    rel = {k: ((ga[k] - gb[k]).norm() / gb[k].norm().clamp_min(1e-30)).item()
           for k in gb}
    k = max(rel, key=rel.get)
    return k, rel[k]


def phase_train_encdec():
    """Whisper-small at full width and depth (bf16, random weights from
    seed 0) trained ENCDEC_TRAIN_STEPS steps of 4 x 448 tokens with zero
    frames (``launch/train.py::make_batch``, ENCDEC_TRAIN_BATCHES batches
    in turn) under ``remat_policy="dots"`` through
    ``federated.device.train_step``: finite losses, each batch's falling,
    launches (flash twice an encoder layer bidirectional and twice a
    decoder layer a step, forward and remat; kd_loss twice a step, all in
    the general instance).  Then on one batch with stub frames: the
    kernel path's loss and every gradient against the plain path's, and
    ``dots`` against
    full remat and no remat (the same loss and gradients; each one's
    peak; the products the backward recomputes: fewer under ``dots``
    than under full remat, none without remat)."""
    from repro_torch.configs import get_config
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import device as D
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.launch.train import make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config("whisper-small", variant="full").replace(
        remat_policy="dots")
    if not (cfg.use_kernels and cfg.remat and cfg.dtype == "bfloat16"):
        fail(f"whisper-small config: {cfg}")
    steps, B, S = ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    torch.cuda.empty_cache()
    params = M.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in tree_leaves(params))
    opt = adamw_init(params)
    sched = cosine_schedule(ENCDEC_TRAIN_LR, steps, warmup=1)
    data = [make_batch(cfg, corpus, s, B, S, "cuda")
            for s in range(ENCDEC_TRAIN_BATCHES)]
    batches = [data[s % ENCDEC_TRAIN_BATCHES] for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, step_ms = [], []
    for s, b in enumerate(batches):
        t0 = time.perf_counter()
        loss, _, _ = D.train_step(params, opt, cfg, b, sched(s),
                                  weight_decay=0.01)
        losses.append(loss.item())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = _counts()
    L, E = cfg.n_layers, cfg.n_enc_layers
    want = {**dict.fromkeys(launches, 0),
            "flash_attention": steps * (E + L) * 2,
            "flash_attention_bidir": steps * E * 2,
            "kd_loss": steps * -(-S // min(cfg.loss_chunk, S)) * 2}
    print(f"train_encdec: {steps} steps, losses "
          f"{[round(x, 4) for x in losses]}, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    n = ENCDEC_TRAIN_BATCHES
    if not all(math.isfinite(x) for x in losses) or not all(
            losses[-n + i] < losses[i] for i in range(n)):
        fail(f"train_encdec: losses {losses}: each batch's must fall")
    if launches != want:
        fail(f"train_encdec: launches {launches} != expected {want}")
    by = dict(kd_ops.LAUNCHES_BY_INSTANCE)
    if by["general"] != launches["kd_loss"] or sum(by.values()) != by[
            "general"]:
        fail(f"train_encdec: kd_loss launches by instance {by}: V 51,865 "
             f"takes the general instance")
    del opt, batches, data
    torch.cuda.empty_cache()

    # one batch with stub frames: kernel vs plain, and the three remats
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: v.cuda() for k, v in corpus.mixed_eval_batch(
        B, S, seed_salt=steps).items()}
    batch["frames"] = (torch.randn((B, cfg.frontend_tokens, cfg.d_model),
                                   generator=gen, device="cuda")
                       * 0.05).bfloat16()
    runs = {}
    for name, c in (("dots", cfg),
                    ("full", cfg.replace(remat_policy="nothing")),
                    ("off", cfg.replace(remat=False)),
                    ("plain", cfg.replace(use_kernels=False))):
        runs[name] = _encdec_grads(M, c, params, batch)
    del params
    torch.cuda.empty_cache()
    (ld, gd, md, pd), (lf, gf, mf, pf), (lo, go, mo, po), (lp, gp, _, _) = (
        runs[k] for k in ("dots", "full", "off", "plain"))
    kp_leaf, kp_rel = _worst_rel(gd, gp)
    rf_leaf, rf_rel = _worst_rel(gd, gf)
    ro_leaf, ro_rel = _worst_rel(gd, go)
    res = {"arch": cfg.name, "n_params": n_params, "steps": steps,
           "batch": B, "seq": S, "frames": cfg.frontend_tokens,
           "losses": losses, "step_ms": step_ms,
           "ms_per_step": sorted(step_ms[1:])[len(step_ms[1:]) // 2],
           "peak_mem_gb": peak, "launches": {k: v for k, v in
                                             launches.items() if v},
           "loss_kernel": ld, "loss_plain": lp,
           "loss_abs_err": abs(ld - lp),
           "grad_worst_rel": kp_rel, "grad_worst_leaf": kp_leaf,
           "remat_loss": {"dots": ld, "full": lf, "off": lo},
           "dots_vs_full_worst_rel": rf_rel, "dots_vs_full_leaf": rf_leaf,
           "dots_vs_off_worst_rel": ro_rel, "dots_vs_off_leaf": ro_leaf,
           "dots_bit_equal_full": all(torch.equal(gd[k], gf[k]) for k in gd),
           "dots_bit_equal_off": all(torch.equal(gd[k], go[k]) for k in gd),
           "peak_gb": {"dots": pd, "full": pf, "off": po},
           "backward_mm": {"dots": md, "full": mf, "off": mo},
           "recomputed_mm": {"dots": md - mo, "full": mf - mo, "off": 0}}
    ms = res["ms_per_step"]
    res["tokens_per_s"] = B * S / (ms / 1e3)
    res["mfu"] = _encdec_train_flops(cfg, B, S) / (ms / 1e3) / PEAK_BF16
    print(f"train_encdec ({CARD}) " + json.dumps(res))
    if not res["loss_abs_err"] <= ENCDEC_LOSS_TOL or \
            not kp_rel <= ENCDEC_GRAD_TOL:
        fail(f"train_encdec: kernel vs plain loss {res['loss_abs_err']}, "
             f"gradient {kp_leaf} {kp_rel} past {ENCDEC_LOSS_TOL} / "
             f"{ENCDEC_GRAD_TOL}")
    if not (ld == lf == lo and rf_rel <= ENCDEC_REMAT_GRAD_TOL
            and ro_rel <= ENCDEC_REMAT_GRAD_TOL):
        fail(f"train_encdec: dots vs full / no remat: losses {ld} {lf} "
             f"{lo}, gradients {rf_leaf} {rf_rel}, {ro_leaf} {ro_rel} (limit "
             f"{ENCDEC_REMAT_GRAD_TOL})")
    if not 0 < md - mo < mf - mo:
        fail(f"train_encdec: backward products {res['backward_mm']}: dots "
             f"must recompute fewer than full remat, and some")
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


def _tune_grad_check(M, cfg, params, batch, loss_tol, grad_tol, *,
                     layer=TUNE_CHECK_LAYER, attn_leaf="wq", label="tune"):
    """Loss and the gradients of ``lm_head``, MoE group ``layer``'s
    router, attention ``attn_leaf`` and routed ``wi_gate``: the kernel
    path against its plain version (held to ``loss_tol`` absolute and
    ``grad_tol`` relative L2) and against the dropless plain path
    (reported).  ``params`` in ``cfg.dtype``."""
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.kernels.moe_gemm import ref as mg_ref
    from repro_torch.models import moe
    from repro_torch.utils.pytree import tree_leaves
    g = layer
    sub = params["blocks"]["sub0"]
    leaves = {"lm_head": params["lm_head"], "router": sub["moe"]["router"],
              attn_leaf: sub["attn"][attn_leaf],
              "wi_gate": sub["moe"]["wi_gate"]}
    for t in tree_leaves(params):
        t.requires_grad_(False)
    for t in leaves.values():
        t.requires_grad_(True)

    def run(use_kernels, plain_moe, tap):
        kernel_moe_ffn = mg_ops.moe_ffn
        n0 = md_ops.LAUNCHES + sum(mg_ops.LAUNCHES.values())
        if plain_moe:
            mg_ops.moe_ffn = mg_ref.moe_ffn_capacity_ref
        try:
            with tap:
                loss, _ = M.loss_fn(
                    params, cfg.replace(use_kernels=use_kernels), batch)
                gs = torch.autograd.grad(loss, list(leaves.values()))
        finally:
            mg_ops.moe_ffn = kernel_moe_ffn
        moe_launches = md_ops.LAUNCHES + sum(mg_ops.LAUNCHES.values()) - n0
        grads = {k: (gr if k == "lm_head" else gr[g]).float()
                 for k, gr in zip(leaves, gs)}
        return loss.item(), grads, moe_launches

    rec = _RouteTap(moe, ids_only=True)
    lk, gk, nk = run(True, False, rec)
    rpl = _RouteTap(moe, ids_only=True, replay=rec.record)
    lc, gc, nc = run(True, True, rpl)
    lp, gp, _ = run(False, False, _RouteTap(moe, ids_only=True))
    choices, replaced = rec.record, rpl.replaced
    if len(replaced) != len(choices):
        fail(f"tune check: {len(choices)} routing calls in the kernel run, "
             f"{len(replaced)} replayed")
    if nk <= 0 or nc != 0:
        fail(f"{label} check: {nk} MoE kernel launches on the kernel path, "
             f"{nc} on its plain version")

    def cmp(ga, gb, la, lb, tag):
        res = {f"loss_{tag}": lb, f"loss_abs_err_{tag}": abs(la - lb)}
        for k in leaves:
            res[f"{k}_rel_err_{tag}"] = (
                (ga[k] - gb[k]).norm() / gb[k].norm()).item()
        return res

    # the first routing calls are the forward's, one per MoE layer
    n_moe = cfg.n_layers - cfg.first_dense_layers
    drops = [_dropped(i, cfg.n_experts) for i in choices[:n_moe]]
    res = {"dtype": cfg.dtype, "loss_kernel": lk,
           "kernel_path_dropped_per_layer": drops,
           "plain_choices_replaced_per_call": replaced,
           "assignments_per_layer": batch["tokens"].numel() * cfg.top_k,
           **cmp(gk, gc, lk, lc, "vs_plain_capacity"),
           **cmp(gk, gp, lk, lp, "vs_plain_dropless")}
    print(f"{label} kernel vs plain " + json.dumps(res))
    err = res["loss_abs_err_vs_plain_capacity"]
    if not math.isfinite(err) or err > loss_tol:
        fail(f"{label} ({cfg.dtype}): kernel-path loss differs from its "
             f"plain version by {err} > {loss_tol}")
    for k in leaves:
        e = res[f"{k}_rel_err_vs_plain_capacity"]
        if not e <= grad_tol:
            fail(f"{label} ({cfg.dtype}): kernel-path {k} gradient differs "
                 f"from its plain version by {e} (relative L2) > {grad_tol}")
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
    marks, step_choices = [], []
    tap = _RouteTap(moe, ids_only=True)

    def on_step(s, loss):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        step_choices.append(tap.record[:])
        tap.record.clear()

    srv = S.DeepFusionServer(scfg, corpus, [], device="cuda",
                             on_step=on_step)
    # the main path, counts from 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    with tap:
        params, losses = srv.merge_and_tune(bases)
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


# ---------------------------------------------------------------------------
# phase 8: Phases I and II, TinyLlama-1.1B teachers into the Qwen1.5-MoE base
# ---------------------------------------------------------------------------

DISTILL_STEPS, DISTILL_BATCH, DISTILL_SEQ, DISTILL_LR = 6, 4, 1024, 1e-3
DISTILL_J, DISTILL_VAA_DIM, DISTILL_VAA_HEADS, DISTILL_P_Q = 4, 128, 4, 64
DISTILL_TAU = 2.0
# the leaves whose on-card bf16 proxy average is held bit for bit to the
# CPU's f32 sum, divided and cast
PROXY_LEAVES = ("embed", "lm_head", "final_norm/scale",
                "blocks/sub0/attn/wq", "blocks/sub0/mlp/wi_gate")
# The kernel path's distill_loss and the gradient of every student and
# VAA leaf (relative L2, the worst leaf of each), on one 1 x 1024 batch,
# the distilled student with the VAA module as Phase II draws it, against
# the plain path (use_kernels=False: dense attention and logits) with
# the teacher's outputs shared.  In bf16 the plain path rounds its
# logits to bf16 and both round activations at other points through 12
# layers; the VAA's f32 gradients see the student's stages move with
# them.  Readings on an H100 (700 W) on this batch and two others (seed
# salts 77, 78, 80), bf16: loss |d| 1.30e-4, 6.98e-4, 1.91e-4; student
# 0.0108, 0.0090, 0.0100; VAA 0.0052, 0.0031, 0.0080; f32: loss |d| 0,
# student 3.0e-6, 1.7e-6, 2.8e-6; VAA 3.8e-6, 1.4e-6, 8.8e-6.  (Two
# optimizer steps past its init the VAA read 0.154 in bf16: its
# gradients shrink and their relative error grows, so the check holds
# the init.)  Limits about 3x the worst reading; the f32 loss about
# three f32 ulps of ~36.
DISTILL_LOSS_TOL = {"float32": 1e-5, "bfloat16": 2.1e-3}
DISTILL_STUDENT_TOL = {"float32": 1e-5, "bfloat16": 0.033}
DISTILL_VAA_TOL = {"float32": 2.7e-5, "bfloat16": 0.024}
# each planted fault must move the check past a limit, the loss's or a
# gradient's, by at least this factor
DISTILL_FAULT_MARGIN = 3.0
# A random teacher's logits are ~N(0, 1): its distribution over 151,936
# tokens is near uniform, its KL to any student hardly depends on the
# token (a rolled teacher moves the mean KL by ~1e-4) and the KL gradient
# is ~1e-3 of the CE gradient.  The check sharpens the teacher (final
# norm scale x8, exact in bf16; logits ~N(0, 64)) so that KL reaches the
# loss and the gradients, as a trained teacher's confident predictions
# would.
TEACHER_SHARPEN = 8.0


def _check_proxy_average(uploads):
    """``build_proxies`` on a cluster of both uploads: the bf16 average on
    the card equals, bit for bit, the CPU's f32 sum divided and cast."""
    from repro_torch.convert import flatten
    from repro_torch.core import clustering, proxy
    res = clustering.ClusterResult(labels=np.zeros(2, np.int32),
                                centroids=np.zeros((1, 32), np.float32),
                                similarity=np.ones((2, 2), np.float32),
                                members=[[0, 1]])
    (avg,) = proxy.build_proxies([u["params"] for u in uploads], res, [0, 0])
    got = flatten(avg["params"])
    ups = [flatten(u["params"]) for u in uploads]
    for name in PROXY_LEAVES:
        a, b = (u[name].cpu() for u in ups)
        want = ((a.float() + b.float()) / 2).to(a.dtype)
        if got[name].dtype != torch.bfloat16 or \
                not torch.equal(got[name].cpu(), want):
            fail(f"proxy leaf {name}: the card's average is not the CPU's")
    return list(PROXY_LEAVES)


def _distill_grad_check(D, kd_ops, s_cfg, t_cfg, trainable, t_params, batch,
                        kw):
    """distill_loss and the gradient of every student and VAA leaf, kernel
    path against the plain path, the teacher's outputs computed once and
    shared; then the same with two planted faults on the kernel path: the
    teacher's hidden states rolled by one token (seen through KL) and its
    stage list reversed (seen through FM), each of which must break a
    limit."""
    from repro_torch.utils.pytree import tree_leaves, tree_paths
    dtype = s_cfg.dtype
    tol = {"loss": DISTILL_LOSS_TOL[dtype],
           "student": DISTILL_STUDENT_TOL[dtype],
           "vaa": DISTILL_VAA_TOL[dtype]}
    t_out = D.teacher_forward(t_params, t_cfg, batch, n_stages=kw["n_stages"])
    runs = {"path": t_out,
            "fault_teacher_h_rolled": dict(
                t_out, h=torch.roll(t_out["h"], 1, dims=1)),
            "fault_teacher_stages_reversed": dict(
                t_out, stages=t_out["stages"][::-1])}
    paths = [p for p, _ in tree_paths(trainable)]
    leaves = [t.requires_grad_(True) for t in tree_leaves(trainable)]

    def run(use_kernels, out):
        n0 = kd_ops.LAUNCHES_BY_MODE["kd"]
        loss, m = D.distill_loss(trainable, s_cfg.replace(
            use_kernels=use_kernels), t_params, t_cfg, batch, out, **kw)
        gs = torch.autograd.grad(loss, leaves)
        return (loss.item(), {k: v.item() for k, v in m.items()},
                [g.float() for g in gs], kd_ops.LAUNCHES_BY_MODE["kd"] - n0)

    lp, mp, gp, n_plain = run(False, t_out)
    if n_plain:
        fail(f"distill check ({dtype}): {n_plain} kd_loss launches on the "
             f"plain path")
    res = {"dtype": dtype, "loss_plain": lp, "metrics_plain": mp,
           "tol": tol}
    for name, out in runs.items():
        lk, mk, gk, n_kd = run(True, out)
        errs = {p: ((a - b).norm() / b.norm()).item()
                for p, a, b in zip(paths, gk, gp)}
        del gk
        err = {"loss": abs(lk - lp)}
        for part in ("student", "vaa"):
            worst = max((p for p in errs if p.startswith(part)),
                        key=errs.get)
            err[part] = errs[worst]
            res.setdefault(name, {})[f"worst_{part}_leaf"] = worst
        res[name].update(
            loss_kernel=lk, loss_abs_err=err["loss"],
            metrics_abs_err={k: abs(mk[k] - mp[k]) for k in mk},
            student_grad_rel_err=err["student"],
            vaa_grad_rel_err=err["vaa"], kd_launches=n_kd,
            over_limit={k: err[k] / tol[k] for k in tol})
    print("distill kernel vs plain " + json.dumps(res))
    for k, over in res["path"]["over_limit"].items():
        if not over <= 1.0:
            fail(f"distill ({dtype}): the kernel path's {k} "
                 f"{'loss' if k == 'loss' else 'gradients'} differ from "
                 f"the plain path's by {over:.3g}x the limit {tol[k]}")
    for name in runs:
        if name.startswith("fault") and not max(
                res[name]["over_limit"].values()) >= DISTILL_FAULT_MARGIN:
            fail(f"distill ({dtype}): the planted {name[6:]} moves the check "
                 f"only {max(res[name]['over_limit'].values()):.3g}x a "
                 f"limit")
    for t in leaves:
        t.requires_grad_(False)
    return res


def phase_distill():
    """Phase I (``cluster``, ``build_proxies``) and Phase II
    (``distill_proxy``) at full width: two random TinyLlama-1.1B uploads
    (22 layers, vocab widened to the federation's 151936) distilled into
    the dense base of Qwen1.5-MoE-A2.7B (12 of 24 layers) for 6 steps of
    4 x 1024 tokens, lr 1e-3, J 4, VAA d 128, 4 heads, P_q 64, τ 2."""
    from repro_torch.configs import get_config
    from repro_torch.core import distill, merge
    from repro_torch.core import vaa as vaa_mod
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import device as Dv
    from repro_torch.federated import server as S
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.utils.pytree import tree_leaves, tree_map

    moe_cfg = get_config("qwen2-moe-a2.7b", variant="full").replace(
        n_layers=TUNE_LAYERS)
    s_cfg = merge.base_config_of(moe_cfg)
    t_own = get_config("tinyllama-1.1b", variant="full")
    t_cfg = t_own.replace(vocab_size=s_cfg.vocab_size)
    print(f"distill: teacher {t_cfg.name} at full width and depth on the "
          f"federation's vocabulary {t_cfg.vocab_size} (its own: "
          f"{t_own.vocab_size}); student {s_cfg.name}, {s_cfg.n_layers} of "
          f"24 layers, d_ff {s_cfg.d_ff}")
    if not (s_cfg.use_kernels and s_cfg.remat and t_cfg.use_kernels):
        fail("configs do not distill through the kernels with remat")
    torch.cuda.empty_cache()
    corpus = FederatedCorpus.build(seed=0, n_devices=2, n_domains=2,
                                   vocab=s_cfg.vocab_size)
    t0 = time.perf_counter()
    uploads = [{"params": M.init_params(t_cfg, generator=torch.Generator(
                    device="cuda").manual_seed(200 + i)),
                "embedding": corpus.device_embedding(i),
                "upload_bytes": Dv.device_upload_bytes(t_cfg),
                "arch_id": 0, "device_id": i} for i in range(2)]
    scfg = S.ServerConfig(moe_cfg, distill_steps=DISTILL_STEPS,
                          distill_batch=DISTILL_BATCH, distill_lr=DISTILL_LR,
                          seq_len=DISTILL_SEQ, temperature=DISTILL_TAU,
                          n_stages=DISTILL_J, vaa_dim=DISTILL_VAA_DIM,
                          vaa_heads=DISTILL_VAA_HEADS, p_q=DISTILL_P_Q,
                          seed=0)
    marks = []

    def on_step(s, loss):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    srv = S.DeepFusionServer(scfg, corpus, [t_cfg], device="cuda",
                             on_step=on_step)
    # Phase I: K = 60 experts, N = 2 uploads, so each upload is its own
    # cluster and proxy; then one cluster of both, averaged on the card
    proxies, result = srv.cluster(uploads)
    if srv.report["n_clusters"] != 2 or \
            {id(p["params"]) for p in proxies} != \
            {id(u["params"]) for u in uploads}:
        fail(f"Phase I: {srv.report['n_clusters']} proxies of 2 uploads, "
             f"not each upload its own")
    proxy_leaves = _check_proxy_average(uploads)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"distill: Phase I, K {moe_cfg.n_experts} > N 2 uploads: "
          f"{srv.report['n_clusters']} proxies, one upload each; a cluster "
          f"of both averaged on the card, leaves {proxy_leaves} equal to "
          f"the CPU's f32 sum, divided and cast")

    # the main path, counts from 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    marks.append(t0)
    student, losses = srv.distill_proxy(proxies[0], s_cfg, seed_offset=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"flash_attention": fa_ops.LAUNCHES,
                "kd_loss_kd": kd_ops.LAUNCHES_BY_MODE["kd"],
                "kd_loss_ce": kd_ops.LAUNCHES_BY_MODE["ce"]}
    chunks = DISTILL_SEQ // s_cfg.loss_chunk
    # per step: the teacher's layers once (no grad), the student's twice
    # (remat recomputes each group); kd_loss twice per loss chunk
    want = {"flash_attention": DISTILL_STEPS * (t_cfg.n_layers
                                                + 2 * s_cfg.n_layers),
            "kd_loss_kd": DISTILL_STEPS * chunks * 2, "kd_loss_ce": 0}
    print(f"distill: {DISTILL_STEPS} steps in {wall:.2f}s, losses "
          f"{[round(x, 4) for x in losses]}, launches {launches}")
    if launches != want:
        fail(f"distill launches {launches} != expected {want}")
    _all_wgmma(kd_ops, "distill")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite distillation loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"distillation loss did not fall: {losses}")
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    del proxies, result
    kw = dict(alpha=scfg.alpha, beta=scfg.beta, temperature=DISTILL_TAU,
              n_stages=DISTILL_J, vaa_heads=DISTILL_VAA_HEADS,
              p_q=DISTILL_P_Q)
    teacher = uploads[0]["params"]
    del uploads
    # the VAA module as Phase II draws it (its gradients are largest
    # there; a few steps on, they shrink and their relative error grows)
    vaa = vaa_mod.init_vaa(torch.Generator(device="cuda").manual_seed(202),
                           n_stages=DISTILL_J, d_student=s_cfg.d_model,
                           d_teacher=t_cfg.d_model, d=DISTILL_VAA_DIM,
                           p_q=DISTILL_P_Q)
    trainable = {"student": student, "vaa": vaa}
    del student, vaa

    # kernel path against plain path on one 1 x 1024 batch: the distilled
    # student in bf16 as it trains, then everything in f32; the teacher
    # sharpened (TEACHER_SHARPEN)
    batch = {k: v.cuda() for k, v in corpus.mixed_eval_batch(
        1, DISTILL_SEQ, seed_salt=77).items()}
    sharp = dict(teacher, final_norm=tree_map(
        lambda t: t * TEACHER_SHARPEN, teacher["final_norm"]))
    for d in (kd_ops.LAUNCHES_BY_INSTANCE, kd_ops.LAUNCHES_BY_MODE):
        d.update(dict.fromkeys(d, 0))
    kd_ops.LAUNCHES = 0
    check_bf16 = _distill_grad_check(distill, kd_ops, s_cfg, t_cfg,
                                     trainable, sharp, batch, kw)
    _all_wgmma(kd_ops, "distill bf16 check")
    check = _distill_grad_check(
        distill, kd_ops, s_cfg.replace(dtype="float32"),
        t_cfg.replace(dtype="float32"),
        tree_map(lambda t: t.detach().float(), trainable),
        tree_map(lambda t: t.detach().float(), sharp), batch, kw)
    del sharp
    torch.cuda.empty_cache()
    per_check = 3 * chunks * 2
    by = {"mode": dict(kd_ops.LAUNCHES_BY_MODE),
          "instance": dict(kd_ops.LAUNCHES_BY_INSTANCE)}
    if by != {"mode": {"ce": 0, "kd": 2 * per_check},
              "instance": {"wgmma": per_check, "general": 0,
                           "f32": per_check}}:
        fail(f"distill checks: kd_loss launches {by}")

    # where the time goes: the KD backward (``_blocked_bwd``) in one more
    # step, its span on CUDA events, then one step under the profiler
    # with the backward as a named range
    opt = adamw_init(trainable)
    step = distill.make_distill_step(s_cfg, t_cfg,
                                     optimizer_update=adamw_update, **kw)
    b = {k: v.cuda() for k, v in corpus.mixed_eval_batch(
        DISTILL_BATCH, DISTILL_SEQ, seed_salt=79).items()}
    own_bwd, spans = kd_ops._blocked_bwd, []

    def timed_bwd(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        with torch.profiler.record_function("kd_blocked_bwd"):
            ev[0].record()
            out = own_bwd(*a, **k)
            ev[1].record()
        spans.append(ev)
        return out

    kd_ops._blocked_bwd = timed_bwd
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(trainable, opt, teacher, b, DISTILL_LR)
        torch.cuda.synchronize()
        bwd_step_ms = 1e3 * (time.perf_counter() - t0)
        kd_bwd_ms = [s.elapsed_time(e) for s, e in spans]
        prof = profile(lambda: step(trainable, opt, teacher, b, DISTILL_LR),
                       top=12, groups={"kd_fwd": ("kd_wgmma", "kd_merge"),
                                       "f32_gemm": ("sgemm", "f32f32"),
                                       "flash_fwd": ("flash_fwd",)},
                       ranges=("kd_blocked_bwd",))
    finally:
        kd_ops._blocked_bwd = own_bwd
    del opt, step, trainable, teacher
    torch.cuda.empty_cache()
    if len(kd_bwd_ms) != chunks or not prof["group_ms"]["kd_fwd"] > 0:
        fail(f"the distill step ran {len(kd_bwd_ms)} KD backwards, not "
             f"{chunks}, or its profile shows no kd_loss device time")

    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = DISTILL_BATCH * DISTILL_SEQ

    def matmul_params(cfg):
        H, KH, Dh, D = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                        cfg.d_model)
        per_layer = 2 * D * H * Dh + 2 * D * KH * Dh + 3 * D * cfg.d_ff
        return cfg.n_layers * per_layer + D * cfg.vocab_size

    def attn_flops(cfg, passes):
        S = DISTILL_SEQ
        return (passes * 4 * DISTILL_BATCH * cfg.n_heads
                * cfg.resolved_head_dim * S * (S + 1) / 2 * cfg.n_layers)

    n_s, n_t = matmul_params(s_cfg), matmul_params(t_cfg)
    model_flops = (6 * n_s * tokens + attn_flops(s_cfg, 3)
                   + 2 * n_t * tokens + attn_flops(t_cfg, 1))
    res = {"steps": DISTILL_STEPS, "batch": DISTILL_BATCH,
           "seq": DISTILL_SEQ, "teacher_vocab_own": t_own.vocab_size,
           "teacher_vocab_used": t_cfg.vocab_size, "losses": losses,
           "setup_s": setup_s, "distill_proxy_wall_s": wall,
           "launches": launches, "step_ms": step_ms, "ms_per_step": ms,
           "tokens_per_s": tokens / (ms / 1e3),
           "mfu": model_flops / (ms / 1e3) / PEAK_BF16,
           "model_tflop_per_step": model_flops / 1e12,
           "student_matmul_params": n_s, "teacher_matmul_params": n_t,
           "peak_mem_gb": peak_gb, "kd_bwd_span_ms": kd_bwd_ms,
           "kd_bwd_step_ms": bwd_step_ms,
           "kd_bwd_share_of_step": sum(kd_bwd_ms) / bwd_step_ms,
           "proxy_leaves_bit_equal": proxy_leaves, **check,
           "bf16_check": check_bf16}
    print("distill " + json.dumps(res))
    print("profile " + json.dumps({"distill_step": prof}))
    return {"flash_attention": launches["flash_attention"],
            "kd_loss_kd": launches["kd_loss_kd"]}


# ---------------------------------------------------------------------------
# phase 9: the whole federation through run_deepfusion, at full width
# ---------------------------------------------------------------------------

PIPE_N, PIPE_STEPS, PIPE_BATCH, PIPE_SEQ = 4, 4, 4, 1024
# build_fleet's draws at seed 0 (np.random.default_rng(42) for the arch,
# the corpus's Dirichlet split for the domain): both families present
PIPE_ARCHS, PIPE_DOMAINS = [0, 1, 1, 0], [2, 3, 2, 1]
# eval: evaluate_model's defaults, 4 batches of 8 a domain, no gradient
EVAL_BATCH, EVAL_BATCHES = 8, 4


class _Stages:
    """Wraps the pipeline's stage functions: each call synchronised, timed
    on the host clock, its peak memory and kernel launches recorded."""

    def __init__(self):
        self.rows, self._undo = [], []

    def wrap(self, owner, attr, name_of):
        """``name_of(args, kwargs)`` names the stage of one call."""
        own = getattr(owner, attr)

        def run(*a, **k):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            c0, t0 = _counts(), time.perf_counter()
            out = own(*a, **k)
            torch.cuda.synchronize()
            c1 = _counts()
            self.rows.append({
                "stage": name_of(a, k), "wall_s": time.perf_counter() - t0,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": {n: c1[n] - c0[n] for n in c1 if c1[n] - c0[n]}})
            return out

        setattr(owner, attr, run)
        self._undo.append((owner, attr, own))

    def restore(self):
        for owner, attr, own in reversed(self._undo):
            setattr(owner, attr, own)


def _pipeline_want(fleet, fam, moe_cfg, proxy_archs):
    """The launches each stage must make, from the configs.  Per step of
    a remat'd model: flash twice a layer (forward and the backward's
    recompute; its backward is the plain version), kd_loss twice a loss
    chunk; per layer-step of the MoE as the tune phase has it; a frozen
    teacher's forward once a layer; no gradient in eval, so everything
    once."""
    n, S = PIPE_STEPS, PIPE_SEQ
    chunks = S // moe_cfg.loss_chunk
    L = moe_cfg.n_layers
    want = {"fleet": {
        "flash_attention": sum(2 * s.cfg.n_layers * n for s in fleet),
        "kd_loss": sum(2 * (S // s.cfg.loss_chunk) * n for s in fleet)}}
    for i, a in enumerate(proxy_archs):
        t_cfg = fam[a]
        want[f"phase2_proxy{i}_arch{a}"] = {
            "flash_attention": n * (t_cfg.n_layers + 2 * L),
            "kd_loss_kd": 2 * chunks * n}
    want["phase3"] = {"flash_attention": 2 * L * n, "kd_loss": 2 * chunks * n,
                      "gather_scatter_add": 6 * L * n,
                      "grouped_ffn": 2 * L * n, "grouped_matmul": 7 * L * n,
                      "split_f32": 3 * L * n}
    b = 4 * EVAL_BATCHES    # four domains
    want["eval"] = {"flash_attention": L * b, "kd_loss": chunks * b,
                    "gather_scatter_add": 2 * L * b, "grouped_ffn": L * b}
    want["phase1"] = {}
    return want


def _pipeline_configs():
    """The device families (their own and on the federation's vocabulary),
    the MoE, the simulation and the server of the pipeline phase."""
    from repro_torch.configs import get_config
    from repro_torch.federated import server as S
    from repro_torch.federated import simulation as SIM
    moe_cfg = get_config("qwen2-moe-a2.7b", variant="full").replace(
        n_layers=TUNE_LAYERS)
    own = [get_config("gpt2", variant="full"),
           get_config("gpt2-medium", variant="full")]
    fam = [c.replace(vocab_size=moe_cfg.vocab_size) for c in own]
    if not all(c.use_kernels and c.remat and c.tie_embeddings
               and c.dtype == "bfloat16" for c in fam):
        fail("device families do not train through the kernels with remat")
    sim = SIM.SimulationConfig(n_devices=PIPE_N, n_domains=4,
                               vocab=moe_cfg.vocab_size, seq_len=PIPE_SEQ,
                               device_steps=PIPE_STEPS,
                               device_batch=PIPE_BATCH, seed=0)
    scfg = S.ServerConfig(moe_cfg, distill_steps=PIPE_STEPS,
                          distill_batch=PIPE_BATCH, tune_steps=PIPE_STEPS,
                          tune_batch=PIPE_BATCH, seq_len=PIPE_SEQ, seed=0)
    return own, fam, moe_cfg, sim, scfg


def _learning_losses(report, fleet, fam, scfg, students, params):
    """Each trained model against its init, no gradient, on the same
    batches both sides: the mean over its stage's training batches
    (``epoch``) and one batch no step saw (``held``).  Devices: their
    own ``device_batches`` and ``device_batch(step=PIPE_STEPS)``;
    Phase II students (with their VAA modules, through ``distill_loss``):
    ``mixed_eval_batches`` and ``seed_salt=PIPE_STEPS``; the MoE: from
    ``seed_salt0=10_000``.  The inits are drawn again from the seeds the
    pipeline drew them from (device ``seed * 100003 + id``, student
    ``seed + 101 + i``, VAA ``+ 202 + i``; the tune started from the merge
    of the trained students, ``seed + 303``).  Returns {model:
    {"epoch": (init, trained), "held": (init, trained)}}."""
    from repro_torch.core import distill, merge
    from repro_torch.core import vaa as vaa_mod
    from repro_torch.models import model as M
    from repro_torch.utils.pytree import tree_leaves
    corpus, B, S, n = report["corpus"], PIPE_BATCH, PIPE_SEQ, PIPE_STEPS
    dev = tree_leaves(params)[0].device
    seed = scfg.seed

    def gen(s):
        return torch.Generator(device=dev).manual_seed(s)

    def batches(stacked, held):
        out = [{k: v[s].to(dev) for k, v in stacked.items()}
               for s in range(n)]
        return out + [{k: v.to(dev) for k, v in held.items()}]

    def losses(loss_of, models, bs):
        """{"epoch": (mean over bs[:-1] per model), "held": (bs[-1])}."""
        per = [[loss_of(m, b) for b in bs] for m in models]
        return {"epoch": tuple(sum(p[:-1]) / n for p in per),
                "held": tuple(p[-1] for p in per)}

    out = {}
    with torch.no_grad():
        for spec, up in zip(fleet, report["uploads"]):
            i = spec.device_id
            bs = batches(corpus.device_batches(i, n, B, S),
                         corpus.device_batch(i, B, S, step=n))
            init = M.init_params(spec.cfg, generator=gen(seed * 100003 + i))
            out[f"device{i}"] = losses(
                lambda p, b: M.loss_fn(p, spec.cfg, b)[0].item(),
                (init, up["params"]), bs)
            del init
        bs = batches(corpus.mixed_eval_batches(n, B, S),
                     corpus.mixed_eval_batch(B, S, seed_salt=n))
        base = merge.base_config_of(scfg.moe_cfg)
        kw = dict(alpha=scfg.alpha, beta=scfg.beta,
                  temperature=scfg.temperature, n_stages=scfg.n_stages,
                  vaa_heads=scfg.vaa_heads, p_q=scfg.p_q)
        for i, (item, student, vaa) in enumerate(students):
            t_cfg, t_params = fam[item["arch"]], item["params"]
            t_outs = [distill.teacher_forward(t_params, t_cfg, b,
                                              n_stages=scfg.n_stages)
                      for b in bs]
            init = {"student": M.init_params(base, generator=gen(
                        seed + 101 + i)),
                    "vaa": vaa_mod.init_vaa(
                        gen(seed + 202 + i), n_stages=scfg.n_stages,
                        d_student=base.d_model, d_teacher=t_cfg.d_model,
                        d=scfg.vaa_dim, p_q=scfg.p_q)}

            def distill_of(tr, b):
                t_out = t_outs[next(j for j, x in enumerate(bs) if x is b)]
                return distill.distill_loss(tr, base, t_params, t_cfg, b,
                                            t_out, **kw)[0].item()

            out[f"proxy{i}"] = losses(
                distill_of, (init, {"student": student, "vaa": vaa}), bs)
            del init, t_outs
        bs = batches(corpus.mixed_eval_batches(n, B, S, seed_salt0=10_000),
                     corpus.mixed_eval_batch(B, S, seed_salt=10_000 + n))
        start = merge.merge_into_moe(gen(seed + 303), scfg.moe_cfg,
                                     [s for _, s, _ in students])
        out["tune"] = losses(
            lambda p, b: M.loss_fn(p, scfg.moe_cfg, b)[0].item(),
            (start, params), bs)
        del start
    return out


def phase_pipeline():
    """``run_deepfusion`` from ``uploads=None`` at full width, the paper's
    case study 1: four devices (GPT-2 12 x 768 and GPT-2-Medium 24 x
    1024, bf16, on the federation's vocabulary 151936) train 4 steps of 4
    x 1024 tokens; Phase I (K 60 > N 4: each upload its own proxy);
    Phase II distils each proxy into the dense base of Qwen1.5-MoE-A2.7B
    (12 of 24 layers) for 4 steps of 4 x 1024; Phase III merges and
    tunes the MoE 4 steps of 4 x 1024; ``evaluate_model`` on 4 domains x
    4 batches of 8 x 1024."""
    from repro_torch.core import vaa as vaa_mod
    from repro_torch.federated import device as Dv
    from repro_torch.federated import server as S
    from repro_torch.federated import simulation as SIM
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.models import moe

    own, fam, moe_cfg, sim, scfg = _pipeline_configs()
    V = moe_cfg.vocab_size
    # the fleet run_deepfusion builds (the same draws)
    fleet = SIM.build_fleet(sim, SIM.build_corpus(sim), fam)
    archs = [s.arch_id for s in fleet]
    domains = [s.domain_id for s in fleet]
    if archs != PIPE_ARCHS or domains != PIPE_DOMAINS:
        fail(f"pipeline fleet archs {archs} domains {domains}, not "
             f"{PIPE_ARCHS} {PIPE_DOMAINS}")
    print(f"pipeline: {CARD}; devices {[c.name for c in fam]} on vocab {V} "
          f"(their own {own[0].vocab_size}), archs {archs}, domains "
          f"{domains}; MoE {moe_cfg.name} {moe_cfg.n_layers} of 24 layers")

    # the students (returned by distill_proxy) and their VAA modules
    # (trained in place), kept for the learning check
    students, vaas, own_vaa = [], [], vaa_mod.init_vaa

    def keeping_vaa(*a, **k):
        vaas.append(own_vaa(*a, **k))
        return vaas[-1]

    own_distill = S.DeepFusionServer.distill_proxy

    def keeping_student(self, item, base_cfg, **k):
        out = own_distill(self, item, base_cfg, **k)
        students.append((item, out[0]))
        return out

    S.DeepFusionServer.distill_proxy = keeping_student
    stages = _Stages()
    stages.wrap(SIM, "train_fleet", lambda a, k: "fleet")
    stages.wrap(S.DeepFusionServer, "cluster", lambda a, k: "phase1")
    # a proxy's stage carries its teacher's family: a[1] is the proxy
    stages.wrap(S.DeepFusionServer, "distill_proxy",
                lambda a, k: f"phase2_proxy{k['seed_offset']}_arch"
                             f"{a[1]['arch']}")
    stages.wrap(S.DeepFusionServer, "merge_and_tune", lambda a, k: "phase3")
    stages.wrap(SIM, "evaluate_model", lambda a, k: "eval")
    # KD-mode kd_loss calls timed on CUDA events, the tied teacher head's
    # .contiguous() copy included (the wrapper makes it on every launch)
    own_fwd, kd_spans = kd_ops.kd_loss_fwd, []

    def timed_fwd(hs, ws, ht, wt, labels, **kw):
        if ht is None:
            return own_fwd(hs, ws, ht, wt, labels, **kw)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = own_fwd(hs, ws, ht, wt, labels, **kw)
        ev[1].record()
        kd_spans.append((ht.shape[-1], ev))
        return out

    choices, own_route = [], moe.route

    def recording_route(p, c, x, live=None):
        w, idx, aux = own_route(p, c, x, live)
        choices.append((torch.is_grad_enabled(), idx))
        return w, idx, aux

    # each device's share of the fleet stage, in the order they train
    device_s, own_train = [], Dv.train_device

    def timed_device(spec, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = own_train(spec, *a, **k)
        torch.cuda.synchronize()
        device_s.append((spec.device_id, time.perf_counter() - t))
        return out

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _zero_counts()       # the main path, counts from 0
    kd_ops.kd_loss_fwd, moe.route = timed_fwd, recording_route
    vaa_mod.init_vaa, Dv.train_device = keeping_vaa, timed_device
    logs = []
    t0 = time.perf_counter()
    try:
        params, report = SIM.run_deepfusion(sim, scfg, fam, log=logs.append,
                                            device="cuda")
    finally:
        kd_ops.kd_loss_fwd, moe.route = own_fwd, own_route
        stages.restore()
        S.DeepFusionServer.distill_proxy = own_distill
        vaa_mod.init_vaa, Dv.train_device = own_vaa, own_train
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak_gb = max(r["peak_gb"] for r in stages.rows)
    for line in logs:
        print("pipeline log: " + line)

    # launches, stage by stage, against the configs
    n_prox = report["n_clusters"]
    if n_prox != PIPE_N or report["cluster_sizes"] != [1] * PIPE_N:
        fail(f"Phase I: {n_prox} proxies {report['cluster_sizes']}, not one "
             f"an upload")
    got = {r["stage"]: r["launches"] for r in stages.rows}
    proxy_archs = [int(n.rsplit("arch", 1)[1]) for n in got
                   if n.startswith("phase2")]
    if sorted(proxy_archs) != sorted(archs):
        fail(f"Phase II teachers' families {proxy_archs}, uploads' {archs}")
    want = _pipeline_want(fleet, fam, moe_cfg, proxy_archs)
    if got != want:
        fail(f"pipeline launches by stage {got} != expected {want}")
    _all_wgmma(kd_ops, "pipeline")
    _gmm_on_tensor_cores(mg_ops, moe_cfg.n_layers * PIPE_STEPS, "pipeline")
    _gsa_all_vec(md_ops, "pipeline")

    # losses finite; the bill; the metrics
    hists = {f"device{u['device_id']}": u["losses"]
             for u in report["uploads"]}
    hists.update({f"proxy{i}": h
                  for i, h in enumerate(report["distill_hists"])})
    hists["tune"] = report["tune_hist"]
    bad = [n for n, h in hists.items()
           if len(h) != PIPE_STEPS or not all(map(math.isfinite, h))]
    bill = sum(Dv.device_upload_bytes(s.comm_cfg) for s in fleet)
    m = report["metrics"]
    # learning: every trained model against its init on the same
    # batches.  A history's first and last losses come from different
    # batches: at 4 steps (step 0 at lr 0) the batches move them more
    # than the three updates do.  The mean over its own training batches
    # is held for every model; the held-out batch for the devices and
    # the proxies (the tune's is reported: its three steps at the tune's
    # learning rate move a held-out loss by less than its batch noise).
    learn = _learning_losses(report, fleet, fam, scfg,
                             [(it, st, v) for (it, st), v in
                              zip(students, vaas)], params)
    del students, vaas
    # the kernel path's drops (the MoE's capacity) in tune and eval
    tune_calls = [i for g, i in choices if g]
    eval_calls = [i for g, i in choices if not g]
    drops = {"tune_per_step": sum(_dropped(i, moe_cfg.n_experts)
                                  for i in tune_calls) / 2 / PIPE_STEPS,
             "eval": sum(_dropped(i, moe_cfg.n_experts) for i in eval_calls),
             "eval_assignments": sum(i.numel() for i in eval_calls)}
    del choices, tune_calls, eval_calls

    # the tied heads' copy, alone, against the KD calls' spans
    spans = {}
    for dt, ev in kd_spans:
        spans.setdefault(dt, []).append(ev[0].elapsed_time(ev[1]))
    copy_ms = {}
    for u in report["uploads"]:
        emb = u["params"]["embed"]
        if emb.shape[1] not in copy_ms:
            copy_ms[emb.shape[1]] = time_ms(lambda: emb.T.contiguous())
    kd = {f"Dt{dt}": {"launches": len(v), "span_ms_median":
                      sorted(v)[len(v) // 2], "copy_ms": copy_ms[dt],
                      "copy_share": copy_ms[dt] / sorted(v)[len(v) // 2]}
          for dt, v in sorted(spans.items())}
    del kd_spans

    tokens = {"fleet": PIPE_N * PIPE_STEPS * PIPE_BATCH * PIPE_SEQ,
              "phase3": PIPE_STEPS * PIPE_BATCH * PIPE_SEQ,
              "eval": 4 * EVAL_BATCHES * EVAL_BATCH * PIPE_SEQ}
    rows = []
    for r in stages.rows:
        tk = tokens.get(r["stage"], PIPE_STEPS * PIPE_BATCH * PIPE_SEQ
                        if r["stage"].startswith("phase2") else 0)
        rows.append(dict(r, tokens=tk,
                         tokens_per_s=tk / r["wall_s"] if tk else None))
    res = {"card": CARD, "wall_s": wall, "peak_mem_gb": peak_gb,
           "stages": rows, "fleet_device_s": device_s,
           "launches": launches, "kd_calls": kd,
           "moe_drops": drops, "losses": hists,
           "loss_init_trained": learn,
           "comm_bytes": report["comm_bytes"],
           "upload_bytes": [u["upload_bytes"] for u in report["uploads"]],
           "trainable_fraction": report["trainable_fraction"],
           "metrics": m}
    print("pipeline " + json.dumps(res))
    print(f"pipeline: log_ppl {m['log_ppl']:.4f}, accuracy "
          f"{m['accuracy']:.4f}, per-domain ppl "
          f"{[round(m[f'ppl_domain{d}'], 1) for d in range(4)]}, acc "
          f"{[round(m[f'acc_domain{d}'], 4) for d in range(4)]}; "
          f"{wall:.1f}s, peak {peak_gb:.2f} GB")
    del params, report
    torch.cuda.empty_cache()
    if bad:
        fail(f"pipeline: non-finite or missing losses in {bad}")
    for name, r in learn.items():
        init, trained = r["epoch"]
        if not trained < init:
            fail(f"pipeline {name}: the trained model's mean loss over its "
                 f"training batches, {trained}, is not below its init's "
                 f"{init}")
        init, trained = r["held"]
        if name != "tune" and not trained < init:
            fail(f"pipeline {name}: the trained model's loss on a held-out "
                 f"batch, {trained}, is not below its init's {init}")
    if res["comm_bytes"] != bill:
        fail(f"pipeline comm_bytes {res['comm_bytes']} != the fleet's "
             f"device_upload_bytes {bill}")
    if not all(math.isfinite(v) for v in m.values()):
        fail(f"pipeline metrics {m}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the paper's comparison, every method at the repo's own scale
# ---------------------------------------------------------------------------

# benchmarks/common.py's configuration (copied: that module imports JAX),
# every method's step counts halved to keep the whole script's time:
# devices 15 steps (30 there), Phase II and III 20 (40), FedJETS 3 rounds
# of 5 local steps (10), centralized 60 (120), FedAvg 5 rounds of 4 (its
# default 8)
METHODS_N, METHODS_VOCAB, METHODS_SEQ = 8, 256, 48
METHODS_STEPS = dict(device=15, distill=20, tune=20, fedjets_local=5,
                     centralized=60, fedavg_local=4)
# DeepFusion with kernels and with use_kernels=False at cut step counts
METHODS_CUT = 6
# Kernel path against the plain path (f32 kernels against plain f32
# PyTorch; the dense phases are the same function on both, the MoE's
# capacity path is held only when it dropped nothing; at E 4, k 2 the
# capacity 2·T·k/E is T, so nothing can drop).  Readings on an H100
# (700 W), largest relative difference: device losses 1.74e-7 (two f32
# ulps of ~5.5, an ulp being 8.7e-8 of it), Phase II 8.5e-8, tune and
# log_ppl 0 (equal: means over 384 tokens whose per-token differences
# cancel below half an ulp, while the two paths' hidden states differ in
# most elements, as ``same_params`` reports).  Limits about 3x the worst
# nonzero reading, six ulps.
METHODS_HIST_RTOL = 5e-7
METHODS_LOGPPL_RTOL = 5e-7
# FedKMT (alpha = 0) at the cut counts must land at least this many
# log_ppl limits away from DeepFusion, so the check sees the VAA term
# (reading on an H100, 700 W: 4.16e-5, 83 limits)
METHODS_KMT_MARGIN = 10.0


def _methods_configs(use_kernels=True):
    """benchmarks/common.py's families, MoE, simulation and server."""
    from repro_torch.federated import server as S
    from repro_torch.federated import simulation as SIM
    from repro_torch.models.config import ModelConfig
    small = dict(vocab_size=METHODS_VOCAB, dtype="float32", remat=False,
                 attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32,
                 use_kernels=use_kernels)
    a = ModelConfig(name="gpt2-tiny", n_layers=2, d_model=64, n_heads=4,
                    n_kv_heads=4, head_dim=16, d_ff=128,
                    norm_type="layernorm", act="gelu", mlp_gated=False,
                    pos_embedding="sinusoidal", **small).validate()
    b = ModelConfig(name="llama-tiny", n_layers=3, d_model=96, n_heads=4,
                    n_kv_heads=2, head_dim=24, d_ff=192, **small).validate()
    moe_cfg = ModelConfig(name="qwen-moe-tiny", arch_type="moe", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                          d_ff=128, n_experts=4, top_k=2, moe_d_ff=128,
                          n_shared_experts=1, **small).validate()
    sim = SIM.SimulationConfig(n_devices=METHODS_N, n_domains=4,
                               vocab=METHODS_VOCAB, seq_len=METHODS_SEQ,
                               device_steps=METHODS_STEPS["device"],
                               device_batch=8, seed=0)
    scfg = S.ServerConfig(moe_cfg=moe_cfg,
                          distill_steps=METHODS_STEPS["distill"],
                          distill_batch=8,
                          tune_steps=METHODS_STEPS["tune"], tune_batch=8,
                          seq_len=METHODS_SEQ, n_stages=2, p_q=32,
                          vaa_dim=64, seed=0)
    return [a, b], moe_cfg, sim, scfg


def _rel_dist(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_methods():
    """DeepFusion, FedKMT, OFA-KD, FedJETS, centralized training and
    FedAvg on the card, on ``benchmarks/common.py``'s f32 configs (vocab
    256, seq 48, N 8, its step counts halved: METHODS_STEPS), one
    fleet's uploads shared as
    ``benchmarks/methods.py::run_all_methods`` shares them; each
    method's ``comm_bytes`` against its formula; then DeepFusion at cut
    step counts with kernels and with ``use_kernels=False``."""
    from repro_torch.core import baselines as B
    from repro_torch.federated import device as Dv
    from repro_torch.federated import server as S
    from repro_torch.federated import simulation as SIM
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.utils.pytree import tree_bytes, tree_leaves

    fam, moe_cfg, sim, scfg = _methods_configs()
    quiet = dict(log=lambda s: None, device="cuda")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    corpus = SIM.build_corpus(sim)
    fleet = SIM.build_fleet(sim, corpus, fam)
    uploads = Dv.train_fleet(fleet, corpus, steps=sim.device_steps,
                             batch=sim.device_batch, seq_len=sim.seq_len,
                             seed=sim.seed, device="cuda")
    shared = dict(uploads=uploads, corpus=corpus, **quiet)
    runs, walls = {}, {"fleet": time.perf_counter() - t0}
    for name, call in (
            ("deepfusion", lambda: SIM.run_deepfusion(sim, scfg, fam,
                                                      **shared)),
            ("fedkmt", lambda: B.run_fedkmt(sim, scfg, fam, **shared)),
            ("ofa_kd", lambda: B.run_ofa_kd(sim, scfg, fam, **shared)),
            ("fedjets", lambda: B.run_fedjets(
                sim, moe_cfg, rounds=3,
                local_steps=METHODS_STEPS["fedjets_local"], batch=8,
                corpus=corpus, **quiet)),
            ("centralized", lambda: B.run_centralized(
                sim, moe_cfg, steps=METHODS_STEPS["centralized"], batch=8,
                corpus=corpus, **quiet)),
            ("fedavg", lambda: B.run_fedavg(
                sim, fam[0], local_steps=METHODS_STEPS["fedavg_local"],
                corpus=corpus, **quiet))):
        t1 = time.perf_counter()
        _, runs[name] = call()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
    launches = _counts()

    # each method's bill, by its formula
    up = sum(Dv.device_upload_bytes(s.comm_cfg) for s in fleet)
    dense = tree_bytes(M.init_params(fam[0], generator="meta"))
    local = tree_bytes(M.init_params(moe_cfg.replace(n_experts=2),
                                     generator="meta"))
    bills = {"deepfusion": up, "fedkmt": up, "ofa_kd": up,
             "fedjets": 2 * local * sim.n_devices * 3,
             "centralized": sim.n_devices * sim.device_steps
             * sim.device_batch * (sim.seq_len + 1) * 4,
             "fedavg": 2 * dense * sim.n_devices * 5}
    for name, rep in runs.items():
        m = rep["metrics"]
        print(f"methods: {name:12s} log_ppl {m['log_ppl']:.4f} accuracy "
              f"{m['accuracy']:.4f} comm_bytes {rep['comm_bytes']} "
              f"({walls[name]:.1f}s)")
        if rep["comm_bytes"] != bills[name]:
            fail(f"methods {name}: comm_bytes {rep['comm_bytes']} != its "
                 f"formula {bills[name]}")
        if not all(math.isfinite(v) for v in m.values()):
            fail(f"methods {name}: metrics {m}")
    if runs["fedjets"]["local_model_bytes"] != local:
        fail(f"fedjets local_model_bytes {runs['fedjets']['local_model_bytes']}"
             f" != {local}")
    missing = [k for k in ("flash_attention", "kd_loss", "kd_loss_kd",
                           "grouped_ffn", "grouped_matmul",
                           "gather_scatter_add") if not launches[k]]
    if missing:
        fail(f"methods: no launches of {missing} ({launches})")
    del runs

    # DeepFusion at cut counts, kernels against use_kernels=False: the
    # kernel run's tune and eval must launch the MoE's kernels, the plain
    # run no kernel at all
    cut = dict(device_steps=METHODS_CUT)
    srv_cut = dict(distill_steps=METHODS_CUT, tune_steps=METHODS_CUT)
    paths = {}
    for use_kernels in (True, False):
        fam_k, moe_k, sim_k, scfg_k = _methods_configs(use_kernels)
        sim_k = dataclasses.replace(sim_k, **cut)
        scfg_k = dataclasses.replace(scfg_k, **srv_cut)
        stages = _Stages()
        stages.wrap(S.DeepFusionServer, "merge_and_tune", lambda a, k: "tune")
        stages.wrap(SIM, "evaluate_model", lambda a, k: "eval")
        torch.cuda.synchronize()
        _zero_counts()
        try:
            with _RouteTap(moe, ids_only=True) as tap:
                params_k, rep = SIM.run_deepfusion(sim_k, scfg_k, fam_k,
                                                   **quiet)
        finally:
            stages.restore()
        torch.cuda.synchronize()
        drops = sum(_dropped(i, moe_k.n_experts) for i in tap.record)
        paths[use_kernels] = dict(
            rep=rep, drops=drops, fam=fam_k, sim=sim_k, scfg=scfg_k,
            params=params_k, moe=moe_k, counts=_counts(),
            by_stage={r["stage"]: r["launches"] for r in stages.rows})
    kern, plain = paths[True], paths[False]
    plain_counts = plain["counts"]
    if any(plain_counts.values()):
        fail(f"methods: the use_kernels=False run launched kernels "
             f"{plain_counts}")
    by_stage = kern["by_stage"]
    need = {"tune": ("flash_attention", "kd_loss", "grouped_ffn",
                     "grouped_matmul", "gather_scatter_add"),
            "eval": ("flash_attention", "kd_loss", "grouped_ffn",
                     "gather_scatter_add")}
    short = {st: [k for k in ks if not by_stage.get(st, {}).get(k)]
             for st, ks in need.items()}
    if any(short.values()) or not kern["counts"]["kd_loss_kd"]:
        fail(f"methods: the kernel run's tune/eval launched none of {short} "
             f"(tune and eval {by_stage}, whole run {kern['counts']})")
    # the two paths on the same parameters and batch (the kernel run's
    # tuned MoE, a batch no tune step saw): the final hidden states
    # differ where the losses, means over 384 tokens, may not
    params_k = kern["params"]
    b = {k: v.to("cuda") for k, v in kern["rep"]["corpus"].mixed_eval_batch(
        kern["scfg"].tune_batch, kern["sim"].seq_len,
        seed_salt=10_000 + METHODS_CUT).items()}
    with torch.no_grad():
        hk = M.backbone(params_k, kern["moe"], b)[0]
        hp = M.backbone(params_k, plain["moe"], b)[0]
        lk = M.loss_fn(params_k, kern["moe"], b)[0].item()
        lp = M.loss_fn(params_k, plain["moe"], b)[0].item()
    same_params = {
        "h_max_abs_diff": (hk - hp).abs().max().item(),
        "h_max_abs": hk.abs().max().item(),
        "h_share_differing": (hk != hp).float().mean().item(),
        "loss_kernel": lk, "loss_plain": lp,
        "tuned_params_max_abs_diff_across_runs": max(
            (a - c).abs().max().item() for a, c in
            zip(tree_leaves(params_k), tree_leaves(plain["params"])))}
    del hk, hp, b, params_k
    rk, rp, drops = kern["rep"], plain["rep"], kern["drops"]
    _, kmt = B.run_fedkmt(kern["sim"], kern["scfg"], kern["fam"],
                          uploads=rk["uploads"], corpus=rk["corpus"], **quiet)
    dist = {
        "device_losses": max(_rel_dist(a["losses"], b["losses"])
                             for a, b in zip(rk["uploads"], rp["uploads"])),
        "distill_hists": max(_rel_dist(a, b) for a, b in
                             zip(rk["distill_hists"], rp["distill_hists"])),
        "tune_hist": _rel_dist(rk["tune_hist"], rp["tune_hist"]),
        "log_ppl": _rel_dist(rk["metrics"]["log_ppl"],
                             rp["metrics"]["log_ppl"]),
        "fedkmt_log_ppl": _rel_dist(kmt["metrics"]["log_ppl"],
                                    rk["metrics"]["log_ppl"])}
    res = {"card": CARD, "walls_s": walls, "launches": launches,
           "cut_steps": METHODS_CUT, "kernel_vs_plain": dist,
           "kernel_path_moe_drops": drops,
           "kernel_run_launches": {"tune": by_stage["tune"],
                                   "eval": by_stage["eval"],
                                   "whole": kern["counts"]},
           "plain_run_launches": plain_counts,
           "same_params": same_params,
           "limits": {"hist": METHODS_HIST_RTOL,
                      "log_ppl": METHODS_LOGPPL_RTOL,
                      "fedkmt_margin": METHODS_KMT_MARGIN}}
    print("methods " + json.dumps(res))
    for k in ("device_losses", "distill_hists"):
        if not dist[k] <= METHODS_HIST_RTOL:
            fail(f"methods: kernel-path {k} differ from the plain path's "
                 f"by {dist[k]} > {METHODS_HIST_RTOL}")
    if drops == 0:
        if not dist["tune_hist"] <= METHODS_HIST_RTOL:
            fail(f"methods: kernel-path tune losses differ by "
                 f"{dist['tune_hist']} > {METHODS_HIST_RTOL}")
        if not dist["log_ppl"] <= METHODS_LOGPPL_RTOL:
            fail(f"methods: kernel-path log_ppl differs by "
                 f"{dist['log_ppl']} > {METHODS_LOGPPL_RTOL}")
    else:
        print(f"methods: the kernel path dropped {drops} assignments; "
              f"its MoE phases are reported, not held")
    if not dist["fedkmt_log_ppl"] >= METHODS_KMT_MARGIN * \
            METHODS_LOGPPL_RTOL:
        fail(f"methods: FedKMT lies {dist['fedkmt_log_ppl']} from "
             f"DeepFusion, under {METHODS_KMT_MARGIN} log_ppl limits")
    return launches


# phase 11: the fleet extensions at full width
# ---------------------------------------------------------------------------

# (a) ideal async rounds against one synchronous run of as many steps
FLEET_ROUNDS, FLEET_K = 3, 2
# (b) a straggler fleet: harsh traffic, int8 moments, stale late reports.
# Seed 0's draws (reckoned on the host, _predict_rounds) hold offline
# device-rounds, stale merges, a mixed-staleness merge and lost reports.
STRAG_ROUNDS, STRAG_K, STRAG_PARTICIPATION = 4, 2, 0.75
STRAG_DEADLINE_S, STRAG_SEED = 2.0, 0
# each bucket's aggregate against its closed form sum w_i x_i / sum w_i in
# f64: the f32 sum rounds to bf16 once (half an ulp, 2^-9 of the value),
# plus the f32 sum's own error relative to sum w_i |x_i| / sum w_i
AGG_REL, AGG_ABS = 2.0 ** -8, 2.0 ** -20
# the launcher's fleet smoke, as a user would run it
FLEET_CLI = ["--fleet", "8", "--async-rounds", "3", "--steps-per-round", "2",
             "--straggler-profile", "mild", "--check-sync"]


def _predict_rounds(fleet, acfg):
    """The straggler run's schedule from the traffic draws alone, on the
    host: the ``rounds`` log (without bytes), each device's online
    rounds, and the lost reports (late reports that never arrive)."""
    from repro_torch.federated import device as Dv
    n, pending, rows, lost = len(fleet), [], [], 0
    online_rounds = {s.device_id: [] for s in fleet}
    for r in range(acfg.rounds):
        traffic = {s.device_id: Dv.sample_traffic(s, r, acfg.seed)
                   for s in fleet}
        for d, (_, on) in traffic.items():
            if on:
                online_rounds[d].append(r)
        ids = sorted(traffic)
        n_sel = max(1, math.ceil(acfg.participation * n))
        rng = np.random.default_rng((acfg.seed, 424_242, r))
        sel = set(ids) if n_sel >= n else {
            ids[i] for i in rng.choice(n, size=n_sel, replace=False)}
        fresh = dropped = 0
        for d in ids:
            lat, on = traffic[d]
            if d not in sel or not on:
                continue
            late = 0 if lat <= acfg.deadline_s else \
                math.ceil(lat / acfg.deadline_s) - 1
            if late and acfg.deadline_policy == "drop":
                dropped += 1
                lost += 1
            elif late:
                pending.append(r + late)
            else:
                fresh += 1
        matured = sum(a <= r for a in pending)
        pending = [a for a in pending if a > r]
        rows.append({"round": r, "online": sum(t[1] for t in traffic.values()),
                     "selected": len(sel), "reported": fresh + matured,
                     "stale_merged": matured, "late_dropped": dropped,
                     "participation_rate": round((fresh + matured) / n, 4)})
    return rows, online_rounds, lost + len(pending)


def _fleet_want(ups, fleet):
    """Launches of the uploads' device steps: per step of a remat'd model,
    flash twice a layer and kd_loss twice a loss chunk."""
    cfg = {s.device_id: s.cfg for s in fleet}
    return {"flash_attention": sum(2 * cfg[u["device_id"]].n_layers *
                                   len(u["losses"]) for u in ups),
            "kd_loss": sum(2 * (PIPE_SEQ // cfg[u["device_id"]].loss_chunk) *
                           len(u["losses"]) for u in ups)}


def _fleet_launches(kd_ops, ups, fleet, what):
    """The counts of the run just made (zeroed before it) against its
    device steps, every kd_loss launch in the wgmma instance."""
    c = _counts()
    got = {"flash_attention": c["flash_attention"], "kd_loss": c["kd_loss"]}
    want = _fleet_want(ups, fleet)
    steps = sum(len(u["losses"]) for u in ups)
    print(f"fleet {what}: {steps} device steps, launches {got}")
    if got != want or c["kd_loss_kd"]:
        fail(f"fleet {what}: launches {c} for {steps} device steps, "
             f"expected {want}")
    _all_wgmma(kd_ops, f"fleet {what}")
    return got


def _first_difference(ups, ref):
    """'' if every upload's losses and parameters are equal bit for bit,
    else the first that is not."""
    from repro_torch.utils.pytree import tree_paths
    for u, r in zip(ups, ref):
        if u["losses"] != r["losses"]:
            return f"device {u['device_id']} losses"
        for (p, a), (_, b) in zip(tree_paths(u["params"]),
                                  tree_paths(r["params"])):
            if not torch.equal(a, b):
                return f"device {u['device_id']} leaf {p}"
    return ""


class _AggregateCheck:
    """Wraps ``FleetAggregator.merge_round``: each bucket's aggregate held
    to its closed form ``sum w_i x_i / sum w_i``, reckoned in f64 on the
    card from the delivered reports with the host's f64 weights.  Where
    the weights differ, the same reports merged without the staleness
    discount must break the limit somewhere."""

    def __init__(self, S):
        self.S, self.own = S, S.FleetAggregator.merge_round
        self.worst, self.undiscounted, self.merges = 0.0, [], []
        check = self

        def merge_round(agg, key, reports):
            out = check.own(agg, key, reports)
            check.hold(agg.acfg, reports, out)
            return out

        S.FleetAggregator.merge_round = merge_round

    def restore(self):
        self.S.FleetAggregator.merge_round = self.own

    @torch.no_grad()
    def hold(self, acfg, reports, out):
        from repro_torch.utils.pytree import tree_leaves
        ws = [self.S.staleness_weight(acfg.alpha, r["staleness"],
                                      acfg.staleness_power) for r in reports]
        self.merges.append(sorted(int(r["staleness"]) for r in reports))
        mixed = len(set(ws)) > 1
        worst_plain = 0.0
        for i, got in enumerate(tree_leaves(out)):
            xs = [tree_leaves(r["params"])[i].double() for r in reports]
            scale = sum(w * x.abs() for w, x in zip(ws, xs)) / sum(ws)
            want = sum(w * x for w, x in zip(ws, xs)) / sum(ws)
            lim = AGG_REL * want.abs() + AGG_ABS * scale
            self.worst = max(self.worst, float(
                ((got.double() - want).abs() / lim.clamp_min(1e-300)).max()))
            if mixed:
                plain = sum(xs) / len(xs)
                worst_plain = max(worst_plain, float(
                    ((got.double() - plain).abs() / lim.clamp_min(1e-300))
                    .max()))
        if mixed:
            self.undiscounted.append(worst_plain)


def _state_bytes(states):
    from repro_torch.utils.pytree import tree_bytes
    return sum(tree_bytes(p) + tree_bytes(o["m"]) + tree_bytes(o["v"]) +
               tree_bytes(o.get("v_scale", {})) for p, o in states)


def _fleet_memory(AF, Dv, S, fleet, corpus, policy):
    """The resident fleet state (every device's params and moments) by
    ``memory_allocated`` after its init, and the peak of one ideal round
    of one step over that state."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    states = [Dv._device_init(s, 0, torch.device("cuda"),
                              state_policy=policy) for s in fleet]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    counted = _state_bytes(states)
    del states
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    AF.train_fleet_async(fleet, corpus, S.AsyncFleetConfig(
        rounds=1, steps_per_round=1), batch=PIPE_BATCH, seq_len=PIPE_SEQ,
        state_policy=policy, device="cuda")
    torch.cuda.synchronize()
    return {"policy": policy or "fp32", "resident_gb": resident / 1e9,
            "state_bytes_gb": counted / 1e9,
            "round_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}


def phase_fleet():
    """The fleet extensions at full width, on the pipeline phase's fleet
    (four GPT-2 / GPT-2-Medium devices, bf16, vocab 151936, tied heads,
    batch 4 x 1024): (a) ``train_fleet_async`` 3 rounds x 2 steps on an
    ideal fleet against ``train_fleet`` 6 steps, bit for bit; (b) a
    straggler fleet (``build_fleet(traffic="harsh")``, int8 moments,
    participation 0.75, deadline 2 s, stale late reports, 4 rounds x 2
    steps), held to the schedule the host predicts from the draws;
    (c) the resident fleet state and a round's peak, fp32 against int8
    moments; then ``launch/train.py --fleet 8 ... --check-sync``."""
    import contextlib
    import io
    from repro_torch.federated import async_fleet as AF
    from repro_torch.federated import device as Dv
    from repro_torch.federated import server as S
    from repro_torch.federated import simulation as SIM
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.launch import train as TL

    own, fam, moe_cfg, sim, _ = _pipeline_configs()
    corpus = SIM.build_corpus(sim)
    fleet = SIM.build_fleet(sim, corpus, fam)
    if [s.arch_id for s in fleet] != PIPE_ARCHS:
        fail(f"fleet archs {[s.arch_id for s in fleet]}, not {PIPE_ARCHS}")
    run = dict(batch=PIPE_BATCH, seq_len=PIPE_SEQ, seed=0, device="cuda")
    print(f"fleet: {CARD}; devices {[c.name for c in fam]} on vocab "
          f"{moe_cfg.vocab_size}, archs {PIPE_ARCHS}")
    launches = {"flash_attention": 0, "kd_loss": 0}

    def add(got):
        for k in launches:
            launches[k] += got[k]

    # (a) ideal async rounds against one synchronous run
    total = FLEET_ROUNDS * FLEET_K
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    sync = Dv.train_fleet(fleet, corpus, steps=total, **run)
    torch.cuda.synchronize()
    t_sync = time.perf_counter() - t0
    add(_fleet_launches(kd_ops, sync, fleet, "sync"))
    _zero_counts()
    t0 = time.perf_counter()
    asy, rep = AF.train_fleet_async(
        fleet, corpus, S.AsyncFleetConfig(rounds=FLEET_ROUNDS,
                                          steps_per_round=FLEET_K), **run)
    torch.cuda.synchronize()
    t_async = time.perf_counter() - t0
    add(_fleet_launches(kd_ops, asy, fleet, "ideal async"))
    diff = _first_difference(asy, sync)
    if diff:
        fail(f"ideal async rounds differ from train_fleet at {diff}")
    if rep["staleness_hist"] != {0: PIPE_N * FLEET_ROUNDS}:
        fail(f"ideal async staleness {rep['staleness_hist']}")
    ideal = {"rounds": FLEET_ROUNDS, "steps_per_round": FLEET_K,
             "bitwise_equal": True, "sync_wall_s": t_sync,
             "async_wall_s": t_async,
             "losses": {u["device_id"]: u["losses"] for u in asy}}
    print("fleet ideal " + json.dumps(ideal))
    del sync, asy, rep
    torch.cuda.empty_cache()

    # (b) a straggler fleet with int8 moments
    acfg = S.AsyncFleetConfig(
        rounds=STRAG_ROUNDS, steps_per_round=STRAG_K,
        participation=STRAG_PARTICIPATION, deadline_s=STRAG_DEADLINE_S,
        deadline_policy="stale", seed=STRAG_SEED)
    slow = SIM.build_fleet(sim, corpus, fam, traffic="harsh")
    want_rows, online_rounds, want_lost = _predict_rounds(slow, acfg)
    print("fleet straggler predicted " + json.dumps(
        {"rounds": want_rows, "online_rounds": online_rounds,
         "lost_reports": want_lost}))
    if not (any(r["online"] < PIPE_N for r in want_rows)
            and sum(r["stale_merged"] for r in want_rows) and want_lost):
        fail("the straggler draws hold no offline round, stale merge or "
             "lost report")
    states, starts, held, unchanged = {}, [], {}, []
    own_init, own_round, own_select = (AF._device_init, AF.train_round,
                                       AF.selected_devices)

    def keep_state(spec, *a, **k):
        states[spec.device_id] = own_init(spec, *a, **k)
        return states[spec.device_id]

    def record_round(spec, *a, **k):
        starts.append((spec.device_id, k["start"]))
        return own_round(spec, *a, **k)

    def offline_still(until_round):
        """The devices offline in the round before ``until_round`` hold
        the state they had when it began, bit for bit."""
        from repro_torch.utils.pytree import tree_leaves
        for d, copy in held.items():
            p, o = states[d]
            now = tree_leaves(p) + tree_leaves(o["m"]) + tree_leaves(o["v"]) \
                + tree_leaves(o.get("v_scale", {}))
            same = all(torch.equal(a, b) for a, b in zip(now, copy))
            unchanged.append((d, until_round - 1, same))
        held.clear()

    def at_round_start(fl, a, r):
        from repro_torch.utils.pytree import tree_leaves
        offline_still(r)
        for s in fl:
            if not Dv.sample_traffic(s, r, a.seed)[1]:
                p, o = states[s.device_id]
                held[s.device_id] = [t.detach().clone() for t in (
                    tree_leaves(p) + tree_leaves(o["m"]) +
                    tree_leaves(o["v"]) + tree_leaves(o.get("v_scale", {})))]
        return own_select(fl, a, r)

    aggs = _AggregateCheck(S)
    AF._device_init, AF.train_round, AF.selected_devices = (
        keep_state, record_round, at_round_start)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    try:
        ups, rep = AF.train_fleet_async(slow, corpus, acfg,
                                        state_policy="int8", **run)
        torch.cuda.synchronize()
        offline_still(STRAG_ROUNDS)
    finally:
        AF._device_init, AF.train_round, AF.selected_devices = (
            own_init, own_round, own_select)
        aggs.restore()
    t_strag = time.perf_counter() - t0
    strag_peak = torch.cuda.max_memory_allocated() / 1e9
    add(_fleet_launches(kd_ops, ups, slow, "straggler"))
    rows = [{k: v for k, v in r.items() if k != "comm_bytes"}
            for r in rep["rounds"]]
    if rows != want_rows or rep["lost_reports"] != want_lost:
        fail(f"straggler rounds {rep['rounds']} lost {rep['lost_reports']}, "
             f"predicted {want_rows} lost {want_lost}")
    for u in ups:
        d = u["device_id"]
        if len(u["losses"]) != STRAG_K * len(online_rounds[d]):
            fail(f"device {d}: {len(u['losses'])} losses, online in rounds "
                 f"{online_rounds[d]}")
        got = [st for dd, st in starts if dd == d]
        if got != [STRAG_K * i for i in range(len(online_rounds[d]))]:
            fail(f"device {d}: rounds started at steps {got}, online in "
                 f"rounds {online_rounds[d]}")
        if not all(math.isfinite(x) for x in u["losses"]):
            fail(f"device {d}: non-finite losses {u['losses']}")
    if not unchanged or not all(same for _, _, same in unchanged):
        fail(f"offline devices' state changed in their round: {unchanged}")
    if not aggs.worst <= 1.0:
        fail(f"an aggregate misses its closed form by {aggs.worst} limits")
    if not aggs.undiscounted or min(aggs.undiscounted) <= 1.0:
        fail(f"merges without the staleness discount would pass: "
             f"{aggs.undiscounted}")
    strag = {"rounds": rep["rounds"], "lost_reports": rep["lost_reports"],
             "staleness_hist": rep["staleness_hist"],
             "merges_staleness": aggs.merges,
             "aggregate_err_over_limit": aggs.worst,
             "undiscounted_err_over_limit": aggs.undiscounted,
             "offline_device_rounds_unchanged": len(unchanged),
             "device_steps": sum(len(u["losses"]) for u in ups),
             "wall_s": t_strag, "peak_gb": strag_peak,
             "losses": {u["device_id"]: u["losses"] for u in ups}}
    print("fleet straggler " + json.dumps(strag))
    del ups, rep, states, held
    torch.cuda.empty_cache()

    # (c) the resident fleet state, fp32 against int8 moments
    mem = [_fleet_memory(AF, Dv, S, fleet, corpus, p) for p in ("", "int8")]
    print(f"fleet memory ({CARD}) " + json.dumps(mem))

    # the launcher's fleet smoke, in process
    out = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(out):
        rc = TL.main(FLEET_CLI)
    torch.cuda.synchronize()
    c = _counts()
    for line in out.getvalue().splitlines():
        if line.startswith(("async fleet", "check-sync", "CHECK-SYNC")):
            print("fleet launcher: " + line)
    if rc != 0 or "check-sync OK" not in out.getvalue():
        fail(f"launch/train.py {' '.join(FLEET_CLI)} exited {rc}")
    if not (c["flash_attention"] and c["kd_loss"]):
        fail(f"the launcher's fleet launched {c}")
    add(c)
    return launches


# ---------------------------------------------------------------------------
# phase 11b: the federated pipeline over ranks (an NCCL group of one rank)
# ---------------------------------------------------------------------------

# Phase III on the server's (1, 1) mesh, the MoE forced onto a2a, and the
# same tune at mesh=None.  mesh=None's kernel path sizes an expert's
# buffer at twice the mean load, a2a at capacity_factor times it aligned
# to 8 rows: at factor 2.0 and 4 x 960 rows (T k / E = 256) both are 512
# slots, and both rank a call's assignments alike, so they drop the same
# ones and compute one function (the f32 check; at 4 x 1024 rows, 548
# against 552 slots, the first reading dropped other assignments and
# missed by 3.6e-2).
FS_CF = 2.0
FS_STEPS = 4                 # bf16 tune steps at TUNE_LAYERS, each path
FS_F32_LAYERS, FS_F32_STEPS, FS_F32_SEQ = 2, 3, 960
FS_EVAL_BATCHES = 1          # evaluate_model: 4 domains x 1 batch 4 x 1024
FS_FLEET_STEPS = 2           # train_fleet steps; the async run 2 rounds x 1
# The f32 check: losses, the clip's grad_norm each step, every leaf and
# evaluate_model's metrics of the mesh run against mesh=None's, relative
# to each quantity's largest |value|.  Reading on an H100 (700 W): 0.0 on
# each, bit for bit (at one rank a2a computes mesh=None's function, with
# the same drops).  The limit leaves the room of f32 sums in another
# order, should a kernel's order change with its buffer's row count.
FS_REL_TOL = 1e-5
# the planted fault (the expert blocks' squares summed twice in the
# clip's norm) must miss the grad_norm limit by this factor; it read
# 4.1e-2, 4,100 limits (the same card)
FS_FAULT_MARGIN = 10.0


class _NormTap:
    """Wraps ``federated.device.adamw_update`` (the tune step's update)
    while in use, collecting each step's clip norm in ``norms``."""

    def __init__(self, Dv):
        self.Dv, self.own, self.norms = Dv, Dv.adamw_update, []

    def __call__(self, *a, **k):
        out = self.own(*a, **k)
        self.norms.append(float(out[2]["grad_norm"]))
        return out

    def __enter__(self):
        self.Dv.adamw_update = self
        return self

    def __exit__(self, *exc):
        self.Dv.adamw_update = self.own


@contextlib.contextmanager
def _norm_twice(AW):
    """A planted fault: the clip's sum over the expert blocks' ranks
    doubled, as if each block were counted on two ranks."""
    own = AW.dist

    def all_reduce(t, *a, **k):
        out = own.all_reduce(t, *a, **k)
        t.mul_(2.0)
        return out

    AW.dist = types.SimpleNamespace(all_reduce=all_reduce)
    try:
        yield
    finally:
        AW.dist = own


@torch.no_grad()
def _max_abs_diff(a, b, chunk=1 << 26):
    """max |a - b| in f32, a chunk of a flattened expert stack at a time
    (a whole stack in f32 is 8.3 GB at 12 layers)."""
    if torch.equal(a, b):
        return 0.0
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(
        a.reshape(-1).split(chunk), b.reshape(-1).split(chunk)))


def _fs_bases(M, base_cfg, dtype):
    return [M.init_params(base_cfg.replace(dtype=dtype), generator=torch.
                          Generator(device="cuda").manual_seed(100 + i))
            for i in range(TUNE_K)]


def _fs_f32_check(S, Dv, M, moe, AW, merge, SIM, corpus, cfg, mesh):
    """The f32 model at FS_F32_LAYERS, 4 x FS_F32_SEQ rows: ``merge_and_
    tune`` on the mesh and at mesh=None (the same drops, counted at 512
    slots), then ``evaluate_model`` of each tuned model (mesh and None),
    held to FS_REL_TOL; the tune again on the mesh with the norm summed
    twice, which must miss the grad_norm limit."""
    from repro_torch.utils.pytree import tree_paths
    c = cfg.replace(n_layers=FS_F32_LAYERS, dtype="float32")
    bases = _fs_bases(M, merge.base_config_of(c), "float32")
    runs = {}
    for tag, on_mesh, fault in (("none", False, False), ("mesh", True, False),
                                ("fault", True, True)):
        cc = c.replace(moe_impl="a2a") if on_mesh else c
        scfg = S.ServerConfig(cc, tune_steps=FS_F32_STEPS,
                              tune_batch=TUNE_BATCH, seq_len=FS_F32_SEQ,
                              seed=0)
        srv = S.DeepFusionServer(scfg, corpus, [], device="cuda",
                                 mesh=mesh if on_mesh else None)
        tap = _RouteTap(moe, ids_only=True)
        with _NormTap(Dv) as norms, tap:
            if fault:
                with _norm_twice(AW):
                    params, losses = srv.merge_and_tune(bases)
            else:
                params, losses = srv.merge_and_tune(bases)
        drops = sum(_dropped(i, c.n_experts) for i in tap.record)
        runs[tag] = (dict(tree_paths(params)), losses, norms.norms, drops)
        if fault:
            del params
            continue
        ev = SIM.evaluate_model(params, cc, corpus,
                                seq_len=FS_F32_SEQ, batch=TUNE_BATCH,
                                n_batches=FS_EVAL_BATCHES,
                                mesh=mesh if on_mesh else None)
        runs[tag] += (ev,)
        del params
    want_p, want_l, want_n, want_d, want_ev = runs["none"]

    def rel(a, b):
        a, b = torch.as_tensor(a, dtype=torch.float64), \
            torch.as_tensor(b, dtype=torch.float64)
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))

    res = {"layers": FS_F32_LAYERS, "steps": FS_F32_STEPS,
           "dropped_assignments": {k: v[3] for k, v in runs.items()}}
    for tag in ("mesh", "fault"):
        p, losses, norms, _ = runs[tag][:4]
        res[tag] = {"losses": losses, "grad_norms": norms,
                    "loss_rel_err": rel(losses, want_l),
                    "grad_norm_rel_err": rel(norms, want_n),
                    "param_rel_err": max(rel(p[k].detach().cpu(),
                                             want_p[k].detach().cpu())
                                         for k in want_p)}
    ev = runs["mesh"][4]
    res["mesh"]["eval_rel_err"] = max(
        abs(ev[k] - want_ev[k]) / max(abs(want_ev[k]), 1e-300)
        for k in want_ev if k.startswith(("logppl", "log_ppl", "acc")))
    res["none"] = {"losses": want_l, "grad_norms": want_n,
                   "log_ppl": want_ev["log_ppl"]}
    print(f"federated_sharded f32 check ({CARD}) " + json.dumps(res))
    if len({v[3] for v in runs.values()}) != 1:
        fail(f"federated_sharded f32: assignments dropped "
             f"{res['dropped_assignments']}: the paths differ")
    worst = max(res["mesh"][k] for k in ("loss_rel_err", "grad_norm_rel_err",
                                         "param_rel_err", "eval_rel_err"))
    if not worst <= FS_REL_TOL:
        fail(f"federated_sharded f32: the mesh run misses mesh=None's by "
             f"{worst} > {FS_REL_TOL}: {res['mesh']}")
    if not res["fault"]["grad_norm_rel_err"] > FS_FAULT_MARGIN * FS_REL_TOL:
        fail(f"federated_sharded f32: the clip's norm summed twice moves "
             f"grad_norm by only {res['fault']['grad_norm_rel_err']}")
    return res


def _fs_tune_bf16(S, M, merge, moe, corpus, cfg, mesh):
    """The bf16 model at TUNE_LAYERS through ``merge_and_tune``, mesh=None
    then the mesh (its launches counted from 0, the main path): ms a step,
    peak memory, drops, the two runs' distance, frozen experts unchanged.
    mesh=None's params wait in host memory while the mesh runs, so that
    each peak holds one model (detached: the tune leaves them requiring
    grad, and a copy's graph would keep the card's tensors alive).  Returns (the mesh run's whole params,
    readings, launches)."""
    from repro_torch.kernels.kd_loss import ops as kd_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.utils.pytree import tree_map, tree_paths
    bases = _fs_bases(M, merge.base_config_of(cfg), cfg.dtype)
    out, launches = {}, None
    for tag, m in (("none", None), ("mesh", mesh)):
        scfg = S.ServerConfig(cfg if m is None else cfg.replace(
            moe_impl="a2a"), tune_steps=FS_STEPS, tune_batch=TUNE_BATCH,
            seq_len=TUNE_SEQ, seed=0)
        marks = []

        def on_step(s, loss):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        srv = S.DeepFusionServer(scfg, corpus, [], device="cuda", mesh=m,
                                 on_step=on_step)
        tap = _RouteTap(moe, ids_only=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        with tap:
            params, losses = srv.merge_and_tune(bases)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if m is not None:
            launches = _counts()
            _all_wgmma(kd_ops, "federated_sharded tune")
            _gmm_on_tensor_cores(mg_ops, cfg.n_layers * FS_STEPS,
                                 "federated_sharded tune")
            _gsa_all_vec(md_ops, "federated_sharded tune")
        step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        out[tag] = {"losses": losses, "wall_s": wall, "step_ms": step_ms,
                    "ms_per_step": sorted(step_ms)[len(step_ms) // 2],
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "dropped_per_step": sum(_dropped(i, cfg.n_experts)
                                            for i in tap.record) / 2
                    / FS_STEPS}
        if not all(math.isfinite(x) for x in losses):
            fail(f"federated_sharded bf16 {tag}: non-finite losses {losses}")
        _check_merge(params, bases, cfg)
        out[tag]["params"] = params if m is not None else tree_map(
            lambda t: t.detach().cpu(), params)
        del srv, params
    params = out["mesh"].pop("params")
    a, b = dict(tree_paths(params)), dict(tree_paths(out["none"].pop(
        "params")))
    out["max_param_abs_diff"] = max(_max_abs_diff(a[k], b[k].cuda())
                                    for k in b)
    out["max_loss_abs_diff"] = max(abs(x - y) for x, y in zip(
        out["mesh"]["losses"], out["none"]["losses"]))
    out["step_ratio"] = out["mesh"]["ms_per_step"] / out["none"]["ms_per_step"]
    L, n = cfg.n_layers, FS_STEPS
    want = {"flash_attention": 2 * L * n,
            "kd_loss": 2 * (TUNE_SEQ // cfg.loss_chunk) * n,
            "gather_scatter_add": 6 * L * n, "grouped_ffn": 2 * L * n,
            "grouped_matmul": 7 * L * n, "split_f32": 3 * L * n}
    got = {k: launches[k] for k in want}
    if got != want or any(v for k, v in launches.items() if k not in want):
        fail(f"federated_sharded tune launches {launches}, expected {want}")
    return params, out, got


def _fs_fleet(AF, Dv, S, SIM, LM):
    """The fleet phase's fleet on ``make_fleet_mesh(1)`` over NCCL and at
    mesh=None: ``train_fleet`` and straggler ``train_fleet_async`` rounds,
    uploads (and aggregates) bit for bit.  Returns (readings, the mesh
    runs' launches)."""
    from repro_torch.utils.pytree import tree_leaves
    own, fam, moe_cfg, sim, _ = _pipeline_configs()
    corpus = SIM.build_corpus(sim)
    fleet = SIM.build_fleet(sim, corpus, fam)
    slow = SIM.build_fleet(sim, corpus, fam, traffic="harsh")
    fmesh = LM.make_fleet_mesh(1, device="cuda")
    if tuple(fmesh.mesh_dim_names) != ("hosts",) or fmesh.size() != 1:
        fail(f"fleet mesh {fmesh}")
    run = dict(batch=PIPE_BATCH, seq_len=PIPE_SEQ, seed=0, device="cuda")
    acfg = S.AsyncFleetConfig(rounds=2, steps_per_round=1,
                              participation=STRAG_PARTICIPATION,
                              deadline_s=STRAG_DEADLINE_S,
                              deadline_policy="stale", seed=STRAG_SEED)
    res, launches = {}, dict.fromkeys(_counts(), 0)
    for what in ("sync", "async"):
        ups = {}
        for tag, m in (("none", None), ("mesh", fmesh)):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            if what == "sync":
                ups[tag] = (Dv.train_fleet(fleet, corpus,
                                           steps=FS_FLEET_STEPS, mesh=m,
                                           **run), None)
            else:
                ups[tag] = AF.train_fleet_async(slow, corpus, acfg, mesh=m,
                                                **run)
            torch.cuda.synchronize()
            res[f"{what}_{tag}_wall_s"] = time.perf_counter() - t0
            if m is not None:
                for k, v in _counts().items():
                    launches[k] += v
        diff = _first_difference(ups["mesh"][0], ups["none"][0])
        if diff:
            fail(f"federated_sharded fleet {what}: the mesh run differs "
                 f"from mesh=None's at {diff}")
        if what == "async":
            rep, rep0 = ups["mesh"][1], ups["none"][1]
            if rep["n_hosts"] != 1 or rep["rounds"] != rep0["rounds"]:
                fail(f"federated_sharded fleet async: report {rep['n_hosts']} "
                     f"hosts, rounds {rep['rounds']} vs {rep0['rounds']}")
            for k in rep0["aggregates"]:
                if not all(torch.equal(x, y) for x, y in zip(
                        tree_leaves(rep["aggregates"][k]),
                        tree_leaves(rep0["aggregates"][k]))):
                    fail(f"federated_sharded fleet async: aggregate {k} "
                         "differs from mesh=None's")
            res["async_rounds"] = rep["rounds"]
        res[f"{what}_device_steps"] = sum(len(u["losses"])
                                          for u in ups["mesh"][0])
        del ups
    res["uploads_bit_equal"] = True
    return res, launches


def phase_federated_sharded():
    """The federated pipeline over ranks on an NCCL group of one rank (the
    card holds one), sharing serve_sharded's group: (a) Phase III through
    ``DeepFusionServer(mesh=(1, 1))`` with the MoE forced onto a2a
    (Qwen1.5-MoE-A2.7B at full width, TUNE_LAYERS layers, 4 x 1024 tokens,
    capacity factor FS_CF), the f32 model at FS_F32_LAYERS held to
    mesh=None's tune (losses, grad_norm, every leaf; the norm summed twice
    must break it), the bf16 model's step against mesh=None's (ms, peak,
    the NCCL kernels' device time in a profiled step); (b)
    ``evaluate_model(mesh=)`` against mesh=None's (f32 held, bf16
    reported); (c) the fleet phase's fleet through ``train_fleet`` and
    ``train_fleet_async`` on ``make_fleet_mesh(1)``, uploads bit-equal to
    mesh=None's.  Returns the mesh runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import merge, tuning
    from repro_torch.data.federated import FederatedCorpus
    from repro_torch.federated import async_fleet as AF
    from repro_torch.federated import device as Dv
    from repro_torch.federated import server as S
    from repro_torch.federated import simulation as SIM
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import adamw as AW
    mesh = _nccl_mesh()
    cfg = get_config("qwen2-moe-a2.7b", variant="full").replace(
        n_layers=TUNE_LAYERS, capacity_factor=FS_CF, moe_impl="a2a")
    if moe.moe_path(cfg, mesh) != "a2a" or \
            moe.moe_path(cfg.replace(moe_impl="auto"), mesh) != "dense":
        fail("federated_sharded: the (1, 1) mesh does not take a2a when "
             "forced, or auto takes it")
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    # (a) the f32 check, then the bf16 main path; mesh=None's config keeps
    # "auto" (dense), the mesh's is forced onto a2a
    f32 = _fs_f32_check(S, Dv, M, moe, AW, merge, SIM, corpus,
                        cfg.replace(moe_impl="auto"), mesh)
    torch.cuda.empty_cache()
    whole, tune, launches = _fs_tune_bf16(
        S, M, merge, moe, corpus, cfg.replace(moe_impl="auto"), mesh)
    print(f"federated_sharded tune bf16 ({CARD}) " + json.dumps(tune))
    # (b) evaluate_model of the bf16 tuned model, mesh=None then the mesh
    evals = {}
    for tag, c, m in (("none", cfg.replace(moe_impl="auto"), None),
                      ("mesh", cfg, mesh)):
        _zero_counts()
        t0 = time.perf_counter()
        evals[tag] = SIM.evaluate_model(whole, c, corpus, seq_len=TUNE_SEQ,
                                        batch=TUNE_BATCH,
                                        n_batches=FS_EVAL_BATCHES, mesh=m)
        evals[f"{tag}_wall_s"] = time.perf_counter() - t0
        if m is not None:
            for k, v in _counts().items():
                launches[k] = launches.get(k, 0) + v
        if not all(math.isfinite(v) for v in evals[tag].values()):
            fail(f"federated_sharded eval {tag}: {evals[tag]}")
    evals["log_ppl_abs_diff"] = abs(evals["mesh"]["log_ppl"]
                                    - evals["none"]["log_ppl"])
    print(f"federated_sharded eval bf16 ({CARD}) " + json.dumps(evals))
    # one more step on the mesh under the profiler (NCCL's device time),
    # after the evaluation: at one rank shard_experts returns whole's own
    # tensors, which the step updates in place
    mask, opt = tuning.init_tuning(whole)
    p = moe.shard_experts(whole, cfg, mesh)
    opt = moe.shard_opt_state(opt, cfg, mesh)
    step = tuning.make_tune_step(cfg, mask, mesh=mesh)
    b = {k: v.cuda() for k, v in corpus.mixed_eval_batch(
        TUNE_BATCH, TUNE_SEQ, seed_salt=78).items()}
    prof = profile(lambda: step(p, opt, b, 5e-4), top=8,
                   groups={"nccl": ("nccl",),
                           "kernels 4-5": ("ffn_", "gmm_", "split_kernel"),
                           "kernel 6": ("gsa_",)})
    del opt, step, p
    if not prof["group_launches"]["nccl"]:
        fail("federated_sharded: the profiled mesh step launched no NCCL "
             "kernel")
    print("federated_sharded profile (a2a tune step) " + json.dumps(prof))
    del whole
    torch.cuda.empty_cache()
    # (c) the fleet over a one-host fleet mesh
    fleet, fl = _fs_fleet(AF, Dv, S, SIM, LM)
    print(f"federated_sharded fleet ({CARD}) " + json.dumps(fleet))
    for k, v in fl.items():
        launches[k] = launches.get(k, 0) + v
    print("federated_sharded launches " + json.dumps(launches))
    return launches


KERNELS = {
    "kd_loss": {
        "route": "cuda", "source": "src/repro_torch/csrc/kd_loss.cu",
        "replaces": "src/repro/kernels/kd_loss/kernel.py:163"},
    # the same kernel in KD mode (a teacher's logits beside the student's)
    "kd_loss_kd": {
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
    # chunked admission: the paged kernel with CHUNK_LEN query rows a slot
    "paged_attn_chunk": {
        "route": "cuda", "source": "src/repro_torch/csrc/paged_attn.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:159"},
    # chunked admission: the scan from a carried state (init_state)
    "ssd_scan_h0": {
        "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:91"},
    # the encoder-decoder family's encoder: kernel 1 with causal=False
    "flash_attention_bidir": {
        "route": "cuda", "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:108"},
}

# the path phases, in the order they run
PATHS = (phase_serve, phase_serve_kv, phase_serve_ssm, phase_serve_moe,
         phase_serve_hybrid, phase_serve_mla, phase_serve_gemma,
         phase_serve_encdec, phase_train, phase_train_ssm, phase_train_hybrid,
         phase_train_mla, phase_train_encdec, phase_tune, phase_distill,
         phase_pipeline, phase_methods, phase_fleet,
         phase_federated_sharded,
         # last: run before the train phases, it left train_mla (75.3 GB
         # at its peak on a 79.2 GiB card) out of memory twice on the H100,
         # though PyTorch had freed all it allocated and the NCCL group
         # was destroyed
         phase_serve_sharded)


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
    t_start = time.perf_counter()
    name = phase_card()
    phase_build()
    t0 = time.perf_counter()
    rows = phase_kernels()
    print(f"phase kernels: {time.perf_counter() - t0:.1f}s")
    # launches: the counts of every path run that drives the kernel; each
    # phase's wall time, so that the script's growth stays visible
    paths = []
    for run in PATHS:
        t0 = time.perf_counter()
        paths.append(run())
        wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"phase {run.__name__[6:]}: {wall:.1f}s (then "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
              f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved, "
              f"{(total - free) / 2**30:.3f} GiB of the card in use)")
    import torch.distributed as dist
    if dist.is_initialized():      # the NCCL group of the sharded phases
        dist.destroy_process_group()
    launches = {k: sum(path.get(k, 0) for path in paths) for k in KERNELS}
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
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
