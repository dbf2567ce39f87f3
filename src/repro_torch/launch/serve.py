"""Serving launcher of the port: continuous batching on the card.

Thin client of ``repro_torch.serve`` with the CLI of ``repro.launch.serve``.
Weights are random, drawn from ``--seed`` (the same on every rank), which
also keys the requests' random streams.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --variant full --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --variant reduced --device cpu --mixed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
      --variant full --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --variant full --paged --kv-dtype int8 --check-unquantized
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b \\
      --variant reduced --device cpu --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --variant full --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --variant reduced --device cpu --mixed --bucket --chunk-len 4 \\
      --check-unbucketed

``--arch`` takes every ported architecture (``configs/registry.py``):
the dense ``tinyllama-1.1b`` and ``starcoder2-3b``, the gemma family
``gemma2-9b`` and ``gemma2-27b`` (local/global windows, both logit
softcaps), the VLM ``paligemma-3b`` (each request carries stub patch
embeddings, seeded normal x 0.05 in the model's dtype, as the
reference's ``prompt_batch`` draws them), the encoder-decoder
``whisper-small`` (stub audio frames drawn the same way, read by the
encoder; the decoder serves the prompt), the MoEs
``qwen2-moe-a2.7b`` and ``deepseek-moe-16b`` (its leading dense layer
included), ``deepseek-v3-671b`` (MLA's latent cache, read through the
block-table gather), ``mamba2-1.3b``, ``zamba2-7b`` and the on-device
families.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
      --variant reduced --device cpu --paged --mixed --bucket \
      --check-unbucketed

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --variant reduced --device cpu --paged

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --device cpu --paged --kv-dtype int8 \
      --bucket --chunk-len 4 --check-unbucketed

Sampling: ``--temperature t`` samples from softmax(logits / t),
``--top-k k`` from the k most likely tokens (at ``--temperature``, 1.0 by
default); greedy otherwise.  Speculative decode: ``--speculate`` drafts
``--n-draft`` tokens a step with the model's MTP head (DeepSeek-V3 has
one; the other families' configs none) and verifies them in one chunk;
``--check-unspeculated`` replays the traffic without it and fails unless
the completions match (greedy: token for token).

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --device cpu --paged --speculate \
      --n-draft 3 --check-unspeculated
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --device cpu --paged --mixed --top-k 40 --temperature 0.8

Sharded serving: ``--sharded`` serves on the decode mesh (``launch/mesh.py``)
over every rank: ranks come from ``torchrun``'s ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` (one rank without them), NCCL on the card, gloo on the
CPU; the MoEs take the expert-parallel a2a path on more than one rank,
and only rank 0 prints.  ``--overlap-a2a`` runs a contiguous MoE decode
step as two batch halves; ``--check-unsharded`` replays the traffic with
``mesh=None`` and the overlap off and fails unless the completions
match.

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen2-moe-a2.7b --variant reduced --device cpu --sharded \
      --check-unsharded --paged
"""
from __future__ import annotations

import argparse
import builtins
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.layers import paged_read_path
from repro_torch.serve import (Greedy, PagedServeEngine, ServeEngine,
                               Temperature, TopK)
from repro_torch.sharding import rules
from repro_torch.utils.device import resolve_device


def pick_sampler(args):
    """The reference's choice: top-k, else temperature, else greedy."""
    if args.top_k:
        return TopK(args.top_k, args.temperature or 1.0)
    if args.temperature:
        return Temperature(args.temperature)
    return Greedy()


def mixed_lengths(n: int, prompt_len: int, gen: int):
    """Demo traffic: request i gets a shorter prompt + generation."""
    return [(max(4, prompt_len - 4 * i), max(2, gen - 3 * i))
            for i in range(n)]


def prompt_batch(cfg, rng, prompt_len: int):
    """One request's batch: ``prompt_len`` random tokens and, for the VLM
    family, stub patch embeddings (the encoder-decoder family: stub audio
    frames) (1, frontend_tokens, d_model), normal x 0.05 in the model's
    dtype, drawn after the tokens from ``rng``."""
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, prompt_len))}
    key = M.frontend_key(cfg)
    if key is not None:
        rows = rng.normal(size=(1, cfg.frontend_tokens, cfg.d_model))
        batch[key] = torch.as_tensor(rows * 0.05).to(M._dtype(cfg))
    return batch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="reduced", choices=["full", "reduced"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seg-len", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=512,
                    help="vocab size of the reduced variant")
    ap.add_argument("--mixed", action="store_true",
                    help="vary prompt/gen length per request")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the block-paged KV engine")
    ap.add_argument("--block-len", type=int, default=16,
                    help="paged engine: tokens per KV block")
    ap.add_argument("--blocks", type=int, default=0,
                    help="paged engine: pool size (0 = worst-case default)")
    ap.add_argument("--eager-blocks", action="store_true",
                    help="paged engine: reserve a request's worst-case "
                         "blocks at admission instead of lazily")
    ap.add_argument("--kv-dtype", default="",
                    choices=["", "fp32", "bf16", "fp8", "int8"],
                    help="KV-cache storage policy: int8/fp8 quantize cache "
                         "rows with per-position scales (models/quant.py)")
    ap.add_argument("--check-unquantized", action="store_true",
                    help="replay the same traffic at full precision and "
                         "fail unless greedy completions match")
    ap.add_argument("--bucket", action="store_true",
                    help="bucketed chunked-prefill admission: prompts "
                         "padded up a ladder, prefilled in chunks")
    ap.add_argument("--chunk-len", type=int, default=4,
                    help="bucketed admission: tokens per prefill chunk")
    ap.add_argument("--buckets", default="",
                    help="comma-separated bucket ladder (default: "
                         "powers-of-two chunk multiples)")
    ap.add_argument("--check-unbucketed", action="store_true",
                    help="replay the same traffic through the unbucketed "
                         "engine and fail unless completions match")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample from softmax(logits / t) (0: greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="sample from the k most likely tokens")
    ap.add_argument("--speculate", action="store_true",
                    help="self-speculative MTP decode: draft and verify "
                         "--n-draft tokens a step (needs an MTP head)")
    ap.add_argument("--n-draft", type=int, default=3,
                    help="speculative decode: drafts a step")
    ap.add_argument("--check-unspeculated", action="store_true",
                    help="replay the same traffic without speculation and "
                         "fail unless completions match")
    ap.add_argument("--sharded", action="store_true",
                    help="serve on the decode mesh (data x model over every "
                         "rank) instead of one device")
    ap.add_argument("--overlap-a2a", action="store_true",
                    help="MoE decode: run the step as two batch halves "
                         "around the expert all-to-all")
    ap.add_argument("--check-unsharded", action="store_true",
                    help="replay the same traffic single-device (mesh=None, "
                         "overlap off) and fail unless completions match")
    args = ap.parse_args(argv)
    if args.check_unquantized and args.kv_dtype not in ("int8", "fp8"):
        ap.error("--check-unquantized requires a quantized --kv-dtype")
    if args.buckets and not args.bucket:
        ap.error("--buckets requires --bucket")
    if args.check_unbucketed and not args.bucket:
        ap.error("--check-unbucketed requires --bucket")
    if args.check_unspeculated and not args.speculate:
        ap.error("--check-unspeculated requires --speculate")
    if args.check_unsharded and not args.sharded:
        ap.error("--check-unsharded requires --sharded")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh, started = None, False
    if args.sharded:
        started = LM.init_process_group(device)
        device = LM.local_device(device)
        mesh = LM.make_decode_mesh(device=device.type)
    try:
        return _serve(args, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _serve(args, device, mesh):
    """The traffic through the engine(s) on ``device``; only rank 0 of a
    mesh prints."""
    print = (builtins.print if mesh is None or dist.get_rank() == 0
             else (lambda *a, **k: None))
    cfg = get_config(args.arch, variant=args.variant)
    if args.variant == "reduced":
        cfg = cfg.replace(vocab_size=args.vocab)
    if args.overlap_a2a:
        cfg = cfg.replace(overlap_a2a=True)
    rng = np.random.default_rng(args.seed)
    P, G = args.prompt_len, args.gen
    lengths = (mixed_lengths(args.requests, P, G) if args.mixed
               else [(P, G)] * args.requests)
    # caches sized exactly: prompt + max_new, no +1
    max_len = max(M.decode_capacity(cfg, p, g) for p, g in lengths)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, generator=gen)
    kw = dict(n_slots=args.slots, max_len=max_len,
              sampler=pick_sampler(args), seg_len=args.seg_len,
              device=device, seed=args.seed)
    bucket_kw = {}
    if args.bucket:
        bucket_kw["chunk_len"] = args.chunk_len
        if args.buckets:
            bucket_kw["buckets"] = [int(b) for b in args.buckets.split(",")]

    def make_engine(kv_dtype, bucketed=True, speculate=args.speculate,
                    mesh=mesh, cfg=cfg):
        bkw = dict(bucket_kw if bucketed else {})
        if speculate:
            bkw["speculate"] = args.n_draft
        if args.paged:
            eng = PagedServeEngine(params, cfg, block_len=args.block_len,
                                   n_blocks=args.blocks or None,
                                   lazy=not args.eager_blocks,
                                   kv_dtype=kv_dtype, mesh=mesh, **kw, **bkw)
        else:
            eng = ServeEngine(params, cfg, kv_dtype=kv_dtype, mesh=mesh,
                              **kw, **bkw)
        for batch, (_, g) in zip(prompts, lengths):
            eng.submit(batch, max_new=g)
        return eng

    prompts = [prompt_batch(cfg, rng, p) for p, _ in lengths]
    engine = make_engine(args.kv_dtype)
    if device.type == "cuda":
        # build (or load) the kernels before the clock starts, so the
        # tok/s below times serving, not nvcc
        from repro_torch.kernels import _build
        _build.build_all()
        print(f"kernels: {_build.BUILD_INFO['seconds']:.1f}s "
              f"({'cached' if _build.BUILD_INFO['cached'] else 'built'})")
    t0 = time.perf_counter()
    comps = engine.run()
    dt = time.perf_counter() - t0
    st = engine.stats
    n_tok = st["generated_tokens"]
    util = st["live_slot_steps"] / max(st["slot_steps"], 1)
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    print(f"{args.arch} ({args.variant}) on {dev_name}: {len(comps)} "
          f"requests, {n_tok} tokens in {dt:.2f}s ({n_tok / dt:.1f} tok/s, "
          f"{st['segments']} segments, slot util {util:.0%})")
    if args.bucket:
        print(f"bucketed: chunk_len={engine.chunk_len} "
              f"ladder={list(engine.buckets)} admit_s={st['admit_s']:.3f}")
    if args.paged:
        read_path = (paged_read_path(cfg, cfg.attn_type)
                     if M.has_paged_leaves(cfg)
                     else "none, the state is per slot")
        print(f"paged: block_len={engine.block_len} pool={engine.n_blocks} "
              f"peak_blocks={st['peak_live_blocks']} "
              f"shared={st['shared_blocks']} "
              f"lazy_claimed={st['lazy_claimed_blocks']} "
              f"preemptions={st['preemptions']} "
              f"(free after drain: {engine.alloc.n_free}, "
              f"read path: {read_path})")
    if args.kv_dtype:
        cache_bytes = (M.paged_cache_nbytes(cfg, args.slots, engine.n_blocks,
                                            engine.block_len,
                                            policy=engine.policy)
                       if args.paged else
                       M.cache_nbytes(cfg, args.slots, max_len,
                                      policy=engine.policy))
        print(f"kv-dtype: {args.kv_dtype} cache_bytes={cache_bytes}")
    first = comps[min(comps)]
    print("sample:", first.tokens[:16])
    if args.speculate:
        print(f"speculative: n_draft={args.n_draft} "
              f"acceptance={engine.spec_acceptance():.1%} "
              f"({st['spec_extra_tokens']} extra tokens over "
              f"{st['spec_steps']} live steps)")
    if args.check_unquantized:
        want = {u: c.tokens.tolist() for u, c in make_engine("").run().items()}
        got = {u: c.tokens.tolist() for u, c in comps.items()}
        if got != want:
            raise SystemExit(f"{args.kv_dtype} completions diverged from "
                             f"full precision: {got} != {want}")
        print(f"check-unquantized: {args.kv_dtype} completions match full "
              f"precision")
    if args.check_unbucketed:
        # the same layout and KV policy, one-shot prefill admission
        ref = make_engine(args.kv_dtype, bucketed=False)
        want = {u: c.tokens.tolist() for u, c in ref.run().items()}
        got = {u: c.tokens.tolist() for u, c in comps.items()}
        if got != want:
            raise SystemExit(f"bucketed completions diverged from "
                             f"unbucketed: {got} != {want}")
        print(f"check-unbucketed: completions match (admit_s "
              f"{st['admit_s']:.3f} bucketed, {ref.stats['admit_s']:.3f} "
              f"unbucketed)")
    if args.check_unspeculated:
        # the same layout, admission and KV policy, no drafts
        ref = make_engine(args.kv_dtype, speculate=False)
        want = {u: c.tokens.tolist() for u, c in ref.run().items()}
        got = {u: c.tokens.tolist() for u, c in comps.items()}
        if got != want:
            raise SystemExit(f"speculative completions diverged from "
                             f"unspeculated: {got} != {want}")
        print("check-unspeculated: completions match")
    if args.sharded:
        path = moe.moe_path(cfg, mesh) if cfg.is_moe else "no MoE"
        print(f"sharded: mesh={dict(rules.as_abstract(mesh).shape)} "
              f"moe path={path} overlap_a2a={cfg.overlap_a2a}"
              + (f" allocator shards={engine.alloc.n_shards}" if args.paged
                 else ""))
    if args.check_unsharded:
        # the same layout, admission and KV policy on one device
        ref = make_engine(args.kv_dtype, mesh=None,
                          cfg=cfg.replace(overlap_a2a=False))
        want = {u: c.tokens.tolist() for u, c in ref.run().items()}
        got = {u: c.tokens.tolist() for u, c in comps.items()}
        if got != want:
            raise SystemExit(f"sharded completions diverged from "
                             f"single-device: {got} != {want}")
        print("check-unsharded: completions match")
    return comps


if __name__ == "__main__":
    main()
