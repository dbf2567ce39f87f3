#!/usr/bin/env python3
"""Times the paged-attention kernel on one GPU, and checks it.

  PYTHONPATH=src python3 scripts/paged_bench.py [--src DIR] [--check]

Times (CUDA events, L2 flushed before each call, as ``chip_smoke.py``
times kernels; also with L2 warm) at the serve path's shape (8 slots,
ctx 64-1088, H 32 over KH 4, D 64, block_len 16, C 1) and at 8 slots x
ctx 4096, bf16 and int8 pools; the serve shape also with every slot at
ctx 1 (the kernel's fixed chain of round trips), and, where the package
splits the context, for several split targets (``BLOCKS_PER_SM``) and
unsplit.  A one-element ``zero_`` timed the same way gives the floor of
the method.  ``--src`` imports the port from another checkout's ``src``
(a parent commit, for a comparison in one call).  ``--check`` first
holds every pool dtype and head dim against the plain version under
``chip_smoke.py``'s rule, each case launched twice and bit-identical.
Prints one JSON line per reading.
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(gen, ctx, kv):
    import chip_smoke as cs
    from repro_torch.models import quant
    B, H, KH, D, bl = len(ctx), 32, 4, 64, 16
    bt, n_blocks = cs._pool_table(gen, ctx, bl)
    pos = torch.tensor([c - 1 for c in ctx], dtype=torch.int32,
                       device="cuda")
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").bfloat16()
    shape = (n_blocks, bl, KH, D)
    kp, vp = (torch.randn(shape, generator=gen, device="cuda")
              for _ in range(2))
    if kv == "bf16":
        return (q, kp.bfloat16(), vp.bfloat16(), bt, pos), {}
    (kp, ks), (vp, vs) = quant.quantize(kp, kv), quant.quantize(vp, kv)
    return (q, kp, vp, bt, pos), dict(k_scale=ks, v_scale=vs,
                                      out_dtype=torch.bfloat16)


def _warm_ms(fn, iters=50):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timings(tag):
    import chip_smoke as cs
    from repro_torch.kernels.paged_attn import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    one = torch.zeros(1, device="cuda")
    print("timed", json.dumps({"src": tag, "case": "floor: zero_ of 1 float",
                               "ms": cs.time_ms(one.zero_)}))
    serve = [int(c) for c in np.linspace(64, 1088, 8)]
    split = hasattr(ops, "split_plan")
    targets = (1, 2, 4) if split else (None,)
    for name, ctx in (("serve", serve), ("ctx1", [1] * 8),
                      ("long", [4096] * 8)):
        if name == "ctx1":      # the serve table's width, one key a slot
            ctx = [1] * 7 + [1088]
        for kv in ("bf16", "int8"):
            args, kw = _inputs(gen, ctx, kv)
            if name == "ctx1":
                args[4].fill_(0)

            def run():
                return ops.paged_decode_attention(*args, **kw)
            for target in targets + ((0,) if split else ()):
                plan = None
                if split and target:
                    ops.BLOCKS_PER_SM = target
                    plan = ops.split_plan(8, 1, 32, 4, 64,
                                          args[1].element_size(), 16,
                                          args[3].shape[1], 132)
                elif split:       # unsplit: one slice
                    saved = ops.split_plan
                    ops.split_plan = lambda *a: (10 ** 6, 1)
                print("timed", json.dumps({
                    "src": tag, "case": name, "kv": kv, "target": target,
                    "plan": plan, "ms": cs.time_ms(run),
                    "warm_ms": _warm_ms(run)}), flush=True)
                if split and not target:
                    ops.split_plan = saved
    if split:
        ops.BLOCKS_PER_SM = 2


def check():
    import chip_smoke as cs
    from repro_torch.kernels.paged_attn import ops
    bf, f32 = torch.bfloat16, torch.float32
    for dt in (f32, bf, torch.int8, torch.float8_e4m3fn):
        print("config", str(dt), json.dumps(
            {D: ops.kernel_config(dt, D) for D in ops._HEAD_DIMS}))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for D in ops._HEAD_DIMS:
        rows = [cs.paged_case(gen, [4, 70, 300, 130], 1 + 3 * i, 8, 2, D, 16,
                              dt, window=(0, 90)[i])
                for i, dt in enumerate((f32, bf))]
        rows += [cs.paged_quant_case(gen, [4, 70, 300, 130], 2, 8, 2, D, 16,
                                     bf, kv, window=50, softcap=30.0)
                 for kv in ("int8", "fp8")]
        for r in rows:
            print("checked", json.dumps({k: r[k] for k in (
                "case", "err_over_limit")}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--check", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(a.src))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_card()
    from repro_torch.kernels import _build
    _build.build_all()
    if a.check:
        check()
    timings(a.src)


if __name__ == "__main__":
    main()
