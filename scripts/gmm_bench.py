#!/usr/bin/env python3
"""Times the grouped-matmul kernel (kernel 5) on one GPU, and checks it.

  PYTHONPATH=src python3 scripts/gmm_bench.py [--src DIR] [--check]

Times, at the tune path's shapes (E 60, C 548, D 2048, F 1408, bf16
model), each product of the grouped FFN's backward as that checkout's
backward forms it: x@wg and dy@wo^T (bf16 operands, f32 out), dx =
dg@wg^T + du@wu^T, x^T@dg and h^T@dy (dg, du and h f32), then the split
pass and one layer's whole backward (``grouped_ffn``'s, every product
and the gated activation's VJP).  CUDA events with L2 flushed before
each call, as ``chip_smoke.py`` times kernels.  A checkout whose
``grouped_matmul`` predates split operands (a parent) gets the f32
operands as they are, dx as two launches and a sum, and the weight
gradients and dx written in f32 and cast, as its backward does; the
change gets its f32 operands split beforehand (the split timed apart)
and writes them in bf16.  ``--src`` imports the port from another
checkout's ``src`` (a parent commit, for a comparison in one call).
``--check`` first runs ``chip_smoke.py``'s grouped-matmul cases.
Prints one JSON line per reading.
"""
import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, C, D, F = 60, 548, 2048, 1408


def timings(tag):
    import chip_smoke as cs
    from repro_torch.kernels.moe_gemm import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    new = hasattr(ops, "split_f32")

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)
    x, dy = rnd((E, C, D), 1, bf), rnd((E, C, D), 1, bf)
    wg, wu = rnd((E, D, F), D ** -0.5, bf), rnd((E, D, F), D ** -0.5, bf)
    wo = rnd((E, F, D), F ** -0.5, bf)
    dg, du, h = (rnd((E, C, F), 1, f32) for _ in range(3))
    tr = lambda t: t.transpose(1, 2)  # noqa: E731
    gmm = ops.grouped_matmul
    if new:
        sdg, sdu, sh = ops.split_f32(dg), ops.split_f32(du), ops.split_f32(h)
        runs = {
            "x@wg": lambda: gmm(x, wg),
            "dy@wo^T": lambda: gmm(dy, tr(wo)),
            "dg@wg^T+du@wu^T": lambda: gmm(sdg, tr(wg), out_dtype=bf,
                                           plus=(sdu, tr(wu))),
            "x^T@dg": lambda: gmm(tr(x), sdg, out_dtype=bf),
            "h^T@dy": lambda: gmm(tr(sh), dy, out_dtype=bf),
            "split_f32": lambda: ops.split_f32(dg)}
    else:
        def dx():
            out = gmm(dg, tr(wg))
            out += gmm(du, tr(wu))
            return out.to(bf)
        runs = {
            "x@wg": lambda: gmm(x, wg),
            "dy@wo^T": lambda: gmm(dy, tr(wo)),
            "dg@wg^T+du@wu^T": dx,
            "x^T@dg": lambda: gmm(tr(x), dg).to(bf),
            "h^T@dy": lambda: gmm(tr(h), dy).to(bf)}
    # bytes: each input once (f32 operands as f32), each output once in
    # the dtype the backward keeps; products at the bf16 rate
    nb = {"x@wg": (x, wg, C * F * E * 4), "dy@wo^T": (dy, wo, C * F * E * 4),
          "dg@wg^T+du@wu^T": (dg, du, wg, wu, C * D * E * 2),
          "x^T@dg": (x, dg, D * F * E * 2), "h^T@dy": (h, dy, F * D * E * 2)}
    flops = 2 * E * C * D * F
    for name, fn in runs.items():
        if name == "split_f32":
            bound = cs.bound_ms(dg.numel() * 8, 0, f32)
        else:
            *ts, out_bytes = nb[name]
            bound = cs.bound_ms(cs._nbytes(*ts) + out_bytes,
                                flops * (2 if name.startswith("dg") else 1),
                                bf)
        before = dict(getattr(ops, "LAUNCHES_BY_INSTANCE", {}))
        fn()
        by = {k: v - before[k] for k, v in
              getattr(ops, "LAUNCHES_BY_INSTANCE", {}).items()
              if v != before[k]}
        print("timed", json.dumps({
            "src": tag, "product": name, "instance": by or "gmm_kernel",
            "ms": cs.time_ms(fn), "bound_ms": bound[0],
            "bound_by": bound[1]}), flush=True)
    del runs, dg, du, h
    if new:
        del sdg, sdu, sh
    torch.cuda.empty_cache()

    # one layer's backward, as grouped_ffn runs it
    args = [t.clone().requires_grad_(True) for t in (x, wg, wu, wo)]
    y = ops.grouped_ffn(*args)

    def backward():
        return torch.autograd.grad(y, args, dy, retain_graph=True)
    print("timed", json.dumps({
        "src": tag, "product": "layer backward (grouped_ffn)",
        "ms": cs.time_ms(backward, iters=10)}), flush=True)


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
        gen = torch.Generator(device="cuda").manual_seed(0)
        _, gmm, split, _ = cs.moe_cases(gen)
        for row in gmm + split:
            print("checked", json.dumps(row), flush=True)
    timings(a.src)


if __name__ == "__main__":
    main()
