#!/usr/bin/env python3
"""Times kernel 6, the MoE token dispatch/combine, on one GPU, and checks it.

  PYTHONPATH=src python3 scripts/gsa_bench.py [--src DIR] [--check]

At the tune path's shapes (Qwen1.5-MoE-A2.7B: 4096 tokens, top-4 of 60
experts, capacity 548, D 2048, bf16), softmax-top-k routing from random
logits (seed 0), with no drops and with expert 0's logit raised by 4.0
(slot 0's segment 1 + drops long):

- the whole Function as a routed layer runs it: the routing's layouts
  (where the checkout has them), dispatch and combine forward, then both
  backwards with the routing weights' gradient, from fixed output
  gradients; CUDA events with L2 flushed before each call, as
  ``chip_smoke.py`` times kernels;
- the split of that call's device time by kernel: torch.profiler over 20
  calls, L2 flushed before each;
- the dispatch and the combine forward alone through
  ``gather_scatter_add_rows`` (each builds its own layout), timed as
  above, and the kernel's device time in each;
- where the checkout routes between instances, all of the above once as
  routed (``vec``) and once with every launch pinned to ``general``: the
  first port's row kernel (a block a row, 2-byte loads, long segments
  walked whole) behind the same layouts, the same bf16 backward and the
  same fused dscale, which is the design ``vec`` has to beat.

``--src`` imports the port from another checkout's ``src`` (a parent
commit, for a comparison in one call: run parent, change, change,
parent).  ``--check`` first runs ``chip_smoke.py``'s kernel-6 cases.
Prints one JSON line per reading.
"""
import argparse
import contextlib
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, E, K, D = 4096, 60, 4, 2048


def whole_call(ops, bias):
    """The routed layer's four movements as one call, and the routing's
    slot-0 segment length."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((T, E), generator=gen, device="cuda")
    logits[:, 0] += bias
    w, idx = torch.softmax(logits, -1).topk(K, -1)
    w = (w / w.sum(-1, keepdim=True)).reshape(-1)
    cap = max(-(-T * K // E) * 2, 8)
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * K, device="cuda") // K
    pos, keep = ops.capacity_positions(flat_e, cap)
    slot = flat_e * cap + pos
    bf = torch.bfloat16
    xt = torch.randn((T, D), generator=gen, device="cuda").to(bf)
    y2d = torch.randn((E * cap, D), generator=gen, device="cuda").to(bf)
    dbuf = torch.randn((E * cap, D), generator=gen, device="cuda").to(bf)
    dout = torch.randn((T, D), generator=gen, device="cuda").to(bf)
    leaves = [t.requires_grad_(True) for t in (xt, y2d, w)]
    shared = hasattr(ops, "routing_layouts")

    def fn():
        kw = {}
        if shared:
            kw["layouts"] = ops.routing_layouts(flat_tok, slot, keep,
                                                E * cap, T, k=K)
        buf = ops.token_dispatch(xt, flat_tok, slot, keep, E * cap, **kw)
        out = ops.token_combine(y2d, flat_tok, slot, keep, w, T, **kw)
        return torch.autograd.grad((buf, out), leaves, (dbuf, dout))
    dst = torch.where(keep, slot, 0)
    wk = torch.where(keep, w.detach(), 0.0)

    def dispatch():   # one movement through the public entry, own layout
        return ops.gather_scatter_add_rows(xt.detach(), flat_tok, dst,
                                           keep.float(), E * cap)

    def combine():
        return ops.gather_scatter_add_rows(y2d.detach(), dst, flat_tok, wk,
                                           T)
    return fn, {"dispatch": dispatch, "combine": combine}, int(
        (dst == 0).sum())


def launch_split(fn, calls: int = 20):
    """{kernel: device ms per call} over ``calls`` calls of ``fn``, L2
    flushed before each (the flush's own kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    import chip_smoke as cs
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        n = evt.count
        if "FillFunctor" in evt.key and n == calls:
            continue   # the flush
        name = re.sub(r"\(.*", "", evt.key.replace(
            "(anonymous namespace)::", ""))[:70]
        row = out.setdefault(name, [0.0, 0])
        row[0] += us / 1e3 / calls
        row[1] += n / calls
    if not out:
        raise SystemExit("the profiler recorded no device time")
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


@contextlib.contextmanager
def pinned(ops, inst):
    """Every launch made inside takes instance ``inst`` (None: as routed).
    ``general`` takes any row, so pinning it is a measurement, not a
    route the program uses."""
    if inst is None:
        yield
        return
    routed = ops.instance
    ops.instance = lambda *a, **kw: inst
    try:
        yield
    finally:
        ops.instance = routed


def timings(tag):
    import chip_smoke as cs
    from repro_torch.kernels.moe_dispatch import ops
    insts = ["vec", "general"] if hasattr(ops, "instance") else [None]
    for bias in (0.0, 4.0):
        for inst in insts:
            with pinned(ops, None if inst == "vec" else inst):
                timed(cs, ops, tag, bias, inst)


def timed(cs, ops, tag, bias, inst):
    """One reading of the whole Function and of the two forward movements
    alone; with ``inst``, first checks that a call's four movements all
    take it."""
    fn, forward, seg0 = whole_call(ops, bias)
    if inst is not None:
        n0 = dict(ops.LAUNCHES_BY_INSTANCE)
        fn()
        by = {i: v - n0[i] for i, v in ops.LAUNCHES_BY_INSTANCE.items()}
        if by[inst] != 4 or sum(by.values()) != 4:
            raise SystemExit(f"{inst}: a call's launches by instance {by}")
    split = launch_split(fn)
    moves = {}
    for m, f in forward.items():
        s = launch_split(f)
        moves[m] = {"ms": cs.time_ms(f), "kernel_ms": sum(
            ms for k, (ms, _) in s.items() if "gsa" in k)}
    print("timed", json.dumps({
        "src": tag, "instance": inst, "bias": bias, "slot0_segment": seg0,
        "ms": cs.time_ms(fn), "device_ms": sum(v[0] for v in
                                               split.values()),
        "gsa_kernels_ms": sum(ms for k, (ms, _) in split.items()
                              if "gsa" in k),
        "launches_per_call": sum(v[1] for v in split.values()),
        "forward_movements": moves, "split": split}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--check", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(a.src))
    import chip_smoke as cs
    cs.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all()
    for line in _build.BUILD_INFO["ptxas"].get("moe_dispatch", "").split(
            "\n"):
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = cs._kernel_label(entry.group(1))
        if "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}")
    if a.check:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for row in cs.gsa_cases(gen):
            print("checked", json.dumps(row), flush=True)
    timings(a.src)


if __name__ == "__main__":
    main()
