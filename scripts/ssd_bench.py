#!/usr/bin/env python3
"""Times the SSD chunked-scan kernel (kernel 7) on one GPU, and checks it.

  PYTHONPATH=src python3 scripts/ssd_bench.py [--src DIR] [--check]

At the ssm prefill's shape (one 1024-token prompt of Mamba2-1.3B: B 1,
S 1024, H 64, P 64, N 128, G 1, chunk 256, bf16; x, B and C views of one
conv output, as the model passes them), fast decay:

- the whole call, CUDA events with L2 flushed before each call, as
  ``chip_smoke.py`` times kernels, and the same with L2 warm (calls back
  to back, no flush);
- the per-launch split: torch.profiler's device time of each of the
  call's kernels over 20 calls, L2 flushed before each.

Each reading names the instance the call took (a checkout that predates
``ops.instance`` has only the CUDA-core kernel).  ``--src`` imports the
port from another checkout's ``src`` (a parent commit, for a comparison
in one call).  ``--check`` first runs ``chip_smoke.py``'s SSD cases.
Prints one JSON line per reading.
"""
import argparse
import json
import os
import re
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, H, P, N, G, Q = 1, 1024, 64, 64, 128, 1, 256


def path_inputs():
    """x, dt, A, B, C as the model hands them to the scan: views of one
    (B, S, H*P + 2*G*N) bf16 conv output."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = torch.randn(B, S, H * P + 2 * G * N, generator=gen,
                       device="cuda").bfloat16()
    conv[..., H * P:] *= 0.3
    x = conv[..., :H * P].reshape(B, S, H, P)
    b = conv[..., H * P:H * P + G * N].reshape(B, S, G, N)
    c = conv[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, H, generator=gen, device="cuda"))
    return x, dt, -torch.ones(H, device="cuda"), b, c


def warm_ms(fn, iters=20):
    """Device time of one call with L2 warm: calls queued back to back
    behind a device-side sleep, one pair of events around them all."""
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


def launch_split(fn, calls: int = 20):
    """{kernel: device ms per call} of the scan's launches: torch.profiler
    over ``calls`` calls of ``fn``, L2 flushed before each."""
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
        if evt.device_type != DeviceType.CUDA or "ssd_" not in evt.key:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = "ssd_" + re.split(r"[<(]", evt.key.split("ssd_", 1)[1])[0]
        out[name] = us / 1e3 / calls
    if not out:
        raise SystemExit("the profiler recorded no device time in the SSD "
                         "kernels")
    return out


def timings(tag):
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops
    x, dt, A, b, c = path_inputs()
    inst = ops.instance(x, b, c) if hasattr(ops, "instance") else "general"

    def fn():
        return ops.ssd(x, dt, A, b, c, chunk=Q)
    bound = cs.ssd_bound_ms(B, S, H, P, N, G, Q, torch.bfloat16, False)
    print("timed", json.dumps({
        "src": tag, "instance": inst, "ms": cs.time_ms(fn),
        "ms_l2_warm": warm_ms(fn), "launches": launch_split(fn),
        "bound_ms": bound[0], "bound_by": bound[1]}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--check", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.abspath(a.src))
    import chip_smoke as cs
    cs.phase_card()
    from repro_torch.kernels import _build
    _build.build_all()
    if a.check:
        gen = torch.Generator(device="cuda").manual_seed(0)
        for row in cs.ssd_cases(gen):
            print("checked", json.dumps(row), flush=True)
    timings(a.src)


if __name__ == "__main__":
    main()
