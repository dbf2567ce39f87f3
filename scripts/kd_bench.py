#!/usr/bin/env python3
"""Times the fused kd_loss kernel on one GPU, and checks it.

  PYTHONPATH=src python3 scripts/kd_bench.py [--src DIR] [--check]

Times (CUDA events, L2 flushed before each call, as ``chip_smoke.py``
times kernels; also with L2 warm) the kernel at the train step's shape
(T 2048, D 2048, V 32000, bf16, CE), in KD mode (Dt 1024, tau 2) and at
the tune step's vocabulary (V 151936), beside the ``torch.matmul`` +
``F.cross_entropy`` call and the least time the card could take.
``--src`` imports the port from another checkout's ``src`` (a parent
commit, for a comparison in one call).  ``--check`` first runs
``chip_smoke.py``'s kd_loss cases (every instance, ragged edges, planted
ties, two launches bit-identical).  Prints one JSON line per reading.
"""
import argparse
import json
import os
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (T, Ds, Dt, V, tau): train CE, train KD, tune CE
SHAPES = ((2048, 2048, 0, 32000, 1.0), (2048, 2048, 1024, 32000, 2.0),
          (2048, 2048, 0, 151936, 1.0))


def _warm_ms(fn, iters=20):
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
    from repro_torch.kernels.kd_loss import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for T, Ds, Dt, V, tau in SHAPES:
        hs = torch.randn((T, Ds), generator=gen, device="cuda").to(bf)
        ws = (torch.randn((Ds, V), generator=gen, device="cuda")
              / Ds ** 0.5).to(bf)
        lab = torch.randint(0, V, (T,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ht = wt = None
        if Dt:
            ht = torch.randn((T, Dt), generator=gen, device="cuda").to(bf)
            wt = (torch.randn((Dt, V), generator=gen, device="cuda")
                  / Dt ** 0.5).to(bf)

        def run():
            return ops.kd_loss_fwd(hs, ws, ht, wt, lab, tau=tau)

        def library():
            return F.cross_entropy(torch.matmul(hs, ws).float(), lab.long(),
                                   reduction="none")
        d_all = Ds + Dt
        bound, by = cs.bound_ms((T * d_all + d_all * V) * 2 + 16 * T,
                                2 * T * d_all * V, bf)
        inst = (ops.instance(hs, ws, ht, wt) if hasattr(ops, "instance")
                else "mma.sync")
        print("timed", json.dumps({
            "src": tag, "T": T, "Ds": Ds, "Dt": Dt, "V": V,
            "instance": inst, "ms": cs.time_ms(run), "warm_ms": _warm_ms(run),
            "library_ms": None if Dt else cs.time_ms(library),
            "bound_ms": bound, "bound_by": by}), flush=True)
        del hs, ws, ht, wt
        torch.cuda.empty_cache()


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
        for row in cs.kd_cases(torch.Generator(device="cuda").manual_seed(0)):
            print("checked", json.dumps({k: row[k] for k in (
                "case", "instance", "err_over_limit")}), flush=True)
    timings(a.src)


if __name__ == "__main__":
    main()
