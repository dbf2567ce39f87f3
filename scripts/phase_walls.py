#!/usr/bin/env python3
"""Runs some phases of a checkout's ``chip_smoke.py`` on one GPU and
prints each one's wall time.

  python3 scripts/phase_walls.py ROOT PHASE [PHASE ...]

ROOT is the checkout (``.``, or a parent commit's ``chip_smoke.py`` and
``src`` unpacked under ``build/``: ``git archive <commit> chip_smoke.py
src | tar -x -C build/parent``).  A PHASE is the name of a
``phase_<name>`` function of that script (``serve_ssm``,
``serve_encdec``, ...), or ``encdec_cases`` for the enc-dec kernel
shapes of the kernels phase.  The card and the build phases run first.
Each run prints ``WALL <root> <phase>: <seconds>s <launches>``; compare
two checkouts only inside one call, in turns (parent, change, change,
parent), since hosts differ.
"""
import importlib.util
import json
import sys
import time

import torch


def main(argv):
    root, phases = argv[0], argv[1:]
    sys.path.insert(0, root + "/src")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root + "/chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_card()
    cs.phase_build()
    for name in phases:
        t0 = time.perf_counter()
        if name == "encdec_cases":
            gen = torch.Generator(device="cuda").manual_seed(0)
            for row in cs.encdec_cases(gen):
                print("kernel " + json.dumps(row))
            out = None
        else:
            out = getattr(cs, "phase_" + name)()
        torch.cuda.synchronize()
        print(f"WALL {root} {name}: {time.perf_counter() - t0:.1f}s {out}",
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("phase_walls: no CUDA device")
    sys.exit(main(sys.argv[1:]))
