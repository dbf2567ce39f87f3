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

  python3 scripts/phase_walls.py --calls ROOT

runs the whole script instead, every function it defines timed: it
prints the script's own output, then ``CALLS`` and a JSON list of the
functions that took most, as [phase, function, calls, inclusive
seconds] (a function inside itself is counted once).
"""
import collections
import functools
import importlib.util
import inspect
import json
import sys
import time

import torch


def _load(root):
    sys.path.insert(0, root + "/src")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root + "/chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    return cs


def _timed(cs, top=80):
    """Wraps the module's functions (and its PATHS) with host-clock timers;
    returns a function that prints the table."""
    spent, calls = collections.Counter(), collections.Counter()
    state = {"phase": "main", "open": collections.Counter()}

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            outer = state["phase"]
            if name.startswith("phase_"):
                state["phase"] = name[6:]
            key = (state["phase"], name)
            state["open"][key] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                state["open"][key] -= 1
                if not state["open"][key]:
                    spent[key] += time.perf_counter() - t0
                calls[key] += 1
                state["phase"] = outer
        return timed

    for name, fn in list(vars(cs).items()):
        if (inspect.isfunction(fn) and fn.__module__ == cs.__name__
                and name not in ("main", "fail")):
            setattr(cs, name, wrap(name, fn))
    cs.PATHS = tuple(getattr(cs, f.__name__) for f in cs.PATHS)

    def report():
        rows = [[ph, fn, calls[(ph, fn)], round(s, 2)]
                for (ph, fn), s in spent.most_common(top)]
        print("CALLS " + json.dumps(rows), flush=True)
    return report


def main(argv):
    if argv[0] == "--calls":
        cs = _load(argv[1])
        report = _timed(cs)
        rc = cs.main()
        report()
        return rc
    root, phases = argv[0], argv[1:]
    cs = _load(root)
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
