"""Host cost of a paged decode step of full-width TinyLlama-1.1B, by KV
cache policy, and of the quantized cache writes' parts, on one GPU.

  PYTHONPATH=src python scripts/decode_host_cost.py

Decode is host-bound: the host queues a step's launches more slowly than
the device runs them.  So the host time of ``decode_step`` (no
synchronise) is the step's cost, and its parts are timed the same way,
500 calls each.  Prints one JSON object: the card's name and power
limit, ms per step for each policy (bf16, int8, fp8, then bf16 and int8
again, to show the spread), and ms per call of the write path's parts:
quantizing k and v in two calls or stacked, and four ``paged_insert``
calls against four writes through one ``paged_rows`` index.
"""
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import quant  # noqa: E402

B, BLOCK_LEN, NBT, POS = 8, 16, 68, 600   # the serve phase's 8 slots


def host_ms(fn, n):
    """(host ms per call with nothing synchronised, ms per call to the
    device's end)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e3, (t2 - t0) / n * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("decode_host_cost: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tinyllama-1.1b", variant="full")
    params = M.init_params(
        cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    nb = 1 + B * NBT
    bt = torch.arange(1, nb, dtype=torch.int32, device="cuda").reshape(B, NBT)
    tok = torch.zeros(B, 1, dtype=torch.int32, device="cuda")
    pos = torch.full((B,), POS, dtype=torch.int32, device="cuda")
    res = {"card": smi, "decode_step": {}}
    with torch.no_grad():
        for kv in ("", "int8", "fp8", "", "int8"):
            cache = M.init_paged_cache(cfg, B, nb, BLOCK_LEN, device="cuda",
                                       policy=quant.CachePolicy(kv))
            enq, tot = host_ms(lambda: M.decode_step(
                params, cfg, cache, tok, pos, block_tables=bt), 20)
            res["decode_step"].setdefault(kv or "bf16", []).append(
                {"host_ms": enq, "step_ms": tot})
        k = torch.randn(B, 1, cfg.n_kv_heads, cfg.resolved_head_dim,
                        device="cuda", dtype=torch.bfloat16)
        v = torch.randn_like(k)
        posc = pos[:, None]
        pool = torch.zeros((nb, BLOCK_LEN) + tuple(k.shape[2:]),
                           dtype=torch.int8, device="cuda")
        spool = torch.zeros(pool.shape[:3], device="cuda")
        writes = ((pool, k), (pool, v), (spool, k[..., 0]),
                  (spool, v[..., 0]))

        def two_calls():
            quant.quantize(k, "int8")
            quant.quantize(v, "int8")

        def four_inserts():
            for t, e in writes:
                L.paged_insert(t, bt, posc, e)

        def shared_rows():
            blk, off = L.paged_rows(bt, posc, BLOCK_LEN)
            for t, e in writes:
                t[blk, off] = e.to(t.dtype)

        parts = {"quantize_two_calls": two_calls,
                 "quantize_stacked": lambda: quant.quantize(
                     torch.stack([k, v]), "int8"),
                 "paged_insert_x4": four_inserts,
                 "paged_writes_x4_shared_rows": shared_rows,
                 "one_elementwise_op": lambda: k.abs()}
        res["parts_host_ms"] = {name: host_ms(fn, 500)[0]
                                for name, fn in parts.items()}
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
