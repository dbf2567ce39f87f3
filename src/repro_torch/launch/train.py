"""Training launcher of the port: one model, on the card.

The single-model path of ``repro.launch.train``: batches from
``FederatedCorpus.mixed_eval_batch(batch, seq, seed_salt=step)``, the
cosine schedule with warmup ``max(steps // 20, 1)``, AdamW with weight
decay 0.01, through ``federated.device.train_step``.  No mesh: one
device.  Weights are random, drawn from seed 0.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --variant full --steps 20 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --variant reduced --device cpu

Prints loss, accuracy and grad norm as the reference does, and ms per
step and tokens/s over the steps after the first (which builds the
kernels and warms the allocator), synchronised with the device.
``--save PATH`` writes the final parameters in the reference's npz
format (``checkpoint.save_pytree``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.device import train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.utils.device import resolve_device

# reference flags with no port yet: (flag, argparse kwargs)
_NOT_PORTED = [
    ("--fleet", {"type": int, "default": 0}),
    ("--production-mesh", {"action": "store_true"}),
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="reduced",
                    choices=["full", "reduced"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=512,
                    help="vocab size of the reduced variant")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", default="",
                    help="write the final parameters here (npz)")
    for flag, kw in _NOT_PORTED:
        ap.add_argument(flag, help="not ported yet", **kw)
    args = ap.parse_args(argv)
    for flag, kw in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) != kw.get("default",
                                                              False):
            raise NotImplementedError(f"{flag} is not ported yet")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, variant=args.variant)
    if args.variant == "reduced":
        cfg = cfg.replace(vocab_size=args.vocab)
    corpus = FederatedCorpus.build(seed=0, n_devices=4, n_domains=4,
                                   vocab=cfg.vocab_size)
    params = M.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0))
    opt = adamw_init(params)
    sched = cosine_schedule(args.lr, args.steps,
                            warmup=max(args.steps // 20, 1))
    losses = []
    t0 = t1 = time.perf_counter()
    for s in range(args.steps):
        b = corpus.mixed_eval_batch(args.batch, args.seq, seed_salt=s)
        b = {k: v.to(device) for k, v in b.items()}
        loss, metrics, stats = train_step(params, opt, cfg, b, sched(s),
                                          weight_decay=0.01)
        losses.append(loss)
        if s == 0:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
        if s % max(args.steps // 10, 1) == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {float(loss):.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"gnorm {float(stats['grad_norm']):.2e} "
                  f"({time.perf_counter() - t0:.1f}s)")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    timed = args.steps - 1
    if timed > 0:
        ms = 1e3 * (t2 - t1) / timed
        dev_name = (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")
        print(f"{args.arch} ({args.variant}) on {dev_name}: {ms:.1f} ms/step, "
              f"{args.batch * args.seq * timed / (t2 - t1):.0f} tokens/s "
              f"over steps 1..{args.steps - 1}")
    if args.save:
        save_pytree(params, args.save)
        print("saved", args.save)
    return [float(x) for x in torch.stack(losses).cpu()]


if __name__ == "__main__":
    main()
