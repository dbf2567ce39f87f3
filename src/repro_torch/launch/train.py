"""Training launcher of the port: one model, on the card.

The single-model path of ``repro.launch.train``: batches from
``FederatedCorpus.mixed_eval_batch(batch, seq, seed_salt=step)`` (with
zero stub ``patches`` or ``frames`` for the VLM and encoder-decoder
families, ``make_batch``), the cosine schedule with warmup
``max(steps // 20, 1)``, AdamW with weight decay 0.01, through
``federated.device.train_step``.  No mesh: one device.  Weights are
random, drawn from seed 0.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --variant full --steps 20 --batch 4 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --variant reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-v3-671b --device cpu     # MLA, the MTP loss
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch whisper-small --variant reduced --device cpu  # enc-dec

Prints loss, accuracy and grad norm as the reference does, and ms per
step and tokens/s over the steps after the first (which builds the
kernels and warms the allocator), synchronised with the device.
``--save PATH`` writes the final parameters in the reference's npz
format (``checkpoint.save_pytree``).

Fleet mode (``--fleet N``) instead drives the federated device fleet on
``--device``: synchronous one-shot by default, async participation
rounds with ``--async-rounds`` (``--check-sync`` then also asserts that
the same rounds on an ideal fleet reproduce ``train_fleet`` bit for
bit).  ``--n-hosts K`` spreads the fleet over K ranks, one a simulated
host (``launch/mesh.py::make_fleet_mesh``): under ``torchrun
--nproc-per-node K`` (NCCL on the card, one rank a card; gloo on the
CPU), only rank 0 printing; without ``torchrun`` one rank, so K above 1
is the reference's oversubscription ``ValueError``.  As in the
reference, ``--n-hosts`` reaches the fleet only: a single model ignores
it.  ``--production-mesh`` is not ported yet and refused.

  PYTHONPATH=src python -m repro_torch.launch.train --fleet 8 \
      --async-rounds 3 --steps-per-round 2 --straggler-profile mild \
      --check-sync
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --fleet 8 --n-hosts 4 --device cpu
"""
from __future__ import annotations

import argparse
import builtins
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.device import train_step
from repro_torch.launch import mesh as LM
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves

# reference flags with no port yet: (flag, argparse kwargs)
_NOT_PORTED = [
    ("--production-mesh", {"action": "store_true"}),
]

# tiny stand-ins for two device families, sized so the fleet smoke runs
# in seconds (the reference's ``_fleet_families``)
_FLEET_TINY = dict(vocab_size=256, dtype="float32", remat=False,
                   attn_chunk_q=16, attn_chunk_k=16, loss_chunk=16)


def make_batch(cfg: ModelConfig, corpus, step: int, batch: int, seq: int,
               device):
    """Step ``step``'s batch on ``device``: ``mixed_eval_batch(batch, seq,
    seed_salt=step)``, and for a family with a stub frontend (VLM
    ``patches``, encoder-decoder ``frames``) zero frontend rows (batch,
    frontend_tokens, d_model) in the model's dtype, as the reference's
    ``make_batch``."""
    b = {k: v.to(device) for k, v in corpus.mixed_eval_batch(
        batch, seq, seed_salt=step).items()}
    key = M.frontend_key(cfg)
    if key is not None:
        b[key] = torch.zeros((batch, cfg.frontend_tokens, cfg.d_model),
                             dtype=M._dtype(cfg), device=device)
    return b


def _fleet_families():
    return [
        ModelConfig(name="fleet-gpt2-tiny", n_layers=2, d_model=32,
                    n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
                    norm_type="layernorm", act="gelu", mlp_gated=False,
                    pos_embedding="sinusoidal", **_FLEET_TINY).validate(),
        ModelConfig(name="fleet-llama-tiny", n_layers=2, d_model=48,
                    n_heads=2, n_kv_heads=2, head_dim=24, d_ff=96,
                    **_FLEET_TINY).validate(),
    ]


def _uploads_bitwise_equal(ua, ub) -> bool:
    return all(a["losses"] == b["losses"] and all(
        torch.equal(xa, xb) for xa, xb in zip(tree_leaves(a["params"]),
                                              tree_leaves(b["params"])))
        for a, b in zip(ua, ub))


def run_fleet(args) -> int:
    """The fleet on ``--device``; over ``--n-hosts`` ranks (started here
    if no process group is up, and ended here then) when above 1."""
    device = resolve_device(args.device)
    if args.n_hosts <= 1:
        return _run_fleet(args, device)
    started = LM.init_process_group(device)
    try:
        return _run_fleet(args, LM.local_device(device))
    finally:
        if started:
            dist.destroy_process_group()


def _run_fleet(args, device) -> int:
    from repro_torch.federated import (STRAGGLER_PROFILES, AsyncFleetConfig,
                                       SimulationConfig, build_fleet,
                                       train_fleet, train_fleet_async)

    print = (builtins.print if args.n_hosts <= 1 or dist.get_rank() == 0
             else (lambda *a, **k: None))
    sim = SimulationConfig(n_devices=args.fleet, n_domains=4, vocab=256,
                           seq_len=args.seq, device_steps=args.steps,
                           device_batch=args.batch, seed=0)
    corpus = FederatedCorpus.build(seed=sim.seed, n_devices=sim.n_devices,
                                   n_domains=sim.n_domains, vocab=sim.vocab,
                                   alpha=sim.alpha_noniid)
    traffic = STRAGGLER_PROFILES[args.straggler_profile]
    if args.dropout is not None:
        traffic = dataclasses.replace(traffic, dropout_p=args.dropout)
    fleet = build_fleet(sim, corpus, _fleet_families(), traffic=traffic)
    run = dict(batch=args.batch, seq_len=args.seq, n_hosts=args.n_hosts,
               device=device)

    if args.async_rounds <= 0:
        t0 = time.time()
        uploads = train_fleet(fleet, corpus, steps=args.steps, **run)
        finals = [round(u["losses"][-1], 3) for u in uploads[:4]]
        print(f"sync fleet: {len(uploads)} uploads in {time.time()-t0:.1f}s "
              f"on {args.n_hosts} host(s), final losses {finals}…")
        return 0

    acfg = AsyncFleetConfig(
        rounds=args.async_rounds, steps_per_round=args.steps_per_round,
        participation=args.participation, deadline_s=args.deadline_s,
        deadline_policy=args.deadline_policy,
        hierarchical=args.hierarchical)
    t0 = time.time()
    uploads, rep = train_fleet_async(fleet, corpus, acfg, log=print, **run)
    dt = time.time() - t0
    print(f"async fleet ({rep['mode']}): {acfg.rounds} rounds in {dt:.1f}s "
          f"({acfg.rounds / dt:.2f} rounds/s), participation "
          f"{rep['participation_rate']:.2f}, staleness p95 "
          f"{rep['staleness_p95']:.1f}, global comm "
          f"{rep['comm_bytes_global']} B (edge {rep['comm_bytes_edge']} B), "
          f"lost {rep['lost_reports']}")

    if args.check_sync:
        # only meaningful on an ideal fleet: every device online + on
        # time, full participation; then async rounds must reproduce the
        # one-shot synchronous run bit for bit
        total = acfg.rounds * acfg.steps_per_round
        ideal = build_fleet(sim, corpus, _fleet_families())
        sync = train_fleet(ideal, corpus, steps=total, **run)
        ideal_cfg = dataclasses.replace(acfg, participation=1.0,
                                        deadline_s=float("inf"))
        asy, _ = train_fleet_async(ideal, corpus, ideal_cfg, **run)
        if not _uploads_bitwise_equal(asy, sync):
            print("CHECK-SYNC FAILED: async rounds != synchronous train_fleet")
            return 1
        print(f"check-sync OK: {acfg.rounds}x{acfg.steps_per_round} async "
              f"rounds == {total}-step train_fleet bit-for-bit")
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
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
    # fleet mode (see module docstring)
    ap.add_argument("--fleet", type=int, default=0,
                    help="train an N-device federated fleet instead of one "
                         "model")
    ap.add_argument("--n-hosts", type=int, default=1,
                    help="fleet mode: spread the fleet over this many "
                         "ranks (torchrun); a single model ignores it")
    ap.add_argument("--async-rounds", type=int, default=0,
                    help="> 0 switches the fleet to async participation "
                         "rounds")
    ap.add_argument("--steps-per-round", type=int, default=4)
    ap.add_argument("--participation", type=float, default=1.0)
    ap.add_argument("--dropout", type=float, default=None,
                    help="per-round dropout probability (overrides profile)")
    ap.add_argument("--deadline-s", type=float, default=float("inf"))
    ap.add_argument("--deadline-policy", default="stale",
                    choices=["drop", "stale", "standby"])
    ap.add_argument("--straggler-profile", default="none",
                    choices=["none", "mild", "harsh"])
    ap.add_argument("--hierarchical", action="store_true")
    ap.add_argument("--check-sync", action="store_true",
                    help="assert async rounds on an ideal fleet reproduce "
                         "synchronous train_fleet bit for bit")
    for flag, kw in _NOT_PORTED:
        ap.add_argument(flag, help="not ported yet", **kw)
    args = ap.parse_args(argv)
    for flag, kw in _NOT_PORTED:
        if getattr(args, flag[2:].replace("-", "_")) != kw.get("default",
                                                              False):
            raise NotImplementedError(f"{flag} is not ported yet")
    if args.fleet <= 0 and not args.arch:
        ap.error("--arch is required (unless running --fleet mode)")
    return args


def main(argv=None):
    """Trains one model (returns its per-step losses), or with ``--fleet``
    the fleet (returns the exit code)."""
    args = parse_args(argv)
    if args.fleet > 0:
        return run_fleet(args)
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
        b = make_batch(cfg, corpus, s, args.batch, args.seq, device)
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
    out = main()
    if isinstance(out, int):
        raise SystemExit(out)
