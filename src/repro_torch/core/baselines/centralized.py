"""Centralized MoE training: the paper's upper bound ("DeepSpeed" role).

Counterpart of ``repro.core.baselines.centralized``.  All private device
data is pooled at the server (violating the FL constraint: that is the
point of the upper bound) and the global MoE is trained end to end with
full-parameter updates.  Communication cost is the raw data upload.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.device import train_step
from repro_torch.federated.simulation import (SimulationConfig, build_corpus,
                                              evaluate_model)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, cosine_schedule
from repro_torch.utils.device import resolve_device


def run_centralized(sim: SimulationConfig, moe_cfg: ModelConfig, *,
                    steps: int = 120, batch: int = 8, lr: float = 1e-3,
                    corpus: FederatedCorpus = None,
                    log: Callable[[str], None] = print, device="cuda"):
    """The MoE drawn from a ``torch.Generator`` seeded ``sim.seed + 7``
    (the reference's key), trained ``steps`` steps on pooled batches
    ``mixed_eval_batch(batch, seq_len, seed_salt=77_000 + s)``, cosine
    schedule with warmup ``max(steps // 20, 1)``.  Returns (params,
    report)."""
    dev = resolve_device(device)
    corpus = corpus or build_corpus(sim)
    params = M.init_params(moe_cfg, generator=torch.Generator(
        device=dev).manual_seed(sim.seed + 7))
    opt = adamw_init(params)
    sched = cosine_schedule(lr, steps, warmup=max(steps // 20, 1))
    losses = []
    for s in range(steps):
        # pooled data: sample across devices' domains uniformly
        b = corpus.mixed_eval_batch(batch, sim.seq_len, seed_salt=77_000 + s)
        loss, _, _ = train_step(params, opt, moe_cfg,
                                {k: v.to(dev) for k, v in b.items()},
                                sched(s))
        losses.append(loss)
    hist = [float(x) for x in torch.stack(losses).cpu()]
    log(f"centralized: loss {hist[0]:.3f}->{hist[-1]:.3f}")
    metrics = evaluate_model(params, moe_cfg, corpus, seq_len=sim.seq_len)
    # comm: every device ships its raw data (tokens, int32)
    tokens_per_device = sim.device_steps * sim.device_batch * (sim.seq_len + 1)
    comm = int(sim.n_devices * tokens_per_device * 4)
    return params, {"metrics": metrics, "comm_bytes": comm, "history": hist,
                    "corpus": corpus}
