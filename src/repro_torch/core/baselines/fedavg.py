"""FedAvg [McMahan et al., AISTATS'17]: classic multi-round FL.

Counterpart of ``repro.core.baselines.fedavg``.  Every device trains
*the same* small dense model (architecture-homogeneous by construction);
the server averages it element-wise each round.  Included as the
canonical FL reference: its per-round down + up traffic of the full
model is what DeepFusion's one-shot design avoids (Fig. 8).
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
from repro_torch.optim import adamw_init
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_average, tree_bytes, tree_map


def run_fedavg(sim: SimulationConfig, model_cfg: ModelConfig, *,
               rounds: int = 5, local_steps: int = 8, batch: int = 8,
               lr: float = 3e-3, corpus: FederatedCorpus = None,
               log: Callable[[str], None] = print, device="cuda"):
    """The global model drawn from a ``torch.Generator`` seeded ``sim.seed
    + 11`` (the reference's key).  Each round every device trains a copy
    of it ``local_steps`` steps at a constant ``lr`` with a fresh AdamW
    state, and the server averages the copies (``tree_average``).
    Returns (params, report)."""
    dev = resolve_device(device)
    corpus = corpus or build_corpus(sim)
    global_params = M.init_params(model_cfg, generator=torch.Generator(
        device=dev).manual_seed(sim.seed + 11))
    model_bytes = tree_bytes(global_params)
    comm = 0
    for r in range(rounds):
        locals_ = []
        for n in range(sim.n_devices):
            # the step updates in place: each device trains its own copy
            params = tree_map(torch.clone, global_params)
            opt = adamw_init(params)
            for s in range(local_steps):
                b = corpus.device_batch(n, batch, sim.seq_len,
                                        step=r * local_steps + s)
                loss, _, _ = train_step(params, opt, model_cfg,
                                        {k: v.to(dev) for k, v in b.items()},
                                        lr)
            locals_.append(params)
            comm += 2 * model_bytes  # download + upload
        global_params = tree_average(locals_)
        log(f"fedavg round {r}: loss {float(loss):.3f}")
    metrics = evaluate_model(global_params, model_cfg, corpus,
                             seq_len=sim.seq_len)
    return global_params, {"metrics": metrics, "comm_bytes": int(comm),
                           "corpus": corpus}
