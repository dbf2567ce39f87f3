"""FedKMT/FedMKT [Fan et al., COLING'25]: logits-only federated KD.

Counterpart of ``repro.core.baselines.fedkmt``.  The same one-shot
uploads and clustering as DeepFusion, but knowledge is transferred
through **final logits only** (KL), with no feature-level alignment: the
DeepFusion pipeline with α = 0 (no L_FM), identical budgets everywhere
else, so differences isolate the VAA mechanism (paper §V.C).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.server import ServerConfig
from repro_torch.federated.simulation import SimulationConfig, run_deepfusion
from repro_torch.models.config import ModelConfig


def run_fedkmt(sim: SimulationConfig, server_cfg: ServerConfig,
               device_cfgs: Sequence[ModelConfig], *, uploads=None,
               corpus: FederatedCorpus = None,
               log: Callable[[str], None] = print, device="cuda"):
    cfg = dataclasses.replace(server_cfg, alpha=0.0)
    return run_deepfusion(sim, cfg, device_cfgs, uploads=uploads,
                          corpus=corpus, log=log, device=device)
