"""DeepFusion central server (paper Fig. 3): Phase III of the pipeline.

Counterpart of ``repro.federated.server``.  Phase III merges the K base
models into the global MoE (Fig. 6, ``core/merge.py``) and tunes it with
frozen experts (§IV.D, ``core/tuning.py``) on server-side public data.
The reference compiles the tune epoch into one scanned program; the port
runs the same steps eagerly (``optim.loops.scan_epoch``) with the same
seed, schedule and batches.

Not ported yet, and refused with ``NotImplementedError``: Phase I
(``cluster``), Phase II (``distill_proxy``), the whole pipeline
(``run``), meshes, the async fleet schedule (``AsyncFleetConfig``,
``FleetAggregator``) and the bf16/int8 moment policies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import merge, tuning
from repro_torch.data.federated import FederatedCorpus
from repro_torch.models.config import ModelConfig
from repro_torch.optim import cosine_schedule
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class ServerConfig:
    moe_cfg: ModelConfig
    distill_steps: int = 60
    distill_batch: int = 8
    distill_lr: float = 1e-3
    tune_steps: int = 60
    tune_batch: int = 8
    tune_lr: float = 5e-4
    seq_len: int = 64
    alpha: float = 1.0            # L_FM weight (Eq. 11)
    beta: float = 1.0             # L_KL weight (Eq. 11)
    temperature: float = 2.0
    n_stages: int = 4             # J representation stages
    vaa_dim: int = 128
    vaa_heads: int = 4
    p_q: int = 64                 # total VAA queries
    seed: int = 0
    # AdamW moment storage for Phase II distillation ('' only: the bf16 /
    # int8 policies are not ported yet)
    state_policy: str = ""
    # async fleet participation schedule (not ported yet: None only)
    schedule: Optional[object] = None


class DeepFusionServer:
    """``device`` defaults to the card; pass ``device="cpu"`` to run on
    the CPU.  ``on_step(step, loss)``, if given, runs after every tuning
    step (e.g. to time it)."""

    def __init__(self, cfg: ServerConfig, corpus: FederatedCorpus,
                 device_cfgs: Sequence[ModelConfig], *, mesh=None,
                 log: Callable[[str], None] = lambda s: None,
                 device="cuda", on_step: Optional[Callable] = None):
        if mesh is not None:
            raise NotImplementedError("a server mesh is not ported yet")
        if cfg.schedule is not None:
            raise NotImplementedError(
                "the async fleet schedule is not ported yet")
        if cfg.state_policy:
            raise NotImplementedError(
                f"state_policy={cfg.state_policy!r} is not ported yet")
        self.cfg = cfg
        self.corpus = corpus
        self.device_cfgs = list(device_cfgs)
        self.log = log
        self.device = resolve_device(device)
        self.on_step = on_step
        self.report: Dict = {}

    # ------------------------------------------------------------------
    # Phases I and II
    # ------------------------------------------------------------------
    def cluster(self, uploads):
        raise NotImplementedError("Phase I (cluster) is not ported yet")

    def distill_proxy(self, proxy_item, base_cfg, *, init_params=None,
                      seed_offset: int = 0):
        raise NotImplementedError(
            "Phase II (distill_proxy) is not ported yet")

    # ------------------------------------------------------------------
    # Phase III
    # ------------------------------------------------------------------
    def merge_and_tune(self, base_params_list: List, *, init_params=None):
        """Merge the base models (on ``self.device``) into the global MoE
        and tune it for ``tune_steps`` steps.  The MoE's own init is drawn
        from a ``torch.Generator`` seeded ``seed + 303`` (the reference's
        key; the draws differ from ``jax.random``), or taken from
        ``init_params`` (e.g. the reference's init, converted).  Returns
        (moe_params, per-step losses)."""
        scfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(scfg.seed + 303)
        moe_params = merge.merge_into_moe(gen, scfg.moe_cfg, base_params_list,
                                          params=init_params)
        mask, opt = tuning.init_tuning(moe_params)
        self.report["trainable_fraction"] = tuning.trainable_fraction(
            moe_params)
        self.log(f"Phase III: trainable fraction "
                 f"{self.report['trainable_fraction']:.3f}")
        steps = scfg.tune_steps
        epoch = tuning.make_tune_epoch(
            scfg.moe_cfg, mask, steps=steps,
            schedule=cosine_schedule(scfg.tune_lr, steps,
                                     warmup=max(steps // 20, 1)),
            on_step=self.on_step)
        batches = self.corpus.mixed_eval_batches(steps, scfg.tune_batch,
                                                 scfg.seq_len,
                                                 seed_salt0=10_000)
        batches = {k: v.to(self.device) for k, v in batches.items()}
        moe_params, opt, losses = epoch(moe_params, opt, batches)
        hist = [float(x) for x in losses.cpu()]  # the epoch's one sync
        self.log(f"Phase III: tune loss {hist[0]:.3f}->{hist[-1]:.3f}")
        return moe_params, hist

    # ------------------------------------------------------------------
    def run(self, uploads):
        raise NotImplementedError(
            "the full pipeline (run) is not ported yet")
