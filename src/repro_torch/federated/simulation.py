"""End-to-end DeepFusion simulation (used by the CLI and the baselines).

Counterpart of ``repro.federated.simulation``.  Builds the federated
corpus, trains the device fleet locally, runs the three-phase server
pipeline, and evaluates the resulting global MoE on per-domain held-out
data (token perplexity Eq. 3 + token accuracy, the paper's Tables I/II
metrics).

Everything runs on one ``device`` (the card unless the caller names the
CPU).  ``server_cfg.schedule`` switches local training to async
participation rounds (``async_fleet.train_fleet_async``) and ``traffic``
sets every device's straggler model.  ``n_hosts`` > 1 trains the fleet
over that many ranks of the process group (``device.train_fleet``), as
the reference shards it over a ``("hosts",)`` mesh; the server then runs
whole on every rank, with no mesh, as in the reference.
``evaluate_model(mesh=)`` takes the MoE's expert-parallel paths.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.async_fleet import train_fleet_async
from repro_torch.federated.device import (STRAGGLER_PROFILES, DeviceSpec,
                                          fleet_mesh, train_fleet)
from repro_torch.federated.server import DeepFusionServer, ServerConfig
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves


@dataclasses.dataclass
class SimulationConfig:
    n_devices: int = 8
    n_domains: int = 4
    vocab: int = 256
    seq_len: int = 64
    device_steps: int = 40
    device_batch: int = 8
    seed: int = 0
    alpha_noniid: float = 0.3


def build_corpus(sim: SimulationConfig) -> FederatedCorpus:
    """The simulation's federated corpus, as the reference builds it."""
    return FederatedCorpus.build(
        seed=sim.seed, n_devices=sim.n_devices, n_domains=sim.n_domains,
        vocab=sim.vocab, alpha=sim.alpha_noniid)


def evaluate_model(params, cfg: ModelConfig, corpus: FederatedCorpus, *,
                   seq_len: int, batch: int = 8, n_batches: int = 4,
                   mesh=None) -> Dict[str, float]:
    """Per-domain + overall token perplexity (Eq. 3) and accuracy, on the
    device the parameters lie on.  Each batch's nll and token count (f32)
    are summed as Python floats, in the reference's order.  ``params``
    are whole; on a ``mesh`` (``launch/mesh.py``) each rank keeps its
    block of the experts (``models/moe.py::shard_experts``) and the MoE
    takes its expert-parallel path, every rank the same metrics."""
    if mesh is not None:
        params = moe.shard_experts(params, cfg, mesh)
    dev = tree_leaves(params)[0].device
    out = {}
    nll_all, tok_all, acc_all = 0.0, 0.0, []
    with torch.no_grad():
        for d in range(len(corpus.domains)):
            nll, tok, accs = 0.0, 0.0, []
            for i in range(n_batches):
                b = corpus.domain_eval_batch(d, batch, seq_len, seed_salt=i)
                _, m = M.loss_fn(params, cfg,
                                 {k: v.to(dev) for k, v in b.items()},
                                 mesh=mesh)
                nll += float(m["nll"])
                tok += float(m["tokens"])
                accs.append(float(m["accuracy"]))
            out[f"ppl_domain{d}"] = math.exp(nll / max(tok, 1.0))
            out[f"logppl_domain{d}"] = nll / max(tok, 1.0)
            out[f"acc_domain{d}"] = float(np.mean(accs))
            nll_all += nll
            tok_all += tok
            acc_all.extend(accs)
    out["log_ppl"] = nll_all / max(tok_all, 1.0)
    out["ppl"] = math.exp(out["log_ppl"])
    out["accuracy"] = float(np.mean(acc_all))
    return out


def build_fleet(sim: SimulationConfig, corpus: FederatedCorpus,
                device_cfgs: Sequence[ModelConfig], *,
                full_cfgs: Optional[Sequence[ModelConfig]] = None,
                traffic=None) -> List[DeviceSpec]:
    """One ``DeviceSpec`` a device: its family drawn from
    ``np.random.default_rng(sim.seed + 42)``, its domain the corpus's.
    ``full_cfgs`` (parallel to ``device_cfgs``): the full-size model each
    family stands in for, which comm-cost accounting bills.  ``traffic``:
    a ``TrafficModel`` (or a ``STRAGGLER_PROFILES`` name) applied to
    every device, for async-round straggler simulation."""
    if full_cfgs is not None and len(full_cfgs) != len(device_cfgs):
        # fail here with names, not deep inside the fleet loop with an
        # opaque IndexError on some sampled arch id
        missing = [c.name for c in device_cfgs[len(full_cfgs):]] \
            if len(full_cfgs) < len(device_cfgs) else []
        raise ValueError(
            f"full_cfgs has {len(full_cfgs)} entries for "
            f"{len(device_cfgs)} device families "
            f"({[c.name for c in device_cfgs]}); it must be parallel to "
            f"device_cfgs" +
            (f" — missing full-size models for {missing}" if missing else ""))
    if isinstance(traffic, str):
        try:
            traffic = STRAGGLER_PROFILES[traffic]
        except KeyError:
            raise ValueError(
                f"unknown straggler profile {traffic!r}; pick one of "
                f"{sorted(STRAGGLER_PROFILES)}") from None
    rng = np.random.default_rng(sim.seed + 42)
    fleet = []
    for n in range(sim.n_devices):
        arch = int(rng.integers(len(device_cfgs)))
        fleet.append(DeviceSpec(
            device_id=n, cfg=device_cfgs[arch], arch_id=arch,
            domain_id=int(corpus.device_domain[n]),
            full_cfg=full_cfgs[arch] if full_cfgs else None,
            traffic=traffic))
    return fleet


def run_deepfusion(sim: SimulationConfig, server_cfg: ServerConfig,
                   device_cfgs: Sequence[ModelConfig], *,
                   log: Callable[[str], None] = print,
                   uploads=None, corpus=None, full_cfgs=None,
                   traffic=None, n_hosts: int = 1, device="cuda"):
    """Returns (moe_params, report); the report carries the metrics, the
    comm cost, the uploads and the corpus.  Without ``uploads`` the fleet
    is built (with ``traffic``, see ``build_fleet``) and trained first:
    ``train_fleet``, device by device, or with ``server_cfg.schedule``
    (an ``AsyncFleetConfig``) async participation rounds, whose log lands
    in ``report["fleet"]``.  ``n_hosts`` > 1 trains the fleet over that
    many ranks (the process group must be up, with as many ranks; its
    ``make_fleet_mesh`` is made, or refused, before any training; every
    rank returns the same uploads).  Everything runs on ``device``."""
    acfg = server_cfg.schedule
    if acfg is not None:
        if acfg.steps_per_round <= 0:
            # 0 = "derive from the sim": split device_steps evenly
            acfg = dataclasses.replace(
                acfg, steps_per_round=max(1, sim.device_steps // acfg.rounds))
        acfg.validate()              # refused before any training
    dev = resolve_device(device)
    corpus = corpus or build_corpus(sim)
    fleet_report = None
    if uploads is None:
        hosts = fleet_mesh(n_hosts, None, dev)
        fleet = build_fleet(sim, corpus, device_cfgs, full_cfgs=full_cfgs,
                            traffic=traffic)
        if acfg is not None:
            uploads, fleet_report = train_fleet_async(
                fleet, corpus, acfg, batch=sim.device_batch,
                seq_len=sim.seq_len, seed=sim.seed, mesh=hosts,
                log=log, device=dev)
        else:
            uploads = train_fleet(fleet, corpus, steps=sim.device_steps,
                                  batch=sim.device_batch,
                                  seq_len=sim.seq_len, seed=sim.seed,
                                  mesh=hosts, device=dev)
        for spec, up in zip(fleet, uploads):
            if not up["losses"]:
                log(f"device {spec.device_id} (arch {spec.arch_id}, "
                    f"domain {spec.domain_id}): never online")
                continue
            log(f"device {spec.device_id} (arch {spec.arch_id}, "
                f"domain {spec.domain_id}): loss "
                f"{up['losses'][0]:.3f}->{up['losses'][-1]:.3f}")
    server = DeepFusionServer(server_cfg, corpus, device_cfgs, log=log,
                              device=dev)
    moe_params, report = server.run(uploads)
    metrics = evaluate_model(moe_params, server_cfg.moe_cfg, corpus,
                             seq_len=sim.seq_len)
    report["metrics"] = metrics
    report["uploads"] = uploads
    report["corpus"] = corpus
    if fleet_report is not None:
        report["fleet"] = fleet_report
    if report.get("distill_hists"):
        finals = ", ".join(f"{h[-1]:.3f}" for h in report["distill_hists"])
        log(f"Phase II final losses per proxy: [{finals}]")
    if report.get("tune_hist"):
        log(f"Phase III tune: {report['tune_hist'][0]:.3f}->"
            f"{report['tune_hist'][-1]:.3f} over {len(report['tune_hist'])} "
            f"steps")
    log(f"global MoE: log-ppl {metrics['log_ppl']:.4f} "
        f"acc {metrics['accuracy']:.3f}")
    return moe_params, report
