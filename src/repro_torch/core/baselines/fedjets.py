"""FedJETS [Dun et al., 2023]: federated MoE with per-device pruned MoEs.

Counterpart of ``repro.core.baselines.fedjets``.  Each device hosts a
*compact MoE network pruned from the global MoE*: the full attention /
embedding backbone plus a small subset of the experts
(``experts_per_device``).  Multi-round: every round each device
downloads its pruned model, trains locally and uploads; the server
averages the backbone across all devices and each expert (and its router
column) across its owners.  The shared experts are not written back: the
global model keeps its own, as in the reference.

This is the baseline whose device-memory and communication profile the
paper attacks (Figs. 7, 8): the pruned model still carries the MoE
backbone and is several times larger than a lightweight on-device LLM.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
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

_EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


def _slice_experts(moe_params, expert_ids: Sequence[int]):
    """The global MoE pruned to the given expert slots: a new tree whose
    every leaf is a fresh tensor (local training updates in place)."""
    pruned = tree_map(torch.clone, moe_params)
    for sub in pruned["blocks"].values():
        mo = sub.get("moe")
        if mo is None:
            continue
        idx = torch.as_tensor(list(expert_ids), device=mo["router"].device)
        # router (nG, D, E) when stacked over groups, else (D, E); experts
        # (nG, E, ...)
        mo["router"] = mo["router"][:, :, idx] if mo["router"].ndim == 3 \
            else mo["router"][:, idx]
        for w in _EXPERT_LEAVES:
            mo[w] = mo[w][:, idx]
    return pruned


def _owner_average(glob, local_leaves: List, assignments, E: int, axis: int):
    """Each expert slot along ``axis`` of ``glob`` replaced by the average
    of the local slots its owners trained: f32 sums on the device in the
    reference's order (devices in fleet order, then slots; a device owns
    distinct experts, so one ``index_add_`` a device adds each slot
    once), divided as the reference's numpy loop divides (an f32 sum by
    an f64 count, rounded to f32).  Unowned experts keep ``glob``."""
    acc = glob.float().clone()
    buf = torch.zeros_like(acc)
    cnt = np.zeros(E)
    for lw, ids in zip(local_leaves, assignments):
        idx = torch.as_tensor(list(ids), device=glob.device)
        buf.index_add_(axis, idx, lw.float())
        cnt[list(ids)] += 1
    owned = [e for e in range(E) if cnt[e]]
    idx = torch.tensor(owned, dtype=torch.long, device=glob.device)
    n = torch.as_tensor(cnt[owned], dtype=torch.float64, device=glob.device)
    shape = [1] * acc.ndim
    shape[axis] = len(owned)
    acc.index_copy_(axis, idx, (buf.index_select(axis, idx).double()
                                / n.reshape(shape)).float())
    return acc.to(glob.dtype)


def _write_back(global_params, local_params_list, assignments, E: int):
    """Average the backbone across devices; write the experts and router
    columns back to their owners."""
    def strip(p):
        return dict(p, blocks={s: {k: v for k, v in b.items() if k != "moe"}
                               for s, b in p["blocks"].items()})

    avg_backbone = tree_average([strip(p) for p in local_params_list])
    out = dict(global_params)
    for k in avg_backbone:
        if k != "blocks":
            out[k] = avg_backbone[k]
    out["blocks"] = {}
    for s, gblk in global_params["blocks"].items():
        blk = dict(gblk)
        for name in blk:
            if name != "moe":
                blk[name] = avg_backbone["blocks"][s][name]
        if "moe" in blk:
            mo = dict(blk["moe"])
            for w in _EXPERT_LEAVES:
                mo[w] = _owner_average(
                    mo[w], [lp["blocks"][s]["moe"][w]
                            for lp in local_params_list], assignments, E, 1)
            r = mo["router"]
            mo["router"] = _owner_average(
                r, [lp["blocks"][s]["moe"]["router"]
                    for lp in local_params_list], assignments, E, r.ndim - 1)
            blk["moe"] = mo
        out["blocks"][s] = blk
    return out


def run_fedjets(sim: SimulationConfig, moe_cfg: ModelConfig, *,
                rounds: int = 3, local_steps: int = 8, batch: int = 8,
                lr: float = 2e-3, experts_per_device: int = 2,
                corpus: FederatedCorpus = None,
                log: Callable[[str], None] = print, device="cuda"):
    """The global MoE drawn from a ``torch.Generator`` seeded ``sim.seed +
    13``, each device's experts from ``np.random.default_rng(sim.seed +
    17)`` (the reference's keys: the expert choices are identical).  The
    local model is the MoE with ``n_experts = experts_per_device`` and
    ``top_k = min(top_k, experts_per_device)``.  Returns (params,
    report)."""
    dev = resolve_device(device)
    corpus = corpus or build_corpus(sim)
    E = moe_cfg.n_experts
    ec = experts_per_device
    local_cfg = moe_cfg.replace(n_experts=ec, top_k=min(moe_cfg.top_k, ec))
    global_params = M.init_params(moe_cfg, generator=torch.Generator(
        device=dev).manual_seed(sim.seed + 13))
    rng = np.random.default_rng(sim.seed + 17)
    comm = 0
    local_bytes = None
    for r in range(rounds):
        locals_, assignments = [], []
        for n in range(sim.n_devices):
            ids = sorted(rng.choice(E, size=ec, replace=False).tolist())
            lp = _slice_experts(global_params, ids)
            if local_bytes is None:
                local_bytes = tree_bytes(lp)
            opt = adamw_init(lp)
            for s in range(local_steps):
                b = corpus.device_batch(n, batch, sim.seq_len,
                                        step=r * local_steps + s)
                loss, _, _ = train_step(lp, opt, local_cfg,
                                        {k: v.to(dev) for k, v in b.items()},
                                        lr)
            locals_.append(lp)
            assignments.append(ids)
            comm += 2 * local_bytes
        global_params = _write_back(global_params, locals_, assignments, E)
        log(f"fedjets round {r}: loss {float(loss):.3f}")
    metrics = evaluate_model(global_params, moe_cfg, corpus,
                             seq_len=sim.seq_len)
    return global_params, {"metrics": metrics, "comm_bytes": int(comm),
                           "local_model_bytes": int(local_bytes or 0),
                           "corpus": corpus}
