"""Async / hierarchical fleet rounds with straggler + dropout dynamics.

Counterpart of ``repro.federated.async_fleet``.  Real edge fleets do
not train in one synchronous pass: devices go offline, report late, and
the server cannot wait for the slowest phone.  This module simulates the
paper's deployment story:

* **Rounds.**  Local training is cut into ``rounds`` rounds of
  ``steps_per_round`` steps.  Devices keep their OWN params between
  rounds (one-shot FL: no global pull-down), so with every device online
  in every round the final per-device params are bit-identical to one
  ``train_fleet`` run of the same total steps: round ``r`` computes
  steps ``[r*k, (r+1)*k)`` of the same schedule over the same batches.

* **Participation + stragglers.**  Each round a seeded subset of the
  fleet is selected to report (``AsyncFleetConfig.participation``);
  every online device trains, but only delivered reports reach the
  server.  ``DeviceSpec.traffic`` (dropout, lognormal latency,
  availability windows) decides who is online and who misses
  ``deadline_s``; late reports follow ``deadline_policy`` (drop /
  carry-as-stale / standby over-selection).  All draws are pure
  functions of ``(seed, device, round)``, so a dropped device's batch
  stream continues exactly where it paused.

* **Merging.**  Delivered reports merge per arch bucket through
  ``server.FleetAggregator`` with FedAsync staleness discounts.
  ``hierarchical=True`` routes device reports to per-bucket sub-servers
  and ships only each bucket's aggregate across the global link: same
  merge math, cheaper WAN.

* **Comm accounting** bills only devices that delivered a report that
  round (``device_upload_bytes`` of the configured model); hierarchical
  mode splits edge-tier and global-tier bytes.

The reference vmaps each bucket's round and masks offline lanes; here
every device's params and moments stay resident on ``device`` across
rounds and an offline device is simply not stepped (no copy of its
state, no NaN loss lane).  A report that arrives late carries a copy of
the params it was trained to, since training goes on in place.

Multi-host (``n_hosts`` > 1 or a ``("hosts",)`` ``mesh``): the round's
schedule (selection, dropout, deadlines, traffic) comes from the seeds
alone, so every rank draws the same one; a rank keeps and trains only
its own lanes' state across rounds (``device.FleetHosts``), every report
reaches every rank from its owner before ``FleetAggregator`` merges it,
so the aggregates are equal on every rank, and the final uploads are
shared as ``train_fleet``'s are.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.device import (DeviceSpec, FleetHosts,
                                          _device_init, _upload,
                                          device_upload_bytes, fleet_buckets,
                                          fleet_mesh, model_param_bytes,
                                          sample_traffic, train_round)
from repro_torch.federated.server import AsyncFleetConfig, FleetAggregator
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def selected_devices(fleet: Sequence[DeviceSpec], acfg: AsyncFleetConfig,
                     round_idx: int) -> set:
    """The device ids sampled to report in ``round_idx``: ``ceil(
    participation * N)`` (over-selected by ``over_select`` under
    ``standby``), drawn from ``default_rng((seed, 424_242, round))``
    over the sorted ids, independent of fleet order."""
    n_fleet = len(fleet)
    target = max(1, math.ceil(acfg.participation * n_fleet))
    n_sel = target
    if acfg.deadline_policy == "standby":
        n_sel = min(n_fleet, math.ceil(target * (1 + acfg.over_select)))
    ids = sorted(s.device_id for s in fleet)
    if n_sel >= n_fleet:
        return set(ids)
    rng = np.random.default_rng((acfg.seed, 424_242, round_idx))
    return set(np.asarray(ids)[
        rng.choice(n_fleet, size=n_sel, replace=False)].tolist())


def train_fleet_async(fleet: Sequence[DeviceSpec], corpus: FederatedCorpus,
                      acfg: AsyncFleetConfig, *, batch: int, seq_len: int,
                      lr: float = 3e-3, seed: int = 0,
                      state_policy: str = "", n_hosts: int = 1, mesh=None,
                      log: Callable[[str], None] = lambda s: None,
                      device="cuda") -> Tuple[List[Dict], Dict]:
    """Returns ``(uploads, fleet_report)``.

    ``uploads`` matches ``train_fleet``'s contract (fleet order, same
    payloads; a device's ``losses`` only cover the rounds it trained).
    ``fleet_report`` carries the reference's per-round log: participation,
    staleness histogram, effective comm bytes and the per-bucket
    staleness-merged aggregates.  Everything runs on ``device``.
    """
    acfg.validate()
    dev = resolve_device(device)
    hosts = FleetHosts(fleet, fleet_mesh(n_hosts, mesh, dev))
    k = acfg.steps_per_round
    total_steps = acfg.rounds * k
    warmup = max(total_steps // 20, 1)
    n_fleet = len(fleet)
    by_id = {s.device_id: s for s in fleet}

    buckets = fleet_buckets(fleet)
    state = {s.device_id: _device_init(s, seed, dev,
                                       state_policy=state_policy)
             for specs in buckets.values() for s in specs
             if hosts.mine(s.device_id)}
    local_step = {s.device_id: 0 for s in fleet}
    losses: Dict[int, List[torch.Tensor]] = {s.device_id: [] for s in fleet}

    aggregator = FleetAggregator(acfg)
    pending: List[Dict] = []     # late reports carried across rounds
    rounds_log: List[Dict] = []
    comm_global = 0
    comm_edge = 0
    lost_reports = 0

    for r in range(acfg.rounds):
        traffic = {s.device_id: sample_traffic(s, r, acfg.seed)
                   for s in fleet}
        online = {d: t[1] for d, t in traffic.items()}
        selected = selected_devices(fleet, acfg, r)

        # -- every online device trains its round (on the rank that owns
        # it); offline ones wait --
        for specs in buckets.values():
            for s in specs:
                d = s.device_id
                if not online[d]:
                    continue
                if d in state:
                    params, opt = state[d]
                    losses[d].append(train_round(
                        s, corpus, params, opt, start=local_step[d], steps=k,
                        total_steps=total_steps, batch=batch,
                        seq_len=seq_len, lr=lr, warmup=warmup, device=dev))
                local_step[d] += k

        # -- reports: selected ∩ online devices ship their fresh state --
        fresh, n_late_dropped = [], 0
        for cfg, specs in buckets.items():
            for s in specs:
                d = s.device_id
                if d not in selected or not online[d]:
                    continue
                latency = traffic[d][0]
                late_by = (0 if latency <= acfg.deadline_s
                           else int(math.ceil(latency / acfg.deadline_s)) - 1)
                if late_by and acfg.deadline_policy in ("drop", "standby"):
                    n_late_dropped += 1
                    lost_reports += 1
                    continue
                params = state[d][0] if d in state else None
                if late_by and params is not None:
                    # a late report is the state it was trained to, held
                    # while the device trains on in place
                    params = tree_map(lambda t: t.detach().clone(), params)
                report = {
                    "device_id": d,
                    "bucket": cfg,
                    "params": params,       # None on the other ranks
                    "trained_round": r,
                    "arrival_round": r + late_by,
                    "bytes": device_upload_bytes(s.comm_cfg),
                }
                (pending if late_by else fresh).append(report)

        # -- merge everything deliverable this round, per bucket --
        matured = [p for p in pending if p["arrival_round"] <= r]
        pending = [p for p in pending if p["arrival_round"] > r]
        deliverable = fresh + matured
        per_bucket: Dict = {}
        for rep in deliverable:
            rep["staleness"] = r - rep["trained_round"]
            # the report reaches every rank from the one that trained it
            rep["params"], _ = hosts.share(by_id[rep["device_id"]],
                                           rep["params"], device=dev)
            per_bucket.setdefault(rep["bucket"], []).append(rep)
        round_bytes = 0
        for cfg, reps in per_bucket.items():
            aggregator.merge_round(cfg, reps)
            dev_bytes = sum(rep["bytes"] for rep in reps)
            if acfg.hierarchical:
                # devices -> sub-server ride the cheap edge tier; only the
                # bucket aggregate crosses the global link (billed at the
                # bucket's configured full-size model)
                comm_edge += dev_bytes
                agg_bytes = model_param_bytes(
                    by_id[reps[0]["device_id"]].comm_cfg)
                comm_global += agg_bytes
                round_bytes += agg_bytes
            else:
                comm_global += dev_bytes
                round_bytes += dev_bytes
        for rep in deliverable:      # merged: free the copies
            rep["params"] = None

        stale_merged = len(matured)
        n_online = sum(online.values())
        n_reported = len(deliverable)
        rounds_log.append({
            "round": r,
            "online": n_online,
            "selected": len(selected),
            "reported": n_reported,
            "stale_merged": stale_merged,
            "late_dropped": n_late_dropped,
            "participation_rate": round(n_reported / n_fleet, 4),
            "comm_bytes": int(round_bytes),
        })
        log(f"round {r}: online {n_online}/{n_fleet}, selected "
            f"{len(selected)}, reported {n_reported} "
            f"({stale_merged} stale, {n_late_dropped} late-dropped), "
            f"{round_bytes} B")

    lost_reports += len(pending)     # never matured before the run ended
    staleness = aggregator.merged_staleness
    uploads = []
    for s in fleet:
        d = s.device_id
        own = state.pop(d, (None,))[0]
        ls = losses[d]
        params, ls = hosts.share(
            s, own, local_step[d],
            torch.cat(ls) if ls else torch.zeros(0, device=dev), device=dev)
        uploads.append(_upload(s, corpus, params, ls))

    fleet_report = {
        "mode": "hierarchical" if acfg.hierarchical else "flat",
        "rounds": rounds_log,
        "participation_rate": round(
            float(np.mean([x["participation_rate"] for x in rounds_log])), 4),
        "staleness_hist": aggregator.staleness_histogram(),
        "staleness_p95": (float(np.percentile(staleness, 95))
                          if staleness else 0.0),
        "merged_reports": len(staleness),
        "lost_reports": int(lost_reports),
        "comm_bytes_global": int(comm_global),
        "comm_bytes_edge": int(comm_edge),
        "aggregates": {cfg.name: aggregator.aggregates[cfg]
                       for cfg in aggregator.aggregates},
        "n_hosts": hosts.n,
    }
    return uploads, fleet_report
