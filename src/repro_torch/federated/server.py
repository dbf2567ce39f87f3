"""DeepFusion central server (paper Fig. 3): the three-phase pipeline.

Counterpart of ``repro.federated.server``.

Phase I   — local knowledge clustering: cluster uploaded on-device LLMs
            by data embeddings into K domains, weight-average per cluster
            into proxy models m̄_i (§IV.B; ``core/clustering.py``,
            ``core/proxy.py``).
Phase II  — cross-architecture KD: distill each proxy into a dense "MoE
            base model" M_i with the VAA module (§IV.C, Eq. 7-11) on
            public server data (``core/distill.py``, ``core/vaa.py``).
Phase III — merge the K base models into the global MoE (Fig. 6,
            ``core/merge.py``) and tune it with frozen experts (§IV.D,
            ``core/tuning.py``).

The reference compiles each Phase II and Phase III epoch into one
scanned program; the port runs the same steps eagerly
(``optim.loops.scan_epoch``) with the same seeds, schedules and batches.
Its own random inits come from ``torch.Generator``s seeded as the
reference's keys (the draws differ from ``jax.random``), or are passed
in (e.g. the reference's, converted).

The async fleet schedule (``AsyncFleetConfig``) and its staleness-
discounted merge (``FleetAggregator``) serve ``async_fleet.py``;
``ServerConfig.state_policy`` sets Phase II's AdamW moment storage.

``mesh`` (a ``("data", "model")`` ``DeviceMesh``, ``launch/mesh.py``)
runs Phases II and III over the ranks of the process group, as the
reference passes its mesh to the distill and tune epochs: Phase II's
dense teacher and student run whole on every rank (the mesh changes
nothing there), and Phase III cuts the merged MoE's experts to each
rank's block (``models/moe.py::shard_experts``, their AdamW moments by
``shard_opt_state``), tunes through the expert-parallel path and gathers
the experts back (``gather_experts``), so ``run`` returns whole
parameters, the same on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import clustering, distill, merge, proxy, tuning
from repro_torch.core import vaa as vaa_mod
from repro_torch.data.federated import FederatedCorpus
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_average, tree_map


@dataclasses.dataclass(frozen=True)
class AsyncFleetConfig:
    """Participation schedule for async / hierarchical fleet rounds.

    Per round a sampled subset of the fleet reports its local update;
    the server merges deliverable reports with FedAsync-style
    staleness-discounted weights ``alpha / (1 + staleness)^
    staleness_power`` (``staleness_weight``).  Reports later than
    ``deadline_s`` are handled by ``deadline_policy``:

      * ``"drop"``    — the late update is discarded;
      * ``"stale"``   — it is carried and merged in a later round with
                        its accrued staleness discount;
      * ``"standby"`` — the round over-selects ``over_select`` extra
                        standby devices so the on-time quorum still
                        meets the participation target; late reports
                        are dropped.

    ``hierarchical`` interposes one sub-server per arch bucket: devices
    report edge-locally and only each bucket's merged aggregate crosses
    the global link (comm accounting bills the two tiers separately; the
    merge math is flat mode's).
    """
    rounds: int = 3
    steps_per_round: int = 10
    participation: float = 1.0     # fraction of the fleet sampled per round
    alpha: float = 0.6             # FedAsync base mixing weight
    staleness_power: float = 0.5   # a in alpha / (1 + staleness)^a
    deadline_s: float = float("inf")
    deadline_policy: str = "stale"  # "drop" | "stale" | "standby"
    over_select: float = 0.25      # standby headroom (deadline_policy=standby)
    server_momentum: float = 0.0   # G <- mom*G + (1-mom)*round_average
    hierarchical: bool = False     # per-arch-bucket sub-servers (edge tier)
    seed: int = 0

    def validate(self) -> "AsyncFleetConfig":
        if self.deadline_policy not in ("drop", "stale", "standby"):
            raise ValueError(
                f"deadline_policy {self.deadline_policy!r} not in "
                "('drop', 'stale', 'standby')")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError("participation must be in (0, 1]")
        if self.rounds < 1 or self.steps_per_round < 1:
            raise ValueError("rounds and steps_per_round must be >= 1")
        return self


def staleness_weight(alpha: float, staleness: float, power: float) -> float:
    """FedAsync mixing weight for a report ``staleness`` rounds old."""
    return float(alpha) / (1.0 + float(staleness)) ** float(power)


class FleetAggregator:
    """Staleness-discounted per-arch-bucket merging (FedAsync-style).

    Each round's deliverable reports for a bucket are combined into a
    weighted average (weights ``staleness_weight(alpha, tau, power)``)
    and mixed into the bucket's running aggregate under
    ``server_momentum``.  All-fresh reports get equal weights, computed
    as the plain ``tree_average``, so a round with full on-time
    participation is the synchronous FedAvg merge bit for bit.  The
    weighted sum runs in f32 in device-id order, as the reference's
    Python ``sum`` adds (``0 + w0·x0 + w1·x1 ...``).  Aggregates never
    share storage with a report: the port trains parameters in place.
    """

    def __init__(self, acfg: AsyncFleetConfig):
        self.acfg = acfg
        self.aggregates: Dict = {}       # bucket key -> merged params
        self.merged_staleness: List[int] = []

    @torch.no_grad()
    def merge_round(self, bucket_key, reports: Sequence[Dict]):
        """``reports``: [{"device_id", "params", "staleness"}], merged in
        device-id order."""
        if not reports:
            return self.aggregates.get(bucket_key)
        reports = sorted(reports, key=lambda r: r["device_id"])
        ws = [staleness_weight(self.acfg.alpha, r["staleness"],
                               self.acfg.staleness_power) for r in reports]
        self.merged_staleness.extend(int(r["staleness"]) for r in reports)
        if len(set(ws)) == 1:
            # uniform weights ARE the plain average: short-circuiting
            # keeps the all-fresh round bitwise equal to FedAvg
            avg = tree_average([r["params"] for r in reports])
            if len(reports) == 1:       # tree_average hands its one tree back
                avg = tree_map(torch.clone, avg)
        else:
            total = sum(ws)
            wn = [w / total for w in ws]

            def weighted(*xs):
                acc = 0
                for w, x in zip(wn, xs):
                    acc = acc + w * x.float()
                return acc.to(xs[0].dtype)

            avg = tree_map(weighted, *[r["params"] for r in reports])
        prev = self.aggregates.get(bucket_key)
        mom = self.acfg.server_momentum
        if prev is not None and mom > 0.0:
            avg = tree_map(lambda g, a: (mom * g.float() +
                                         (1.0 - mom) * a.float()).to(a.dtype),
                           prev, avg)
        self.aggregates[bucket_key] = avg
        return avg

    def staleness_histogram(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for t in self.merged_staleness:
            hist[t] = hist.get(t, 0) + 1
        return hist


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
    # AdamW moment storage for Phase II distillation: '' | 'bf16' |
    # 'int8' (see optim.adamw.resolve_moment_policy)
    state_policy: str = ""
    # async fleet participation schedule (None = one-shot sync training)
    schedule: Optional[AsyncFleetConfig] = None


class DeepFusionServer:
    """``device`` defaults to the card; pass ``device="cpu"`` to run on
    the CPU (on a ``mesh``, the rank's device of the mesh's type).
    ``on_step(step, loss)``, if given, runs after every Phase II and
    Phase III step (e.g. to time it)."""

    def __init__(self, cfg: ServerConfig, corpus: FederatedCorpus,
                 device_cfgs: Sequence[ModelConfig], *, mesh=None,
                 log: Callable[[str], None] = lambda s: None,
                 device="cuda", on_step: Optional[Callable] = None):
        self.device = resolve_device(device)
        if mesh is not None and getattr(mesh, "device_type",
                                        None) != self.device.type:
            raise ValueError(f"a server mesh is a DeviceMesh of the "
                             f"server's device type ({self.device.type}), "
                             f"not {mesh!r}")
        self.mesh = mesh
        self.cfg = cfg
        self.corpus = corpus
        self.device_cfgs = list(device_cfgs)
        self.log = log
        self.on_step = on_step
        self.report: Dict = {}

    # ------------------------------------------------------------------
    # Phase I
    # ------------------------------------------------------------------
    def cluster(self, uploads: Sequence[Dict]):
        """K = the MoE's expert count; KMeans over the uploads' data
        embeddings, architecture-constrained, then one proxy per
        non-empty cluster.  Returns (proxies, ClusterResult)."""
        K = self.cfg.moe_cfg.n_experts
        emb = np.stack([u["embedding"] for u in uploads])
        arch_ids = [u["arch_id"] for u in uploads]
        result = clustering.cluster_devices(emb, K, arch_ids=arch_ids,
                                            seed=self.cfg.seed)
        proxies = proxy.build_proxies([u["params"] for u in uploads], result,
                                      arch_ids)
        self.report["n_clusters"] = len(proxies)
        self.report["cluster_sizes"] = [len(p["members"]) for p in proxies]
        self.log(f"Phase I: {len(uploads)} uploads -> {len(proxies)} proxies "
                 f"{self.report['cluster_sizes']}")
        return proxies, result

    # ------------------------------------------------------------------
    # Phase II
    # ------------------------------------------------------------------
    def distill_proxy(self, proxy_item: Dict, base_cfg: ModelConfig, *,
                      init_params=None, vaa_params=None,
                      seed_offset: int = 0):
        """Distill one proxy (teacher, its parameters on ``self.device``)
        into one MoE base model (student) for ``distill_steps`` steps.
        The student's init is drawn from a ``torch.Generator`` seeded
        ``seed + 101 + seed_offset`` and the VAA module's from ``seed +
        202 + seed_offset`` (the reference's keys), or copied from
        ``init_params`` / ``vaa_params``, which stay as they are (the
        update works in place).  Returns (student params, per-step
        losses)."""
        scfg = self.cfg
        dev = self.device
        t_cfg = self.device_cfgs[proxy_item["arch"]]
        t_params = proxy_item["params"]

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(
                scfg.seed + offset + seed_offset)

        def copy(tree):
            return tree_map(lambda t: t.detach().to(dev, copy=True), tree)

        s_params = copy(init_params) if init_params is not None else \
            M.init_params(base_cfg, generator=gen(101))
        if vaa_params is not None:
            vaa_params = copy(vaa_params)
        else:
            vaa_params = vaa_mod.init_vaa(
                gen(202), n_stages=scfg.n_stages, d_student=base_cfg.d_model,
                d_teacher=t_cfg.d_model, d=scfg.vaa_dim, p_q=scfg.p_q)
        trainable = {"student": s_params, "vaa": vaa_params}
        opt = adamw_init(trainable, policy=scfg.state_policy)
        steps = scfg.distill_steps
        epoch = distill.make_distill_epoch(
            base_cfg, t_cfg, steps=steps,
            schedule=cosine_schedule(scfg.distill_lr, steps,
                                     warmup=max(steps // 20, 1)),
            alpha=scfg.alpha, beta=scfg.beta, temperature=scfg.temperature,
            n_stages=scfg.n_stages, vaa_heads=scfg.vaa_heads, p_q=scfg.p_q,
            optimizer_update=adamw_update, on_step=self.on_step,
            mesh=self.mesh)
        batches = self.corpus.mixed_eval_batches(steps, scfg.distill_batch,
                                                 scfg.seq_len)
        batches = {k: v.to(dev) for k, v in batches.items()}
        trainable, opt, losses = epoch(trainable, opt, t_params, batches)
        hist = [float(x) for x in losses.cpu()]  # the epoch's one sync
        self.log(f"Phase II: proxy c{proxy_item['cluster']} distilled "
                 f"loss {hist[0]:.3f}->{hist[-1]:.3f}")
        return trainable["student"], hist

    # ------------------------------------------------------------------
    # Phase III
    # ------------------------------------------------------------------
    def merge_and_tune(self, base_params_list: List, *, init_params=None):
        """Merge the base models (on ``self.device``) into the global MoE
        and tune it for ``tune_steps`` steps.  The MoE's own init is drawn
        from a ``torch.Generator`` seeded ``seed + 303`` (the reference's
        key; the draws differ from ``jax.random``), or taken from
        ``init_params`` (e.g. the reference's init, converted).  On the
        server's mesh the experts and their moments are cut to the rank's
        block for the tune and gathered back after it.  Returns
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
        if self.mesh is not None:
            moe_params = moe.shard_experts(moe_params, scfg.moe_cfg,
                                           self.mesh)
            opt = moe.shard_opt_state(opt, scfg.moe_cfg, self.mesh)
        steps = scfg.tune_steps
        epoch = tuning.make_tune_epoch(
            scfg.moe_cfg, mask, steps=steps,
            schedule=cosine_schedule(scfg.tune_lr, steps,
                                     warmup=max(steps // 20, 1)),
            on_step=self.on_step, mesh=self.mesh)
        batches = self.corpus.mixed_eval_batches(steps, scfg.tune_batch,
                                                 scfg.seq_len,
                                                 seed_salt0=10_000)
        batches = {k: v.to(self.device) for k, v in batches.items()}
        moe_params, opt, losses = epoch(moe_params, opt, batches)
        del opt
        if self.mesh is not None:
            moe_params = moe.gather_experts(moe_params, scfg.moe_cfg,
                                            self.mesh)
        hist = [float(x) for x in losses.cpu()]  # the epoch's one sync
        self.log(f"Phase III: tune loss {hist[0]:.3f}->{hist[-1]:.3f}")
        return moe_params, hist

    # ------------------------------------------------------------------
    def run(self, uploads: Sequence[Dict]):
        """Full pipeline: Phase I, Phase II per proxy (``seed_offset`` =
        its index), Phase III.  Returns (moe_params, report)."""
        t0 = time.time()
        proxies, _ = self.cluster(uploads)
        base_cfg = merge.base_config_of(self.cfg.moe_cfg)
        bases, distill_hists = [], []
        for i, p in enumerate(proxies):
            s_params, hist = self.distill_proxy(p, base_cfg, seed_offset=i)
            bases.append(s_params)
            distill_hists.append(hist)
        moe_params, tune_hist = self.merge_and_tune(bases)
        self.report["distill_hists"] = distill_hists
        self.report["tune_hist"] = tune_hist
        self.report["comm_bytes"] = int(sum(u["upload_bytes"]
                                            for u in uploads))
        self.report["wall_s"] = time.time() - t0
        return moe_params, self.report
