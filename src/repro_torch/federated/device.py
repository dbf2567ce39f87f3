"""Edge-device simulation: local on-device LLM training (paper §IV.A).

Counterpart of ``repro.federated.device``.  Each device trains its
on-device LLM on private local data and uploads it once, with a
low-rank data embedding for clustering.  The reference compiles the
epoch into one scanned program and vmaps it over same-arch devices;
the port runs the same step in an eager Python loop
(``optim.loops.scan_epoch``), one device after another, with the same
seeds, batches, schedule and per-step losses.

Communication cost is billed from the configured model's true
parameter count, computed from meta tensors (no allocation).

``TrafficModel`` / ``sample_traffic`` draw each device's per-round
latency and availability for the async rounds (``async_fleet.py``), from
the reference's numpy generators, so the draws are the same floats; a
round of one device is ``train_round``.  ``state_policy`` ('' | 'bf16' |
'int8') sets the AdamW moment storage.

Multi-host fleets (``n_hosts`` / a ``("hosts",)`` ``mesh`` from
``launch/mesh.py::make_fleet_mesh``) run one rank a host: a rank trains
only the lanes of each bucket that ``sharding.rules.host_lanes`` gives
it (the reference's ``fleet_specs`` layout, its padding lanes left out),
so it holds about ``1/n_hosts`` of the fleet's state, and then every
upload goes from its owner to every rank, a broadcast a tensor
(``FleetHosts``).  Lanes are independent, so the uploads equal
``n_hosts=1``'s bit for bit.  Not ported: the vmapped bucket (devices
run one after another).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.federated import FederatedCorpus
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               scan_epoch)
from repro_torch.sharding import rules
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_bytes, tree_leaves, tree_map,
                                      tree_unflatten_like)


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Seeded per-round traffic behaviour of one simulated edge device.

    Report latency is lognormal (``median_latency_s`` scaled by
    ``exp(sigma * N(0,1))``, the long straggler tail real fleets show),
    each round the device is offline with probability ``dropout_p``, and
    ``avail_period``/``avail_duty`` model a battery / charging window:
    the device is only reachable during the first ``avail_duty`` rounds
    of every ``avail_period`` (0 = always available).  All draws are
    pure functions of ``(seed, device_id, round)`` (``sample_traffic``).
    """
    median_latency_s: float = 1.0
    latency_sigma: float = 0.5
    dropout_p: float = 0.0
    avail_period: int = 0
    avail_duty: int = 0


# named presets for --straggler-profile
STRAGGLER_PROFILES = {
    "none": TrafficModel(),
    "mild": TrafficModel(median_latency_s=1.0, latency_sigma=0.5,
                         dropout_p=0.1),
    "harsh": TrafficModel(median_latency_s=1.5, latency_sigma=1.0,
                          dropout_p=0.3, avail_period=8, avail_duty=6),
}


@dataclasses.dataclass
class DeviceSpec:
    device_id: int
    cfg: ModelConfig            # the on-device LLM this device runs
    arch_id: int                # index into the device-model family list
    domain_id: int              # ground-truth knowledge domain (hidden)
    # full-size variant of ``cfg`` when the simulation trains a reduced
    # stand-in; comm-cost accounting (Fig. 8) bills this one.
    full_cfg: Optional[ModelConfig] = None
    # straggler/dropout behaviour for async rounds (None = ideal link)
    traffic: Optional[TrafficModel] = None

    @property
    def comm_cfg(self) -> ModelConfig:
        return self.full_cfg or self.cfg


def sample_traffic(spec: DeviceSpec, round_idx: int, seed: int):
    """Deterministic ``(latency_s, online)`` draw for (device, round),
    keyed on ``(seed, 7_700_000 + device_id, round)`` only: a device that
    dropped out rejoins with the latency/dropout stream it would always
    have had."""
    tm = spec.traffic or TrafficModel()
    if tm.avail_period and (round_idx % tm.avail_period) >= tm.avail_duty:
        return 0.0, False
    rng = np.random.default_rng(
        (seed, 7_700_000 + spec.device_id, round_idx))
    dropped = bool(rng.random() < tm.dropout_p)
    latency = float(tm.median_latency_s * np.exp(tm.latency_sigma *
                                                 rng.standard_normal()))
    return latency, not dropped


@functools.lru_cache(maxsize=64)
def model_param_bytes(cfg: ModelConfig) -> int:
    """Weight bytes of ``cfg`` at its configured dtype, from meta tensors
    (shapes only, nothing allocated)."""
    return tree_bytes(M.init_params(cfg, generator="meta"))


def device_upload_bytes(cfg: ModelConfig, embedding_dim: int = 32) -> int:
    """One-shot upload = model weights + the tiny data embedding (Eq. 5)."""
    return model_param_bytes(cfg) + embedding_dim * 4


# ---------------------------------------------------------------------------
# local training
# ---------------------------------------------------------------------------

def train_step(params, opt, cfg: ModelConfig, batch, lr: float, *,
               weight_decay: float = 0.0, freeze_mask=None, mesh=None):
    """One training step, in place on ``params`` and ``opt``: the LM loss,
    its gradient with respect to every parameter (frozen ones included:
    the clip norm covers them), and AdamW with ``freeze_mask``.  On a
    ``mesh`` the MoE's experts are the rank's block (``models/moe.py::
    shard_experts``, moments too) and the clip's norm sums each block
    over the ranks that hold the others (``moe.clip_shards``).  Returns
    (loss, metrics, stats), tensors on the device."""
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = M.loss_fn(params, cfg, batch, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    del leaves
    _, _, stats = adamw_update(tree_unflatten_like(params, grads), opt,
                               params, lr=lr, weight_decay=weight_decay,
                               freeze_mask=freeze_mask,
                               shards=moe.clip_shards(params, cfg, mesh))
    return loss.detach(), metrics, stats


def _step_core(cfg: ModelConfig):
    """The one local-training step (weight decay 0, as in the reference)."""

    def step(carry, b, lr_now):
        params, opt = carry
        loss, _, _ = train_step(params, opt, cfg, b, lr_now)
        return (params, opt), loss

    return step


def _device_init(spec: DeviceSpec, seed: int, device, params=None,
                 state_policy: str = ""):
    """Parameters drawn from a ``torch.Generator`` seeded
    ``seed * 100003 + device_id`` (the reference's key; the draws differ
    from ``jax.random``), or ``params`` as given, and fresh AdamW state."""
    if params is None:
        gen = torch.Generator(device=device).manual_seed(
            seed * 100003 + spec.device_id)
        params = M.init_params(spec.cfg, generator=gen)
    return params, adamw_init(params, policy=state_policy)


def _upload(spec: DeviceSpec, corpus: FederatedCorpus, params,
            losses) -> Dict:
    return {
        "params": params,
        "embedding": corpus.device_embedding(spec.device_id),
        "losses": [float(x) for x in losses.cpu()],  # the epoch's one sync
        "upload_bytes": device_upload_bytes(spec.comm_cfg),
        "arch_id": spec.arch_id,
        "device_id": spec.device_id,
    }


def train_round(spec: DeviceSpec, corpus: FederatedCorpus, params, opt, *,
                start: int, steps: int, total_steps: int, batch: int,
                seq_len: int, lr: float, warmup: int, device):
    """``steps`` local steps of one device, in place on ``params`` and
    ``opt``: steps ``[start, start + steps)`` of a ``total_steps``-step
    run, on that slice of the device's batch stream and of the cosine
    schedule over the whole horizon, so rounds of one device chain into
    its one-shot epoch step for step.  Returns the per-step losses (a
    tensor on the device)."""
    epoch = scan_epoch(_step_core(spec.cfg),
                       cosine_schedule(lr, total_steps, warmup=warmup), steps)
    batches = {k: v.to(device) for k, v in corpus.device_batches(
        spec.device_id, steps, batch, seq_len, start=start).items()}
    _, losses = epoch((params, opt), batches, start)
    return losses


def train_device(spec: DeviceSpec, corpus: FederatedCorpus, *, steps: int,
                 batch: int, seq_len: int, lr: float = 3e-3, seed: int = 0,
                 compiled: bool = True, state_policy: str = "",
                 device="cuda", params=None) -> Dict:
    """Local training.  Returns {"params", "embedding", "losses", ...}.

    The warmup is ``max(steps // 20, 1)`` and the counter starts at 0, so
    step 0 runs at lr = 0, as in the reference.  ``compiled`` is kept for
    the reference's signature and changes nothing: the reference's
    scanned epoch and per-step loop are one eager loop here, over the
    stacked epoch of batches (equal to the per-step batches).  ``params``
    (on ``device``) replaces the seeded init, e.g. with converted
    reference weights.  ``state_policy`` ('' | 'bf16' | 'int8') sets the
    AdamW moment storage (``optim.adamw.resolve_moment_policy``).
    """
    del compiled
    return _upload(spec, corpus, *_train_lane(
        spec, corpus, steps=steps, batch=batch, seq_len=seq_len, lr=lr,
        seed=seed, state_policy=state_policy,
        device=resolve_device(device), params=params))


def _train_lane(spec: DeviceSpec, corpus: FederatedCorpus, *, steps: int,
                batch: int, seq_len: int, lr: float, seed: int,
                state_policy: str, device, params=None):
    """``train_device``'s run: (params, per-step losses on the device)."""
    params, opt = _device_init(spec, seed, device, params, state_policy)
    losses = train_round(spec, corpus, params, opt, start=0, steps=steps,
                         total_steps=steps, batch=batch, seq_len=seq_len,
                         lr=lr, warmup=max(steps // 20, 1), device=device)
    return params, losses


def fleet_buckets(fleet: Sequence[DeviceSpec]
                  ) -> Dict[ModelConfig, List[DeviceSpec]]:
    """Group the fleet by (hashable) ``ModelConfig``, preserving order."""
    buckets: Dict[ModelConfig, List[DeviceSpec]] = {}
    for spec in fleet:
        buckets.setdefault(spec.cfg, []).append(spec)
    return buckets


class FleetHosts:
    """Where a fleet's lanes live on a ``("hosts",)`` mesh
    (``launch/mesh.py::make_fleet_mesh``; None: every lane on this rank,
    nothing shared).  Host ``h`` is rank ``mesh.mesh[h]`` and owns the
    lanes ``rules.host_lanes`` gives it in each bucket; ``share`` hands a
    lane's tensors from its owner to every rank of the process group."""

    def __init__(self, fleet: Sequence[DeviceSpec], mesh=None):
        self.mesh = mesh
        self.n = 1 if mesh is None else mesh.size()
        self.ranks = [0] if mesh is None else mesh.mesh.flatten().tolist()
        coord = None if mesh is None else mesh.get_coordinate()
        self.me = 0 if mesh is None else (None if coord is None
                                          else coord[0])
        self.host = {}
        for specs in fleet_buckets(fleet).values():
            for h in range(self.n):
                for i in rules.host_lanes(len(specs), self.n, h):
                    self.host[specs[i].device_id] = h

    def mine(self, device_id: int) -> bool:
        return self.host[device_id] == self.me

    def share(self, spec: DeviceSpec, params, n_losses=None, losses=None,
              device="cpu"):
        """(params, losses) of ``spec``'s lane on every rank: the owner's
        own, broadcast leaf by leaf (``n_losses`` f32 losses after them);
        other ranks pass None and get tensors of ``spec.cfg``'s shapes on
        ``device``.  Without a mesh, what was passed."""
        if self.mesh is None:
            return params, losses
        if not self.mine(spec.device_id):
            params = tree_map(
                lambda m: torch.empty(m.shape, dtype=m.dtype, device=device),
                M.init_params(spec.cfg, generator="meta"))
            if n_losses is not None:
                losses = torch.empty(n_losses, dtype=torch.float32,
                                     device=device)
        src = self.ranks[self.host[spec.device_id]]
        with torch.no_grad():        # the owner's leaves may require grad
            for t in tree_leaves(params):
                dist.broadcast(t, src=src)
            if n_losses:
                dist.broadcast(losses, src=src)
        return params, losses


def fleet_mesh(n_hosts: int, mesh, device):
    """The fleet's ``("hosts",)`` mesh: ``mesh``, or for ``n_hosts`` > 1
    ``make_fleet_mesh(n_hosts)`` on ``device``'s backend (the process
    group must be up), else None."""
    if mesh is None and n_hosts > 1:
        from repro_torch.launch.mesh import make_fleet_mesh
        mesh = make_fleet_mesh(n_hosts, device=torch.device(device).type)
    dims = getattr(mesh, "mesh_dim_names", None)
    if mesh is not None and tuple(dims or ()) != ("hosts",):
        raise ValueError(f"a fleet mesh is a DeviceMesh of the one dim "
                         f"('hosts',), not {mesh!r}")
    return mesh


def train_fleet(fleet: Sequence[DeviceSpec], corpus: FederatedCorpus, *,
                steps: int, batch: int, seq_len: int, lr: float = 3e-3,
                seed: int = 0, state_policy: str = "", n_hosts: int = 1,
                mesh=None, device="cuda") -> List[Dict]:
    """Every device's ``train_device``, bucket by bucket and in fleet
    order within a bucket (the reference vmaps each bucket; its lanes are
    independent, so the uploads are the same).  ``state_policy`` sets
    every device's moment storage.  ``n_hosts`` > 1 (or a ``("hosts",)``
    ``mesh``): this rank trains its own lanes only (``FleetHosts``), and
    every rank returns every upload.  Returns uploads in the fleet's
    original order."""
    dev = resolve_device(device)
    hosts = FleetHosts(fleet, fleet_mesh(n_hosts, mesh, dev))
    run = dict(steps=steps, batch=batch, seq_len=seq_len, lr=lr, seed=seed,
               state_policy=state_policy, device=dev)
    trained = {}
    for specs in fleet_buckets(fleet).values():
        for spec in specs:
            if hosts.mine(spec.device_id):
                trained[spec.device_id] = _train_lane(spec, corpus, **run)
    uploads = []
    for spec in fleet:
        params, losses = trained.pop(spec.device_id, (None, None))
        uploads.append(_upload(spec, corpus, *hosts.share(
            spec, params, steps, losses, device=dev)))
    return uploads
