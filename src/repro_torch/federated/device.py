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

Not ported yet: ``TrafficModel`` / ``sample_traffic`` (async rounds),
the vmapped fleet, multi-host sharding and the bf16/int8 moment
policies (``state_policy`` other than ``""`` raises).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.data.federated import FederatedCorpus
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               scan_epoch)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (tree_bytes, tree_leaves,
                                      tree_unflatten_like)


@dataclasses.dataclass
class DeviceSpec:
    device_id: int
    cfg: ModelConfig            # the on-device LLM this device runs
    arch_id: int                # index into the device-model family list
    domain_id: int              # ground-truth knowledge domain (hidden)
    # full-size variant of ``cfg`` when the simulation trains a reduced
    # stand-in; comm-cost accounting (Fig. 8) bills this one.
    full_cfg: Optional[ModelConfig] = None

    @property
    def comm_cfg(self) -> ModelConfig:
        return self.full_cfg or self.cfg


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
               weight_decay: float = 0.0):
    """One training step, in place on ``params`` and ``opt``: the LM loss,
    its gradient with respect to every parameter, and AdamW.  Returns
    (loss, metrics, stats), tensors on the device."""
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = M.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    _, _, stats = adamw_update(tree_unflatten_like(params, grads), opt,
                               params, lr=lr, weight_decay=weight_decay)
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
    reference weights.
    """
    del compiled
    dev = resolve_device(device)
    params, opt = _device_init(spec, seed, dev, params, state_policy)
    warmup = max(steps // 20, 1)
    epoch = scan_epoch(_step_core(spec.cfg),
                       cosine_schedule(lr, steps, warmup=warmup), steps)
    batches = {k: v.to(dev) for k, v in corpus.device_batches(
        spec.device_id, steps, batch, seq_len).items()}
    (params, _), losses = epoch((params, opt), batches)
    return _upload(spec, corpus, params, losses)


def fleet_buckets(fleet: Sequence[DeviceSpec]
                  ) -> Dict[ModelConfig, List[DeviceSpec]]:
    """Group the fleet by (hashable) ``ModelConfig``, preserving order."""
    buckets: Dict[ModelConfig, List[DeviceSpec]] = {}
    for spec in fleet:
        buckets.setdefault(spec.cfg, []).append(spec)
    return buckets


def train_fleet(fleet: Sequence[DeviceSpec], corpus: FederatedCorpus, *,
                steps: int, batch: int, seq_len: int, lr: float = 3e-3,
                seed: int = 0, device="cuda") -> List[Dict]:
    """Every device's ``train_device``, bucket by bucket and in fleet
    order within a bucket (the reference vmaps each bucket; its lanes are
    independent, so the uploads are the same).  Returns uploads in the
    fleet's original order."""
    uploads: Dict[int, Dict] = {}
    for specs in fleet_buckets(fleet).values():
        for spec in specs:
            uploads[spec.device_id] = train_device(
                spec, corpus, steps=steps, batch=batch, seq_len=seq_len,
                lr=lr, seed=seed, device=device)
    return [uploads[spec.device_id] for spec in fleet]
