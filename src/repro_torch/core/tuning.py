"""Phase III — global MoE model tuning (paper §IV.D).

Counterpart of ``repro.core.tuning``.  The FFN experts (routed *and*
shared, the overwhelming majority of parameters) are frozen; the
embedding, self-attention, router and output layers are fine-tuned on
server-side public data.  Frozen leaves carry scalar moments in AdamW.

As in the reference, the gradient is taken for **every** leaf, frozen
experts included, because AdamW clips on the global norm of all of them
(``optim/adamw.py``): marking the experts ``requires_grad=False`` would
change the clip scale and with it every update.  The port keeps the
reference's parameter paths, so ``_FROZEN`` is the reference's pattern.

On a ``mesh`` (``launch/mesh.py``) the step takes the MoE's
expert-parallel paths: ``params`` and the moments hold the rank's block
of each expert stack (``models/moe.py::shard_experts`` and
``shard_opt_state``; the freeze mask has the same leaves), every other
leaf is whole and updated alike on every rank, and the clip sums the
blocks' squares over their ranks (``device.train_step``), so the step
is the reference's on its global arrays.
"""
from __future__ import annotations

import re
from typing import Dict

from repro_torch.federated.device import train_step
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw_init, scan_epoch
from repro_torch.utils.pytree import (tree_leaves, tree_paths, tree_size,
                                      tree_unflatten_like)

_FROZEN = re.compile(r"moe/(wi_gate|wi_up|wo)$|moe/shared/")


def expert_freeze_mask(params) -> Dict:
    """True = trainable.  Freezes routed + shared expert FFN weights."""
    return tree_unflatten_like(
        params, [not _FROZEN.search(p) for p, _ in tree_paths(params)])


def trainable_fraction(params) -> float:
    mask = expert_freeze_mask(params)
    train = sum(x.numel() for x, m in zip(tree_leaves(params),
                                          tree_leaves(mask)) if m)
    return train / max(tree_size(params), 1)


def make_tune_step(cfg: ModelConfig, freeze_mask, *, weight_decay=0.01,
                   mesh=None):
    """``step(params, opt_state, batch, lr) -> (params, opt_state, loss,
    metrics)``, in place on ``params`` and ``opt_state``; ``metrics``
    carries the clip's ``grad_norm``."""
    def step(params, opt_state, batch, lr):
        loss, metrics, stats = train_step(params, opt_state, cfg, batch, lr,
                                          weight_decay=weight_decay,
                                          freeze_mask=freeze_mask, mesh=mesh)
        metrics.update(stats)
        return params, opt_state, loss, metrics

    return step


def make_tune_epoch(cfg: ModelConfig, freeze_mask, *, steps, schedule,
                    weight_decay=0.01, on_step=None, mesh=None):
    """``epoch(params, opt_state, batches) -> (params, opt_state,
    losses)`` over stacked ``(steps, B, S)`` batches, the lr schedule
    applied to the step counter (``optim.loops.scan_epoch``).
    ``on_step(step, loss)``, if given, runs after each step."""
    step_fn = make_tune_step(cfg, freeze_mask, weight_decay=weight_decay,
                             mesh=mesh)

    def carry_step(carry, b, lr):
        params, opt_state, loss, _ = step_fn(*carry, b, lr)
        return (params, opt_state), loss

    scanned = scan_epoch(carry_step, schedule, steps, on_step=on_step)

    def epoch(params, opt_state, batches):
        (params, opt_state), losses = scanned((params, opt_state), batches)
        return params, opt_state, losses

    return epoch


def init_tuning(params):
    mask = expert_freeze_mask(params)
    return mask, adamw_init(params, freeze_mask=mask)
