"""The multi-step epoch contract of ``repro.optim.loops.scan_epoch``.

The reference scans one compiled step over stacked batches; the port
runs the same contract as a Python loop: step ``s`` sees batch ``s`` of
the stacked epoch and the learning rate ``schedule(start + s)``, and the
per-step losses come back as one ``(steps,)`` tensor.  Losses stay on
the device until the caller reads them: one host sync per epoch.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def scan_epoch(step: Callable, schedule: Callable, steps: int, *,
               on_step: Optional[Callable] = None) -> Callable:
    """``step: (carry, batch, lr) -> (carry, loss)`` -> ``epoch: (carry,
    batches, start=0) -> (carry, losses)`` over stacked batches (a dict
    of (steps, ...) tensors).  ``on_step(s, loss)``, if given, runs after
    step ``s`` (e.g. to time it; it may synchronise)."""

    def epoch(carry, batches, start: int = 0):
        losses = []
        for s in range(steps):
            b = {k: v[s] for k, v in batches.items()}
            carry, loss = step(carry, b, schedule(start + s))
            losses.append(loss.detach())
            if on_step is not None:
                on_step(s, losses[-1])
        return carry, torch.stack(losses)

    return epoch
