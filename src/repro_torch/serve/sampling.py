"""Per-slot token samplers for the serving engine.

Counterpart of ``repro.serve.sampling``; only ``Greedy`` is ported.  A
sampler maps logits (B, V) f32 to (B,) int32 token ids.  The stochastic
samplers of the reference draw from per-slot ``jax.random`` keys; their
port waits for a per-slot ``torch.Generator`` design, so a greedy
sampler takes no keys.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Greedy:
    """Deterministic argmax decoding (first index on ties, as
    ``jnp.argmax``)."""

    def __call__(self, logits):
        return torch.argmax(logits, -1).to(torch.int32)
