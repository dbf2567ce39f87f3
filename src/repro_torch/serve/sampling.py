"""Per-slot token samplers for the serving engine.

Counterpart of ``repro.serve.sampling``.  A sampler maps ``(stream,
logits)`` to tokens: ``stream`` is the batch's ``Stream`` at one draw
site, ``logits`` (B, V) f32, the result (B,) int32.  Samplers are frozen
dataclasses.  ``Greedy`` ignores its stream; ``Temperature`` and ``TopK``
draw from it.

Each sampler also has ``verify(stream, logits, draft)`` for speculative
decode: given the target logits at a drafted position and the greedy
draft proposed there, return ``(token, accepted)``.  The drafter is a
point mass, so exact residual rejection sampling reduces to: accept the
draft with probability p(draft) under the target distribution, else
resample from the target with the draft masked out; the emitted
marginal is exactly the target distribution (P(d) = p_d; P(x != d) =
(1 - p_d) · p_x / (1 - p_d)).

The random stream is ``utils.rng.Stream``, a counter-based hash on the
tensors' device (see there); a request's draws depend on its key and
its decode step alone.  Categorical sampling is Gumbel-max over
``logits / t``.  The functions that turn uniforms into tokens
(``categorical``, ``_residual_verify``) take the uniforms as inputs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import greedy_sample, greedy_verify

# Below this, logits / t amplifies f32 logits toward overflow and the
# distribution IS argmax, so every sampler decodes greedily there.
ARGMAX_TEMPERATURE = 1e-3


def categorical(u, logits, t: float):
    """Gumbel-max: one draw from softmax(logits / t) per row, from
    uniforms ``u`` (B, V)."""
    g = -torch.log(-torch.log(u))
    return torch.argmax(logits / t + g, -1).to(torch.int32)


def _residual_verify(u_accept, u_alt, logits, draft, t: float):
    """Accept ``draft`` (B,) where ``u_accept`` (B,) < softmax(logits /
    t)[draft]; else emit a Gumbel-max draw over the logits with the draft
    masked out, from ``u_alt`` (B, V).  Returns (tokens, accepted)."""
    d = draft.long()[:, None]
    p_d = torch.softmax(logits / t, -1).gather(-1, d)[:, 0]
    accept = u_accept < p_d
    alt = categorical(u_alt, logits.scatter(-1, d, float("-inf")), t)
    return torch.where(accept, draft.to(torch.int32), alt), accept


def _mask_topk(logits, k: int):
    """The logits with all but each row's k largest at -inf."""
    vals, idx = torch.topk(logits, k, -1)
    return torch.full_like(logits, float("-inf")).scatter(-1, idx, vals)


@dataclasses.dataclass(frozen=True)
class Greedy:
    """Deterministic argmax decoding (first index on ties, as
    ``jnp.argmax``)."""

    def __call__(self, stream, logits):
        return greedy_sample(stream, logits)

    def verify(self, stream, logits, draft):
        return greedy_verify(stream, logits, draft)


@dataclasses.dataclass(frozen=True)
class Temperature:
    """Sample from softmax(logits / t).  ``t`` at or below
    ``ARGMAX_TEMPERATURE`` (t = 0 included) decodes greedily."""

    t: float = 1.0

    def __call__(self, stream, logits):
        if self.t <= ARGMAX_TEMPERATURE:
            return greedy_sample(stream, logits)
        return categorical(stream.uniform(1, logits.shape[-1]), logits,
                           self.t)

    def verify(self, stream, logits, draft):
        if self.t <= ARGMAX_TEMPERATURE:
            return greedy_verify(stream, logits, draft)
        return _residual_verify(stream.uniform(0, 1)[:, 0],
                                stream.uniform(1, logits.shape[-1]), logits,
                                draft, self.t)


@dataclasses.dataclass(frozen=True)
class TopK:
    """Restrict to the k most likely tokens, then temperature-sample.
    ``k`` is clamped to the vocabulary, and tiny temperatures decode
    greedily, as in ``Temperature``."""

    k: int = 40
    t: float = 1.0

    def __call__(self, stream, logits):
        if self.t <= ARGMAX_TEMPERATURE:
            return greedy_sample(stream, logits)
        V = logits.shape[-1]
        return categorical(stream.uniform(1, V),
                           _mask_topk(logits, min(self.k, V)), self.t)

    def verify(self, stream, logits, draft):
        if self.t <= ARGMAX_TEMPERATURE:
            return greedy_verify(stream, logits, draft)
        # a draft outside the top k has p = 0 under the restricted target,
        # so it is always rejected and the resample comes from the top k
        V = logits.shape[-1]
        return _residual_verify(stream.uniform(0, 1)[:, 0],
                                stream.uniform(1, V),
                                _mask_topk(logits, min(self.k, V)), draft,
                                self.t)
