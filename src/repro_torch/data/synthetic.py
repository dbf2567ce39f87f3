"""Synthetic multi-domain corpora.

MMedBench / FinQA are not available offline, so we build corpora with the
*statistical structure the paper's pipeline needs*: K distinguishable
knowledge domains (medical specialities / finance topics in the paper),
each a sparse bigram Markov chain over the vocabulary.  Domains are
learnable (low entropy given the previous token) and mutually
distinguishable (disjoint-ish transition supports), so:

* an on-device LLM trained on one domain genuinely acquires
  domain-specific knowledge (its perplexity drops on that domain only);
* clustering by data embeddings recovers the domain partition;
* the global MoE's experts can specialise per domain.

``domain_embedding`` plays the role of the paper's MiniLM low-rank data
embeddings e_n (§IV.B): a deterministic random projection of the domain's
unigram distribution + noise.

A copy of ``repro.data.synthetic`` (numpy, the same generator calls in
the same order, so the same seed gives the same tokens), except that
``batch_from_tokens`` returns torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch


@dataclasses.dataclass
class DomainSpec:
    domain_id: int
    vocab: int
    branching: int
    succ: np.ndarray      # (vocab, branching) successor token ids
    probs: np.ndarray     # (vocab, branching) transition probabilities
    unigram: np.ndarray   # (vocab,) stationary-ish distribution


def make_domains(seed: int, n_domains: int, vocab: int,
                 branching: int = 8) -> List[DomainSpec]:
    rng = np.random.default_rng(seed)
    domains = []
    for d in range(n_domains):
        succ = rng.integers(0, vocab, size=(vocab, branching))
        raw = rng.dirichlet(np.full(branching, 0.5), size=vocab)
        # each domain also has a preferred token band -> distinguishable
        band = rng.permutation(vocab)[: vocab // 4]
        unigram = np.full(vocab, 1.0)
        unigram[band] += 8.0
        unigram /= unigram.sum()
        domains.append(DomainSpec(d, vocab, branching, succ.astype(np.int32),
                                  raw.astype(np.float32),
                                  unigram.astype(np.float32)))
    return domains


def sample_tokens(domain: DomainSpec, rng: np.random.Generator,
                  batch: int, seq_len: int) -> np.ndarray:
    """Sample (batch, seq_len+1) token sequences from the domain chain."""
    out = np.empty((batch, seq_len + 1), np.int32)
    cur = rng.choice(domain.vocab, size=batch, p=domain.unigram)
    out[:, 0] = cur
    for t in range(1, seq_len + 1):
        u = rng.random(batch)
        cdf = np.cumsum(domain.probs[cur], axis=1)
        choice = (u[:, None] > cdf).sum(axis=1).clip(max=domain.branching - 1)
        cur = domain.succ[cur, choice]
        out[:, t] = cur
    return out


def batch_from_tokens(tokens: np.ndarray):
    """(..., S+1) -> {"tokens": (...,S), "labels": (...,S)} next-token
    setup.  Rank-agnostic: works for a single (B, S+1) batch and for
    (T, B, S+1) stacked epochs alike.  Token ids stay int32, as in the
    reference; the CPU tensors own copies of the numpy slices."""
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens[..., :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(tokens[..., 1:]))}


def domain_embedding(domain: DomainSpec, rng: np.random.Generator,
                     dim: int = 32, noise: float = 0.02) -> np.ndarray:
    """Low-rank data embedding (stand-in for MiniLM, paper §IV.B)."""
    proj_rng = np.random.default_rng(1234)  # shared projection across devices
    proj = proj_rng.standard_normal((domain.vocab, dim)).astype(np.float32)
    e = domain.unigram @ proj
    e = e + noise * rng.standard_normal(dim).astype(np.float32)
    return e / (np.linalg.norm(e) + 1e-9)
