"""Federated data layout: N edge devices over K knowledge domains.

Each device draws from a (usually single) domain — the paper's setting
where a device's private data reflects one local application.  Data
volume per device is random and uneven (paper §V.A "distributed randomly
and unevenly").

A copy of ``repro.data.federated``: batches come from the same numpy
generators, so they are bit-identical to the reference's (as int32
torch tensors on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.data.synthetic import (DomainSpec, batch_from_tokens,
                                  domain_embedding, make_domains,
                                  sample_tokens)


def dirichlet_partition(rng: np.random.Generator, n_devices: int,
                        n_domains: int, alpha: float = 0.3) -> np.ndarray:
    """Assign each device a primary domain; alpha controls skew."""
    weights = rng.dirichlet(np.full(n_domains, alpha), size=n_devices)
    return np.argmax(weights, axis=1).astype(np.int32)


@dataclasses.dataclass
class FederatedCorpus:
    domains: List[DomainSpec]
    device_domain: np.ndarray        # (N,) domain id per device
    device_scale: np.ndarray         # (N,) relative data volume
    seed: int

    @classmethod
    def build(cls, *, seed: int, n_devices: int, n_domains: int, vocab: int,
              alpha: float = 0.3):
        rng = np.random.default_rng(seed)
        domains = make_domains(seed, n_domains, vocab)
        assignment = dirichlet_partition(rng, n_devices, n_domains, alpha)
        scale = rng.lognormal(0.0, 0.5, size=n_devices).astype(np.float32)
        return cls(domains, assignment, scale, seed)

    @property
    def n_devices(self) -> int:
        return len(self.device_domain)

    def device_rng(self, device: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng((self.seed, device, salt))

    def _device_tokens(self, device: int, batch: int, seq_len: int,
                       step: int = 0) -> np.ndarray:
        dom = self.domains[int(self.device_domain[device])]
        rng = self.device_rng(device, step + 1)
        return sample_tokens(dom, rng, batch, seq_len)

    def device_batch(self, device: int, batch: int, seq_len: int,
                     step: int = 0) -> Dict:
        return batch_from_tokens(self._device_tokens(device, batch, seq_len,
                                                     step))

    def device_batches(self, device: int, steps: int, batch: int,
                       seq_len: int, start: int = 0) -> Dict:
        """Pre-generates a full local-training epoch for one device as
        stacked ``(steps, B, S)`` arrays.  Step ``s`` equals
        ``device_batch(device, batch, seq_len, step=start + s)`` exactly,
        so an epoch loop reproduces the per-step loop bit-for-bit.

        ``start`` resumes the stream mid-epoch: the async fleet
        feeds each round the slice ``[local_step, local_step + k)`` of a
        device's stream, and because every step is keyed on
        ``(corpus seed, device, step)`` alone, a device that sat out a
        round consumes the *identical* continuation when it rejoins."""
        toks = np.stack([self._device_tokens(device, batch, seq_len,
                                             step=start + s)
                         for s in range(steps)])
        return batch_from_tokens(toks)

    def device_embedding(self, device: int, dim: int = 32) -> np.ndarray:
        dom = self.domains[int(self.device_domain[device])]
        return domain_embedding(dom, self.device_rng(device, 7777), dim)

    def domain_eval_batch(self, domain_id: int, batch: int, seq_len: int,
                          seed_salt: int = 0) -> Dict:
        rng = np.random.default_rng((self.seed, 999_000 + domain_id, seed_salt))
        return batch_from_tokens(
            sample_tokens(self.domains[domain_id], rng, batch, seq_len))

    def _mixed_tokens(self, batch: int, seq_len: int,
                      seed_salt: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 555_000, seed_salt))
        per = max(batch // len(self.domains), 1)
        parts = []
        for d in self.domains:
            parts.append(sample_tokens(d, rng, per, seq_len))
        toks = np.concatenate(parts, 0)[:batch]
        if len(toks) < batch:  # pad by repeating
            reps = -(-batch // len(toks))
            toks = np.concatenate([toks] * reps, 0)[:batch]
        return toks

    def mixed_eval_batch(self, batch: int, seq_len: int, seed_salt: int = 0):
        """Server-side public benchmark data (paper assumes HF/GitHub data)."""
        return batch_from_tokens(self._mixed_tokens(batch, seq_len, seed_salt))

    def mixed_eval_batches(self, steps: int, batch: int, seq_len: int,
                           seed_salt0: int = 0) -> Dict:
        """Stacked ``(steps, B, S)`` server-data epoch; step ``s`` equals
        ``mixed_eval_batch(batch, seq_len, seed_salt=seed_salt0 + s)``."""
        toks = np.stack([self._mixed_tokens(batch, seq_len, seed_salt0 + s)
                         for s in range(steps)])
        return batch_from_tokens(toks)
