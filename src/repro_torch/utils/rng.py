"""The port's counter-based random stream, shared by the model's decode
loops and the serving samplers.

``jax.random`` and torch's generators never agree, so the port draws
from its own stream, on the tensors' device: each slot carries a key
(two 32-bit words, derived on the host by ``stream_key`` from an
engine's seed and a request's uid, or from the int a caller passes to
``submit(key=)``) and a step counter.  A draw at (key, counter, lane,
site, vocab index) is a stateless integer hash (``_mix32``, products of
32-bit lanes kept below 2**63 in int64 and masked, so the CPU and the
card give the same bits), turned into a uniform with 23 bits strictly
inside (0, 1).  Moving a slot's counter on by one every decode step,
whether the slot is live or not, makes a request's draws depend on its
key and its step alone: not on the segment length, the slot, the
engine, or a preemption's replay.
"""
from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant
    c, in two 16-bit halves so that no product passes 2**48."""
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (hi + (x & 0xFFFF) * c) & _M32


def _mix32(x):
    """A 32-bit integer hash (Wellons' lowbias32) of int64 x in
    [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def splitmix64(x: int) -> int:
    """One step of splitmix64 on a Python int (mod 2**64)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_key(seed: int, uid=None):
    """A slot's key, two 32-bit words: of ``seed`` alone (a caller's
    ``submit(key=)``), or of an engine's ``seed`` and a request's uid."""
    k = splitmix64(int(seed) & _M64)
    if uid is not None:
        k = splitmix64(k ^ (int(uid) & _M64))
    return (k >> 32, k & _M32)


def bits_to_uniform(bits):
    """Uniforms strictly inside (0, 1) from int64 hashes in [0, 2**32):
    the top 23 bits, centred.  The largest, 1 - 2**-24, is exact in f32
    (24 bits would round 2**24 - 0.5 up to 1, and -log(-log(1)) is
    +inf)."""
    return ((bits >> 9).float() + 0.5) * 2.0 ** -23


@dataclasses.dataclass(frozen=True, eq=False)
class Stream:
    """The random stream of a batch: per row a ``key`` (B, 2) int64 of
    32-bit words and a counter ``ctr`` (B,) int64, plus ``step`` decode
    steps on (a host int, so that moving on launches nothing); ``lane``
    separates the draw sites of one step (the positions of a verify
    chunk).  Within a lane, site 0 is a verify's acceptance draw and site
    1 a categorical draw."""
    key: torch.Tensor
    ctr: torch.Tensor
    step: int = 0
    lane: int = 0

    @classmethod
    def of(cls, keys, ctr, device) -> "Stream":
        """A stream from host keys (B, 2) and counters (B,)."""
        return cls(torch.as_tensor(keys, dtype=torch.int64, device=device),
                   torch.as_tensor(ctr, dtype=torch.int64, device=device))

    @classmethod
    def default(cls, B: int, device) -> "Stream":
        """Keys of seed 0 and each row's index, counters at 0."""
        return cls.of([stream_key(0, b) for b in range(B)], [0] * B, device)

    def at(self, lane: int) -> "Stream":
        return dataclasses.replace(self, lane=lane)

    def advance(self, n: int) -> "Stream":
        """The stream ``n`` steps on, at lane 0."""
        return dataclasses.replace(self, step=self.step + n, lane=0)

    def bits(self, site: int, n: int):
        """(B, n) int64 hashes in [0, 2**32) at this step, lane and
        ``site``, one per index 0..n-1."""
        ctr = (self.ctr + self.step) & _M32
        const = torch.full_like(ctr, ((self.lane << 4) | site) & _M32)
        row = _mix32(self.key[:, 0] ^ _mix32(
            self.key[:, 1] ^ _mix32(ctr ^ _mix32(const))))
        idx = _mix32(torch.arange(n, dtype=torch.int64, device=ctr.device))
        return _mix32(row[:, None] ^ idx[None, :])

    def uniform(self, site: int, n: int):
        """(B, n) f32 uniforms strictly inside (0, 1), 23 bits each."""
        return bits_to_uniform(self.bits(site, n))
