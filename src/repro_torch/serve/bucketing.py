"""Prompt-length bucket ladders for the chunked-prefill admission path.

Counterpart of ``repro.serve.bucketing`` (copied: the port imports
nothing of the reference).  Bucketing rounds the padded input length
(modality frontend + tokens) up a small ladder of chunk multiples, so
admission runs a fixed, small set of chunk counts whatever lengths
arrive.  The port compiles nothing, so a rung is not an executable's
key here; it still bounds the padded work and fixes the chunk shape.
A bucket NEVER truncates: when a prompt outgrows the ladder,
``bucket_for`` extends to the next chunk multiple instead of clipping.
"""
from __future__ import annotations

from typing import Sequence, Tuple


def bucket_ladder(chunk_len: int, max_len: int) -> Tuple[int, ...]:
    """Default ladder: powers-of-two multiples of ``chunk_len`` through
    the first rung covering ``max_len``."""
    if chunk_len < 1:
        raise ValueError("chunk_len must be >= 1")
    rungs = [chunk_len]
    while rungs[-1] < max_len:
        rungs.append(rungs[-1] * 2)
    return tuple(rungs)


def validate_ladder(ladder: Sequence[int], chunk_len: int) -> Tuple[int, ...]:
    """Sorted, deduplicated ladder; every rung must be a positive
    multiple of ``chunk_len`` (admission runs rung / chunk_len chunks)."""
    rungs = sorted(set(int(r) for r in ladder))
    if not rungs:
        raise ValueError("bucket ladder is empty")
    for r in rungs:
        if r < 1 or r % chunk_len:
            raise ValueError(
                f"bucket rung {r} is not a positive multiple of "
                f"chunk_len {chunk_len}")
    return tuple(rungs)


def bucket_for(length: int, ladder: Sequence[int], chunk_len: int) -> int:
    """Smallest rung >= ``length``; past the top rung, the next chunk
    multiple (never truncate)."""
    if length < 0:
        raise ValueError("length must be >= 0")
    for r in ladder:
        if r >= length:
            return r
    return -(-max(length, 1) // chunk_len) * chunk_len
