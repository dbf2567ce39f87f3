"""Block allocator for the paged serve engine: free list, refcounts,
content-keyed prefix sharing.

Copied from ``repro.serve.paged`` (numpy and hashlib, and torch to read
a tensor's bytes): the port keeps its own copy so that it never imports
the JAX package.

One block id spans every paged cache leaf (all layers), mirroring
``models.model.init_paged_cache``.  Block 0 is the **trash block**: it
is never handed out, and the engine points finished slots' block tables
(and write positions) at it so their masked garbage decode writes land
somewhere sacrificial instead of corrupting reallocated blocks.

Prefix sharing is content-keyed, vLLM-style: a *full* block whose
positions lie entirely inside the prompt region has content determined
by (block index, modality digest, token prefix through the block's end).
``acquire`` returns the existing block (refcount + 1) when the key is
already pooled, so identical Phase II task preambles are stored once.
Blocks at or past the write frontier (the partial prompt tail block and
all decode blocks) are always ``alloc``'d privately — decode writes can
therefore never touch a shared block, which is what keeps diverged
suffixes from aliasing (copy-on-write resolved at admission time).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

TRASH = 0  # pool row 0: absorbs dead slots' masked writes, never allocated


class PagedAllocator:
    """Free-list + refcount bookkeeping over ``n_blocks`` pool rows
    (ids 1..n_blocks-1; row 0 is the trash block).

    ``n_shards > 1`` matches a mesh-sharded pool
    (``sharding.rules.paged_cache_specs``): device d owns the contiguous
    id range [d * n_blocks/n_shards, (d+1) * n_blocks/n_shards), and the
    allocator keeps one free list per shard, handing new blocks out of
    the emptiest shard so live blocks — and therefore paged-attention
    read traffic — stay balanced across devices.  ``n_shards=1`` is the
    single-device allocator, id-for-id identical to before the split.
    """

    def __init__(self, n_blocks: int, block_len: int, n_shards: int = 1):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (one is the trash block)")
        if block_len < 1:
            raise ValueError("block_len must be >= 1")
        if n_shards < 1 or n_blocks % n_shards:
            raise ValueError(
                f"n_blocks {n_blocks} must divide into n_shards {n_shards}")
        self.n_blocks, self.block_len = n_blocks, block_len
        self.n_shards = n_shards
        self._per_shard = n_blocks // n_shards
        # per-shard free lists; pop() hands out each shard's low ids
        # first.  The trash block (id 0) sits in shard 0 and is skipped.
        self._free_by_shard: List[List[int]] = [
            list(range(min((d + 1) * self._per_shard - 1, n_blocks - 1),
                       max(d * self._per_shard - 1, 0), -1))
            for d in range(n_shards)]
        self.refcount = [0] * n_blocks
        self._key_of: Dict[int, Tuple] = {}
        self._bid_of: Dict[Tuple, int] = {}
        self.shared_hits = 0

    def shard_of(self, bid: int) -> int:
        return bid // self._per_shard

    # -- capacity ----------------------------------------------------------

    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self._free_by_shard)

    def n_free_shard(self, shard: int) -> int:
        return len(self._free_by_shard[shard])

    def free_ids(self) -> List[int]:
        """Every free block id, across all shards (introspection)."""
        return [b for f in self._free_by_shard for b in f]

    @property
    def n_live(self) -> int:
        return (self.n_blocks - 1) - self.n_free

    def lookup(self, key) -> Optional[int]:
        """Block id pooled under ``key``, or None (refcount untouched)."""
        return self._bid_of.get(key)

    # -- alloc / share / free ----------------------------------------------

    def alloc(self) -> int:
        """A private (unkeyed, refcount-1) block, from the shard with the
        most free blocks (lowest shard index on ties — with one shard
        this degenerates to the original single free list)."""
        shard = max(range(self.n_shards),
                    key=lambda d: (len(self._free_by_shard[d]), -d))
        if not self._free_by_shard[shard]:
            raise RuntimeError("paged KV pool exhausted")
        bid = self._free_by_shard[shard].pop()
        self.refcount[bid] = 1
        return bid

    def acquire(self, key) -> Tuple[int, bool]:
        """Refcount the block pooled under ``key``, allocating (and
        keying) a fresh one on miss.  Returns (block_id, fresh) — the
        caller must write the block's content iff ``fresh``."""
        bid = self._bid_of.get(key)
        if bid is not None:
            self.refcount[bid] += 1
            self.shared_hits += 1
            return bid, False
        bid = self.alloc()
        self._bid_of[key] = bid
        self._key_of[bid] = key
        return bid, True

    def release(self, bid: int) -> None:
        """Drop one reference; a block returns to the free list (and its
        key leaves the content pool) exactly when its refcount hits 0."""
        if bid == TRASH:
            raise ValueError("cannot release the trash block")
        if not (0 < bid < self.n_blocks):
            raise ValueError(f"block id {bid} out of range")
        if self.refcount[bid] <= 0:
            raise ValueError(f"double free of block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            key = self._key_of.pop(bid, None)
            if key is not None:
                del self._bid_of[key]
            self._free_by_shard[self.shard_of(bid)].append(bid)


def _fixed_bytes(v) -> bytes:
    """A fixed byte form of a modality input (a tensor or an array): its
    dtype, its shape and its raw element bytes, read as bytes on the
    host (bfloat16 has no numpy view)."""
    t = torch.as_tensor(v).detach().to("cpu").contiguous()
    raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return f"{t.dtype}{tuple(t.shape)}".encode() + raw


def prompt_digest(batch) -> bytes:
    """Digest of every non-token modality input (vlm patches, encdec
    frames).  KV content anywhere in the sequence depends on these (the
    frontend rows prefix the prompt; encdec cross-attends the frames),
    so prefix keys must include them: equal inputs give equal digests,
    and inputs that differ in any byte, dtype or shape differ."""
    extra = [_fixed_bytes(v) for k, v in sorted(batch.items())
             if k != "tokens"]
    if not extra:
        return b""
    return hashlib.sha1(b"".join(extra)).digest()


def prefix_keys(batch, n_full_blocks: int, block_len: int, offset: int,
                policy: str = ""):
    """Content keys for the full blocks below the write frontier.

    Block ``i`` covers positions [i*bl, (i+1)*bl); with a modality
    frontend of ``offset`` rows, token positions map to
    ``tokens[p - offset]``, so block ``i``'s KV is a pure function of
    (modality inputs, tokens[: (i+1)*bl - offset]).  The block index is
    part of the key: frontend-only blocks of different depths share a
    (possibly empty) token prefix but hold different rows.

    ``policy`` is the cache's storage policy (``CachePolicy.kv_dtype``):
    block bytes written under different policies differ for the same
    tokens, so the policy salts the key — a quantized pool can never
    alias blocks written under a different dtype (e.g. a
    ``--check-unquantized`` replay sharing one allocator).

    Note: two prompts of *different total length* sharing a token prefix
    get the same keys — their shared-block KV is mathematically
    identical but computed by different prefill executables, so reuse
    across lengths is equal to float tolerance, not guaranteed
    bit-identical.  Same-length prompts (the Phase II preamble case)
    share bit-exactly.
    """
    toks = np.asarray(batch["tokens"][0])
    base = prompt_digest(batch)
    keys = []
    for i in range(n_full_blocks):
        n_tok = max((i + 1) * block_len - offset, 0)
        keys.append((i, base, toks[:n_tok].astype(np.int64).tobytes(),
                     policy))
    return keys
