"""Slot-based continuous-batching generation engine.

Counterpart of ``repro.serve.engine``, with unbucketed admission.  The
engine serves a queue of variable-length requests through a fixed set
of ``n_slots`` batch rows:

  admit    : prefill a queued request at B=1, graft its cache into a
             free slot, sample emission #1 from the prefill logits.
  segment  : ``seg_len`` decode steps over the whole batch
             (``models.model.generate``), per-slot position /
             remaining-length / EOS state carried on the device.
             Finished slots keep running as masked garbage until the
             segment ends, so the batch shape never changes.
  between  : finished slots are freed and refilled from the queue.

``ServeEngine`` (contiguous) owns one ``(n_slots, max_len)`` decode
cache.  ``PagedServeEngine`` owns an ``(n_blocks, block_len)`` block pool
per attention leaf plus per-slot block tables (``repro_torch.serve.paged``):
a request holds the blocks its tokens span, identical prompt prefixes
are pooled once (refcounted), decode blocks are claimed lazily, and the
youngest request is preempted (and replayed) when the pool runs dry.

Not ported yet, and refused with ``NotImplementedError``: bucketed
chunked admission (``chunk_len``/``buckets``), speculative decode,
quantized KV (``kv_dtype``), sharded serving (``mesh``) and MoE
configurations (their decode takes the reference's ``live`` mask).  The
reference's compiled-executable cache has no counterpart: nothing here
is compiled.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serve import paged as pg
from repro_torch.serve.sampling import Greedy
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    """One generation request.  ``batch`` holds ``tokens`` (1, P) as a
    host array; ``max_new`` counts ALL generated tokens, including the
    one sampled from the prefill logits."""
    uid: int
    batch: Dict[str, Any]
    max_new: int
    # memoised prefix-block content keys (paged engine)
    plan_keys: Optional[List] = None

    @property
    def prompt_len(self) -> int:
        return self.batch["tokens"].shape[1]


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: np.ndarray     # (n_generated,) — includes the EOS token if hit
    n_segments: int        # decode segments this request rode through
    ttft_s: float          # submit -> first token on the host (first try)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _scatter_slot_row(cache, sub, slot: int):
    """Write a B=1 contiguous cache into row ``slot`` (axis 1, behind the
    group axis) of the engine cache, in place."""
    if isinstance(cache, dict):
        for k in cache:
            _scatter_slot_row(cache[k], sub[k], slot)
        return cache
    cache[:, slot] = sub[:, 0].to(cache.dtype)
    return cache


class ServeEngine:
    """Continuous-batching engine over a fixed ``(n_slots, max_len)``
    decode cache.  ``submit()`` requests, then ``run()`` (or ``step()``
    segment by segment); drain finished requests with
    ``pop_completions()`` under sustained traffic.

    ``device`` defaults to the card and must hold ``params``; pass
    ``device="cpu"`` to serve on the CPU.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 128, sampler=None,
                 eos_id: Optional[int] = None, seg_len: int = 8,
                 device="cuda", history_limit: int = 4096,
                 chunk_len: Optional[int] = None, buckets=None,
                 speculate: int = 0, kv_dtype: str = "", mesh=None):
        for name, val, default in [("chunk_len", chunk_len, None),
                                   ("buckets", buckets, None),
                                   ("speculate", speculate, 0),
                                   ("kv_dtype", kv_dtype, ""),
                                   ("mesh", mesh, None)]:
            if val != default:
                raise NotImplementedError(f"{name} is not ported yet")
        if cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE serving (decode with the live mask) is not "
                "ported yet")
        cfg.validate()
        self.device = resolve_device(device)
        leaf_dev = _first_leaf(params).device
        if leaf_dev.type != self.device.type:
            raise ValueError(f"params lie on {leaf_dev}, engine device is "
                             f"{self.device}")
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len, self.seg_len = n_slots, max_len, seg_len
        self.sampler = sampler if sampler is not None else Greedy()
        self.eos_id = eos_id
        self._init_cache()
        # per-slot host state
        self.tok = np.zeros((n_slots,), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.rem = np.zeros((n_slots,), np.int32)
        self.slot_uid = np.full((n_slots,), -1, np.int64)
        self._slot_seq = np.zeros((n_slots,), np.int64)  # admission order
        self._admit_seq = 0
        self._live_req: Dict[int, Request] = {}  # uid -> Request while live
        self.queue: deque = deque()
        self._pending: set = set()  # queued uids — O(1) reuse check
        self.completions: Dict[int, Completion] = {}
        self.history: deque = deque(maxlen=history_limit)  # (seg, slot, uid)
        self.segment_idx = 0
        # admit_s / decode_s: host seconds in admission and in decode
        # segments.  A segment ends reading its tokens back, so its device
        # work is inside decode_s; admission reads each first token back,
        # and only the cache graft queued after the last read spills into
        # the next segment's time
        self.stats = {"generated_tokens": 0, "segments": 0, "prefills": 0,
                      "slot_steps": 0, "live_slot_steps": 0,
                      "peak_live_requests": 0, "admit_s": 0.0,
                      "decode_s": 0.0}
        self._t_submit: Dict[int, float] = {}
        self._ttft: Dict[int, float] = {}
        self._out: Dict[int, list] = {}
        self._plen: Dict[int, int] = {}
        self._nseg: Dict[int, int] = {}
        self._uid_auto = 0

    # -- cache layout hooks (overridden by PagedServeEngine) ---------------

    def _init_cache(self) -> None:
        self.cache = M.init_decode_cache(self.cfg, self.n_slots,
                                         self.max_len, device=self.device)

    # -- request intake ----------------------------------------------------

    def submit(self, batch, *, max_new: int, uid: Optional[int] = None) -> int:
        if uid is None:
            uid = self._uid_auto
            self._uid_auto += 1
        else:
            self._uid_auto = max(self._uid_auto, uid + 1)
        if uid in self.completions or uid in self._out or uid in self._pending:
            raise ValueError(f"request {uid}: uid already in use")
        if set(batch) != {"tokens"}:
            raise ValueError(f"request {uid}: the ported families take a "
                             f"batch of 'tokens' only, got {sorted(batch)}")
        toks = batch["tokens"]
        if isinstance(toks, torch.Tensor):
            toks = toks.cpu().numpy()
        toks = np.asarray(toks, np.int32)
        if toks.ndim != 2 or toks.shape[0] != 1:
            raise ValueError(
                f"request {uid}: tokens must have shape (1, P), got "
                f"{toks.shape} (one request per submit)")
        self._validate_capacity(uid, toks.shape[1], max_new)
        if max_new < 1:
            raise ValueError(f"request {uid}: max_new must be >= 1")
        self.queue.append(Request(uid, {"tokens": toks}, max_new))
        self._pending.add(uid)
        self._t_submit[uid] = time.perf_counter()
        return uid

    def _validate_capacity(self, uid: int, P: int, max_new: int) -> None:
        need = M.decode_capacity(self.cfg, P, max_new)
        if need > self.max_len:
            raise ValueError(
                f"request {uid}: prompt {P} + max_new {max_new} needs cache "
                f"capacity {need} > engine max_len {self.max_len}")

    @property
    def idle(self) -> bool:
        return not self.queue and not (self.slot_uid >= 0).any()

    def pop_completions(self) -> Dict[int, Completion]:
        """Drain finished requests (their uids become reusable)."""
        out, self.completions = self.completions, {}
        return out

    # -- admission ---------------------------------------------------------

    def _finish(self, uid: int) -> None:
        self._live_req.pop(uid, None)
        self.completions[uid] = Completion(
            uid, self._plen.pop(uid),
            np.asarray(self._out.pop(uid), np.int32), self._nseg.pop(uid),
            self._ttft.pop(uid))
        self._t_submit.pop(uid)

    def _plan(self, req: Request):
        """Admission plan (paged: block keys/counts); None = nothing to
        plan."""
        return None

    def _fits(self, plan) -> bool:
        """Can the planned request be placed right now?"""
        return True

    def _place(self, slot: int, req: Request, pc, plan) -> None:
        sub = M.prefill_into_cache(
            self.cfg, M.init_decode_cache(self.cfg, 1, self.max_len,
                                          device=self.device), pc)
        _scatter_slot_row(self.cache, sub, slot)

    def _release_slot(self, slot: int) -> None:
        self.slot_uid[slot] = -1
        # EOS can finish a slot with budget left: zero it so the freed
        # lane runs masked (done = rem<=0) until re-admitted
        self.rem[slot] = 0

    def _admit(self) -> None:
        free = [s for s in range(self.n_slots) if self.slot_uid[s] < 0]
        while free and self.queue:
            req = self.queue[0]
            plan = self._plan(req)
            if not self._fits(plan):
                break  # blocked on pool space: keep arrival order
            self.queue.popleft()
            self._pending.discard(req.uid)
            # slotless B=1 prefill; the graft is deferred so a request
            # finishing at prefill never touches the cache
            slot = free[0]
            toks = torch.as_tensor(req.batch["tokens"], device=self.device)
            logits, pc = M.prefill(self.params, self.cfg, {"tokens": toks})
            e0 = int(self.sampler(logits)[0])
            # a preempted request's replay keeps its first answer's time
            self._ttft.setdefault(req.uid,
                                  time.perf_counter() - self._t_submit[req.uid])
            self._out[req.uid] = [e0]
            self._plen[req.uid] = req.prompt_len
            self._nseg[req.uid] = 0
            self.stats["prefills"] += 1
            self.stats["generated_tokens"] += 1
            if req.max_new <= 1 or (self.eos_id is not None
                                    and e0 == self.eos_id):
                self._finish(req.uid)  # done at prefill: no slot consumed
                continue
            free.pop(0)
            self._place(slot, req, pc, plan)
            self.slot_uid[slot] = req.uid
            self._slot_seq[slot] = self._admit_seq
            self._admit_seq += 1
            self._live_req[req.uid] = req
            self.tok[slot] = e0
            self.pos[slot] = M.decode_pos0(self.cfg, req.prompt_len)
            self.rem[slot] = req.max_new - 1
        self.stats["peak_live_requests"] = max(
            self.stats["peak_live_requests"], int((self.slot_uid >= 0).sum()))

    # -- decode segment ----------------------------------------------------

    def _segment_kw(self) -> dict:
        return {}

    def _segment(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        res = M.generate(self.params, self.cfg, self.cache,
                         torch.as_tensor(self.tok, device=dev),
                         torch.as_tensor(self.pos, device=dev),
                         steps=self.seg_len, sampler=self.sampler,
                         eos_id=self.eos_id,
                         remaining=torch.as_tensor(self.rem, device=dev),
                         **self._segment_kw())
        toks = res["tokens"].cpu().numpy()
        valid = res["valid"].cpu().numpy()
        done = res["done"].cpu().numpy()
        # writable copies — _admit() mutates these per slot
        self.tok = res["next_tok"].cpu().numpy().copy()
        self.pos = res["pos"].cpu().numpy().copy()
        self.rem = res["remaining"].cpu().numpy().copy()
        self.stats["decode_s"] += time.perf_counter() - t0
        for s in range(self.n_slots):
            uid = int(self.slot_uid[s])
            if uid < 0:
                continue
            self.history.append((self.segment_idx, s, uid))
            new = toks[s][valid[s]].tolist()
            self._out[uid].extend(new)
            self._nseg[uid] += 1
            self.stats["generated_tokens"] += len(new)
            self.stats["live_slot_steps"] += len(new)
            if done[s]:
                self._finish(uid)
                self._release_slot(s)
        self.stats["slot_steps"] += self.n_slots * self.seg_len
        self.stats["segments"] += 1
        self.segment_idx += 1

    # -- driving -----------------------------------------------------------

    def _pre_segment(self) -> None:
        """Hook between admission and the decode segment (paged lazy
        block extension / preemption)."""

    @torch.no_grad()
    def step(self) -> None:
        """Admit waiting requests, then run one decode segment."""
        t0 = time.perf_counter()
        self._admit()
        self.stats["admit_s"] += time.perf_counter() - t0
        self._pre_segment()
        if (self.slot_uid >= 0).any():
            self._segment()

    def run(self) -> Dict[int, Completion]:
        """Drain the queue: segments with admission in between."""
        t0 = time.perf_counter()
        while not self.idle:
            self.step()
        self.stats["wall_s"] = (self.stats.get("wall_s", 0.0)
                                + time.perf_counter() - t0)
        return self.completions


class PagedServeEngine(ServeEngine):
    """Continuous batching over a block-paged KV cache.

    A request is admitted holding blocks from the shared pool, full
    prompt blocks dedup'd against the allocator's content pool, so
    concurrency is bounded by live tokens instead of
    ``n_slots * max_len``.

    With ``lazy=True`` (default) admission claims only the blocks the
    prompt spans; decode blocks are claimed per segment as the write
    frontier crosses block boundaries (``_pre_segment``).  If the pool
    runs dry between segments the youngest-admitted live request is
    preempted: its blocks return to the pool and it re-queues for a
    deterministic replay (greedy, so its final tokens are unchanged).
    The oldest request is never preempted, which guarantees progress.
    ``lazy=False`` claims ``ceil(decode_capacity / block_len)`` blocks
    at admission.
    """

    def __init__(self, params, cfg: ModelConfig, *, block_len: int = 16,
                 n_blocks: Optional[int] = None, n_slots: int = 4,
                 max_len: int = 128, share_prefix: bool = True,
                 lazy: bool = True, **kw):
        self.block_len = block_len
        self.max_blocks = -(-max_len // block_len)
        # default pool: worst case every slot holds max_len live tokens
        self.n_blocks = (1 + n_slots * self.max_blocks
                         if n_blocks is None else n_blocks)
        self.share_prefix, self.lazy = share_prefix, lazy
        self.alloc = pg.PagedAllocator(self.n_blocks, block_len)
        self.block_tables = np.full((n_slots, self.max_blocks), pg.TRASH,
                                    np.int32)
        self._slot_blocks: Dict[int, List[int]] = {}  # uid -> held block ids
        super().__init__(params, cfg, n_slots=n_slots, max_len=max_len, **kw)
        self.stats.update({"shared_blocks": 0, "fresh_blocks": 0,
                           "peak_live_blocks": 0, "lazy_claimed_blocks": 0,
                           "preemptions": 0})

    # -- cache layout ------------------------------------------------------

    def _init_cache(self) -> None:
        self.cache = M.init_paged_cache(self.cfg, self.n_blocks,
                                        self.block_len, device=self.device)

    # -- admission ---------------------------------------------------------

    def _validate_capacity(self, uid: int, P: int, max_new: int) -> None:
        super()._validate_capacity(uid, P, max_new)
        n_total = -(-M.decode_capacity(self.cfg, P, max_new)
                    // self.block_len)
        if n_total > self.n_blocks - 1:
            # admission could otherwise stall forever waiting for blocks
            # the pool can never provide, even with every slot free
            raise ValueError(
                f"request {uid}: needs {n_total} blocks > pool of "
                f"{self.n_blocks - 1} allocatable blocks")

    def _n_total_blocks(self, req: Request) -> int:
        return -(-M.decode_capacity(self.cfg, req.prompt_len, req.max_new)
                 // self.block_len)

    def _plan(self, req: Request):
        bl = self.block_len
        pos0 = M.decode_pos0(self.cfg, req.prompt_len)
        n_pb = -(-pos0 // bl)
        if req.plan_keys is None:
            req.plan_keys = (pg.prefix_keys(req.batch, pos0 // bl, bl,
                                            M.decode_offset(self.cfg))
                             if self.share_prefix else [])
        keys = req.plan_keys
        # lazy admission claims only the prompt's blocks; the rest are
        # claimed per segment as the write frontier crosses boundaries
        n_alloc = n_pb if self.lazy else self._n_total_blocks(req)
        # the lookup part IS re-evaluated per attempt: pool contents
        # change between segments while the request waits for blocks
        missing = n_alloc - sum(1 for k in keys
                                if self.alloc.lookup(k) is not None)
        return {"keys": keys, "n_pb": n_pb, "n_alloc": n_alloc,
                "missing": missing}

    def _fits(self, plan) -> bool:
        return plan["missing"] <= self.alloc.n_free

    def _acquire_blocks(self, uid: int, plan):
        """Claim the plan's blocks: shared ``acquire`` for full prompt
        blocks, private ``alloc`` from the partial tail onward (decode
        writes and diverged suffixes must never alias).  Returns
        (ids, fresh) — ``fresh[i]`` False iff block i was pooled."""
        keys = plan["keys"]
        ids, fresh = [], []
        for i in range(plan["n_alloc"]):
            if i < len(keys):
                bid, fr = self.alloc.acquire(keys[i])
                self.stats["shared_blocks" if not fr
                           else "fresh_blocks"] += 1
            else:
                bid, fr = self.alloc.alloc(), True
                self.stats["fresh_blocks"] += 1
            ids.append(bid)
            fresh.append(fr)
        self._slot_blocks[uid] = ids
        self.stats["peak_live_blocks"] = max(self.stats["peak_live_blocks"],
                                             self.alloc.n_live)
        return ids, fresh

    def _place(self, slot: int, req: Request, pc, plan) -> None:
        ids, fresh = self._acquire_blocks(req.uid, plan)
        n_pb, bl = plan["n_pb"], self.block_len
        row = np.full((self.max_blocks,), pg.TRASH, np.int32)
        row[:len(ids)] = ids
        self.block_tables[slot] = row
        sub = M.prefill_into_cache(
            self.cfg, M.init_decode_cache(self.cfg, 1, n_pb * bl,
                                          device=self.device), pc)
        M.scatter_prefill_paged(self.cfg, self.cache, sub, ids[:n_pb],
                                fresh[:n_pb], block_len=bl)

    def _rollback_place(self, slot: int, req: Request) -> None:
        for bid in self._slot_blocks.pop(req.uid, []):
            self.alloc.release(bid)
        self.block_tables[slot] = pg.TRASH
        self.pos[slot] = 0

    def _release_slot(self, slot: int) -> None:
        uid = int(self.slot_uid[slot])
        super()._release_slot(slot)
        for bid in self._slot_blocks.pop(uid, []):
            self.alloc.release(bid)
        # dead lane: writes pin to (trash block, offset 0) until re-admitted
        self.block_tables[slot] = pg.TRASH
        self.pos[slot] = 0

    # -- lazy per-segment block claiming + preemption ----------------------

    def _segment_needs(self) -> Dict[int, int]:
        """slot -> blocks to claim so the coming segment's writes stay
        inside the slot's table (frontier can advance min(seg_len, rem)
        positions; capacity-capped)."""
        bl, needs = self.block_len, {}
        for s in range(self.n_slots):
            uid = int(self.slot_uid[s])
            if uid < 0:
                continue
            adv = int(min(self.seg_len, self.rem[s]))
            if adv <= 0:
                continue
            last_write = int(self.pos[s]) + adv - 1
            n_total = self._n_total_blocks(self._live_req[uid])
            need = min(last_write // bl + 1, n_total)
            have = len(self._slot_blocks[uid])
            if need > have:
                needs[s] = need - have
        return needs

    def _preempt_youngest(self) -> None:
        """Return the youngest-admitted live request to the queue (its
        blocks go back to the pool; replay is deterministic, so its
        final tokens are unaffected)."""
        live = [s for s in range(self.n_slots) if self.slot_uid[s] >= 0]
        if len(live) <= 1:
            # unreachable: submit() rejects requests larger than the pool
            raise RuntimeError("paged pool exhausted by a single request")
        s = max(live, key=lambda s: self._slot_seq[s])
        uid = int(self.slot_uid[s])
        req = self._live_req.pop(uid)
        # roll back the discarded work so token/utilization stats only
        # count emissions that reach a completion (emission #1 came from
        # the prefill, not a slot step)
        discarded = self._out.pop(uid)
        self.stats["generated_tokens"] -= len(discarded)
        self.stats["live_slot_steps"] -= len(discarded) - 1
        self._plen.pop(uid)
        self._nseg.pop(uid)
        self.slot_uid[s] = -1
        self.rem[s] = 0
        self._rollback_place(s, req)
        self.queue.appendleft(req)  # admitted before anything still queued
        self._pending.add(uid)
        self.stats["preemptions"] += 1

    def _pre_segment(self) -> None:
        needs = self._segment_needs()
        while sum(needs.values()) > self.alloc.n_free:
            self._preempt_youngest()
            needs = self._segment_needs()
        for s, n in needs.items():
            ids = self._slot_blocks[int(self.slot_uid[s])]
            for _ in range(n):
                bid = self.alloc.alloc()
                self.block_tables[s, len(ids)] = bid
                ids.append(bid)
            self.stats["lazy_claimed_blocks"] += n
            self.stats["fresh_blocks"] += n
        if needs:
            self.stats["peak_live_blocks"] = max(
                self.stats["peak_live_blocks"], self.alloc.n_live)

    # -- decode segment ----------------------------------------------------

    def _segment_kw(self) -> dict:
        return {"block_tables": torch.as_tensor(self.block_tables,
                                                device=self.device)}
