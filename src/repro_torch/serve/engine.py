"""Slot-based continuous-batching generation engine.

Counterpart of ``repro.serve.engine``.  The engine serves a queue of
variable-length requests through a fixed set of ``n_slots`` batch rows:

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
A family whose decode state is all per-slot recurrent (the ssm family)
has no paged leaves: the paged engine then keeps no block pool, shares
no prefix and never preempts, and admission overwrites the slot's state
and conv tail whole, as in the reference.  The hybrid family pools its
shared attention's K/V like any attention leaf, while its Mamba-2 state
and conv tails stay one row per slot, overwritten whole at admission.

``kv_dtype`` (``quant.KV_DTYPES``) is the KV cache's storage policy:
``""`` keeps the parameters' dtype, ``"bf16"``/``"fp32"`` change it,
``"int8"``/``"fp8"`` quantize each written row with a per-(position,
kv-head) f32 scale (``models/quant.py``).  Admission grafts the prefill
at full precision and quantizes it once; prefix keys carry the policy,
so a quantized pool never shares blocks written under another dtype.
The recurrent state of the ssm and hybrid families ignores the policy.

With ``chunk_len`` set, admission is **bucketed chunked prefill**, as in
the reference: each prompt takes a rung of a bucket ladder (``buckets``,
by default powers-of-two multiples of ``chunk_len``;
``serve/bucketing.py``) and runs through the shared decode body in
``chunk_len``-token chunks (``model.prefill_chunked``) straight into
the slot's B=1 view of the engine cache (narrowed, so the writes land in
place: nothing is grafted or scattered back).  Prefill memory is bounded
by the chunk, not the prompt.  The paged engine hands it rung-wide read
and write tables; the write table sends already-pooled shared prefix
blocks to the trash block, so shared rows are never rewritten.  The
reference keys its compiled admission executables on the rung, pads the
prompt to it and counts their builds (``CompiledLRU``,
``compiles_built``); the port compiles nothing and has neither.  So the
rung here only bounds what a request may occupy (its capacity check and
the tables' width): the prompt is padded to the next multiple of
``chunk_len`` alone, and the rung's all-pad chunks after it, which
``n_valid`` freezes and which would change no state and no token, are
not run.

MoE configurations serve as in the reference with ``mesh=None``: the
engine sets ``moe_dropless`` (which only the expert-parallel paths
read), and every decode step passes ``live = ~done``, so a finished
slot's garbage lane combines with routing weight 0.  Leading dense
layers (``dense_blocks``) are pooled like ``blocks``.  DeepSeek-V3's
MLA latent cache (``{"ckv", "kr"}``, quantized with one scale a row)
is pooled and admitted like any attention leaf.

The VLM family's requests carry ``patches`` (1, frontend_tokens,
d_model) beside their tokens, held on the host in the model's dtype:
every admission (one-shot, bucketed, a preempted request's replay)
prefills ``[patches | text]``, a rung counts the patch rows, only the
tokens are padded, and the paged engine's prefix keys digest the
patches, so requests with other patches share no block.  The
encoder-decoder family's requests carry ``frames`` the same way: every
admission runs the encoder over them and writes the slot's ``cross``
K/V and ``memory``, which stay one row per slot (no sequence axis)
while the decoder's ``self`` K/V is pooled; no row of the sequence
holds frames (``decode_offset`` 0), and the prefix keys digest them,
so a block is shared only between requests with equal frames.

Sampling and speculative decode, as in the reference.  ``sampler``
(``serve/sampling.py``: ``Greedy`` by default, ``Temperature``,
``TopK``) draws from each slot's stream: its key comes from ``seed`` and
the request's uid (or the int ``submit(key=)`` takes), emission #1 is
drawn at counter 0, and every decode step moves every slot's counter on
by one, live or not, so tokens are the same whatever the segment length
and after a paged preemption replays the request.  ``speculate=k``
drafts k tokens a step with the model's MTP head and verifies k+1
positions in one chunk (``model.generate``); the slot's draft seed
``h_spec`` starts from the prefill's last hidden (unbucketed) or zeros
(bucketed admission); ``spec_acceptance()`` and the ``spec_steps`` /
``spec_extra_tokens`` stats count what the drafts bought.  The paged
engine's tables get ``_spec_spare`` trash columns past ``max_blocks``
for the verify chunk's overshoot at a request's capacity, and its lazy
claims reach ``speculate`` positions past the last accepted one.

Sharded serving: with ``mesh`` (a ``DeviceMesh`` of dims ``("data",
"model")``, ``launch/mesh.py``) every rank runs one engine over the
same host schedule, and the MoE sub-layers take the expert-parallel path
``moe.moe_path`` picks (``cfg.moe_impl``; "auto" is "a2a" on more than
one rank); each rank keeps only its own experts (``moe.shard_experts``).
The dense weights and the cache stay whole on every rank in this slice,
so every rank computes the same tokens; ``run`` ends by checking that
every rank's completions are equal.  The paged engine splits its
allocator's free lists over the data axes (``n_shards``), as the
reference's does for its sharded pool.  With ``cfg.overlap_a2a`` a
contiguous decode step runs as two batch halves
(``model._decode_step_overlapped``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import model as M
from repro_torch.models import moe, quant
from repro_torch.models.config import ModelConfig
from repro_torch.serve import bucketing as bk
from repro_torch.serve import paged as pg
from repro_torch.serve.sampling import Greedy
from repro_torch.sharding import rules
from repro_torch.utils.device import resolve_device
from repro_torch.utils.rng import Stream, stream_key


@dataclasses.dataclass
class Request:
    """One generation request.  ``batch`` holds ``tokens`` (1, P) as a
    host array and, for the VLM family, ``patches`` (the encoder-decoder
    family: ``frames``) (1, frontend_tokens, d_model) as a host tensor in
    the model's dtype; ``max_new`` counts
    ALL generated tokens, including the one sampled from the prefill
    logits."""
    uid: int
    batch: Dict[str, Any]
    max_new: int
    key: Optional[int] = None  # the stream's seed (from uid if None)
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


def _mesh_axes(mesh):
    """The axes of an engine's mesh, which must be a ``DeviceMesh`` of
    dims ("data", "model")."""
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != ("data",
                                                              "model"):
        raise TypeError(f"mesh must be a DeviceMesh of dims ('data', "
                        f"'model') (launch/mesh.py), not {mesh!r}")
    return rules.as_abstract(mesh)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _slot_view(cache, slot: int, bat, seq=None):
    """The B=1 view of row ``slot`` of the engine cache along each leaf's
    batch axis (``bat`` from ``decode_cache_batch_axes``); writes to it
    land in the engine cache.  Leaves with a sequence axis in ``seq``
    (paged pools) pass through whole."""
    if isinstance(cache, dict):
        return {k: _slot_view(cache[k], slot, bat[k],
                              None if seq is None else seq[k])
                for k in cache}
    if seq is not None and seq >= 0:
        return cache
    return cache.narrow(bat, slot, 1)


def _scatter_slot_row(cache, sub, slot: int, axes):
    """Write a B=1 contiguous cache into row ``slot`` of the engine cache,
    in place, along each leaf's batch axis (``axes`` from
    ``decode_cache_batch_axes``: behind one stacked axis, or two for the
    hybrid family's Mamba-2 groups)."""
    if isinstance(cache, dict):
        for k in cache:
            _scatter_slot_row(cache[k], sub[k], slot, axes[k])
        return cache
    cache.select(axes, slot).copy_(sub.select(axes, 0))
    return cache


class ServeEngine:
    """Continuous-batching engine over a fixed ``(n_slots, max_len)``
    decode cache.  ``submit()`` requests, then ``run()`` (or ``step()``
    segment by segment); drain finished requests with
    ``pop_completions()`` under sustained traffic.

    ``device`` defaults to the card and must hold ``params``; pass
    ``device="cpu"`` to serve on the CPU.  ``chunk_len`` switches
    admission to bucketed chunked prefill (module docstring); ``buckets``
    overrides its ladder and needs ``chunk_len``.  ``seed`` keys the
    requests' random streams; ``speculate`` is the number of drafts a
    step (0: no speculative decode).  ``mesh``: sharded serving (module
    docstring); ``params`` are whole, the engine keeps this rank's
    experts.
    """

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 max_len: int = 128, sampler=None,
                 eos_id: Optional[int] = None, seg_len: int = 8,
                 device="cuda", seed: int = 0, history_limit: int = 4096,
                 chunk_len: Optional[int] = None, buckets=None,
                 speculate: int = 0, kv_dtype: str = "", mesh=None):
        if mesh is not None:
            _mesh_axes(mesh)
        self.speculate = int(speculate)
        if self.speculate and not (cfg.n_mtp and "mtp" in params):
            raise ValueError(
                "speculate requires an MTP head: cfg.n_mtp > 0 with "
                "params['mtp'] (dense/moe/vlm families)")
        cfg.validate()
        if cfg.is_moe and not cfg.moe_dropless:
            # as the reference engine: serving sizes expert-parallel
            # buffers to the worst case (one device reads no such buffer)
            cfg = cfg.replace(moe_dropless=True)
        self.device = resolve_device(device)
        leaf_dev = _first_leaf(params).device
        if leaf_dev.type != self.device.type:
            raise ValueError(f"params lie on {leaf_dev}, engine device is "
                             f"{self.device}")
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh cannot serve "
                                 f"on {self.device}")
            params = moe.shard_experts(params, cfg, mesh)
        self.mesh = mesh
        self.params, self.cfg = params, cfg
        self.kv_dtype = kv_dtype
        self.policy = quant.CachePolicy(kv_dtype)
        self.n_slots, self.max_len, self.seg_len = n_slots, max_len, seg_len
        self.sampler = sampler if sampler is not None else Greedy()
        self.eos_id, self.seed = eos_id, seed
        self.chunk_len = chunk_len
        if chunk_len is not None:
            ladder = (bk.bucket_ladder(chunk_len, max_len)
                      if buckets is None else buckets)
            self.buckets = bk.validate_ladder(ladder, chunk_len)
        else:
            if buckets is not None:
                raise ValueError("buckets requires chunk_len")
            self.buckets = None
        self._init_cache()
        # per-slot host state
        self.tok = np.zeros((n_slots,), np.int32)
        self.pos = np.zeros((n_slots,), np.int32)
        self.rem = np.zeros((n_slots,), np.int32)
        # each slot's stream: key words and step counter
        self.keys = np.zeros((n_slots, 2), np.int64)
        self.ctr = np.zeros((n_slots,), np.int64)
        # speculative decode's draft seed: the final-normed hidden of the
        # position that emitted the slot's pending token
        self.h_spec = torch.zeros((n_slots, cfg.d_model),
                                  dtype=M._dtype(cfg), device=self.device)
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
                      "prefill_chunks": 0, "slot_steps": 0,
                      "live_slot_steps": 0, "spec_steps": 0,
                      "spec_extra_tokens": 0,
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
                                         self.max_len, device=self.device,
                                         policy=self.policy)

    # -- request intake ----------------------------------------------------

    def submit(self, batch, *, max_new: int, uid: Optional[int] = None,
               key: Optional[int] = None) -> int:
        """Queue one request; ``key`` (an int) seeds its random stream in
        place of the engine's ``seed`` and its uid."""
        if uid is None:
            uid = self._uid_auto
            self._uid_auto += 1
        else:
            self._uid_auto = max(self._uid_auto, uid + 1)
        if uid in self.completions or uid in self._out or uid in self._pending:
            raise ValueError(f"request {uid}: uid already in use")
        front = M.frontend_key(self.cfg)
        keys = {"tokens"} if front is None else {"tokens", front}
        if set(batch) != keys:
            raise ValueError(f"request {uid}: {self.cfg.name} takes a batch "
                             f"of {sorted(keys)}, got {sorted(batch)}")
        toks = batch["tokens"]
        if isinstance(toks, torch.Tensor):
            toks = toks.cpu().numpy()
        toks = np.asarray(toks, np.int32)
        if toks.ndim != 2 or toks.shape[0] != 1:
            raise ValueError(
                f"request {uid}: tokens must have shape (1, P), got "
                f"{toks.shape} (one request per submit)")
        host = {"tokens": toks}
        if front is not None:
            host[front] = self._host_frontend(uid, front, batch[front])
        self._validate_capacity(uid, toks.shape[1], max_new)
        if max_new < 1:
            raise ValueError(f"request {uid}: max_new must be >= 1")
        self.queue.append(Request(uid, host, max_new,
                                  None if key is None else int(key)))
        self._pending.add(uid)
        self._t_submit[uid] = time.perf_counter()
        return uid

    def _host_frontend(self, uid: int, key: str, rows) -> torch.Tensor:
        """A request's stub frontend rows (VLM ``patches``, encoder-decoder
        ``frames``) as one host tensor in the model's dtype (the cast the
        backbone would make), checked for shape."""
        want = (1, self.cfg.frontend_tokens, self.cfg.d_model)
        if tuple(rows.shape) != want:
            raise ValueError(f"request {uid}: {key} must have shape {want}, "
                             f"got {tuple(rows.shape)}")
        return torch.as_tensor(rows).to("cpu", M._dtype(self.cfg))

    def _device_batch(self, req: Request, toks) -> Dict[str, torch.Tensor]:
        """The request's batch on the device with ``toks`` (1, T) as its
        tokens; the frontend rows ride along."""
        batch = {k: v.to(self.device) for k, v in req.batch.items()
                 if k != "tokens"}
        batch["tokens"] = torch.as_tensor(toks, device=self.device)
        return batch

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

    def _bucket_rung(self, P: int) -> int:
        """Bucket for a P-token prompt: the padded input length (modality
        frontend + tokens) rounded up the ladder."""
        return bk.bucket_for(M.decode_pos0(self.cfg, P), self.buckets,
                             self.chunk_len)

    def _padded_batch(self, req: Request, length: int):
        """The request's batch on the device, tokens right-padded with 0 so
        the input sequence (patch rows included) is exactly ``length``
        long (pads are masked out of cache and state by
        ``prefill_chunked``); the frontend rows are never padded."""
        toks = np.zeros((1, length - M.decode_offset(self.cfg)), np.int32)
        toks[:, :req.prompt_len] = req.batch["tokens"]
        return self._device_batch(req, toks)

    def _plan(self, req: Request):
        """Admission plan (bucket rung; paged adds block keys/counts).
        None = nothing to plan (unbucketed contiguous admission)."""
        if self.chunk_len is None:
            return None
        return {"rung": self._bucket_rung(req.prompt_len)}

    def _fits(self, plan) -> bool:
        """Can the planned request be placed right now?"""
        return True

    def _place(self, slot: int, req: Request, pc, plan) -> None:
        sub = M.prefill_into_cache(
            self.cfg, M.init_decode_cache(self.cfg, 1, self.max_len,
                                          device=self.device), pc)
        # graft at full precision, then quantize the whole slot row to
        # the cache's policy (adds the scale leaves)
        _scatter_slot_row(self.cache, M.match_cache_policy(self.cache, sub),
                          slot, M.decode_cache_batch_axes(self.cfg,
                                                          self.policy))

    def _admit_chunked_into(self, slot: int, req: Request, plan, **tables):
        """Run the bucketed chunked prefill straight into ``slot``'s B=1
        view of the cache (paged: pools whole, read and written through
        ``tables``), over the chunks that hold real tokens (the rung's
        all-pad chunks would change nothing); returns the last real
        token's logits (1, V)."""
        C = self.chunk_len
        n_chunks = -(-M.decode_pos0(self.cfg, req.prompt_len) // C)
        bat = M.decode_cache_batch_axes(self.cfg, self.policy)
        seq = (M.decode_cache_seq_axes(self.cfg, self.policy) if tables
               else None)
        self.stats["prefill_chunks"] += n_chunks
        logits, _ = M.prefill_chunked(
            self.params, self.cfg, _slot_view(self.cache, slot, bat, seq),
            self._padded_batch(req, n_chunks * C), req.prompt_len,
            chunk_len=self.chunk_len, mesh=self.mesh, **tables)
        return logits

    def _rollback_place(self, slot: int, req: Request) -> None:
        """Undo a chunked placement whose request finished at prefill: the
        slot was never marked live, so only layout resources (paged
        blocks) go back."""

    def _release_slot(self, slot: int) -> None:
        self.slot_uid[slot] = -1
        # EOS can finish a slot with budget left: zero it so the freed
        # lane runs masked (done = rem<=0) until re-admitted
        self.rem[slot] = 0
        self.h_spec[slot] = 0

    def _admit(self) -> None:
        free = [s for s in range(self.n_slots) if self.slot_uid[s] < 0]
        while free and self.queue:
            req = self.queue[0]
            plan = self._plan(req)
            if not self._fits(plan):
                break  # blocked on pool space: keep arrival order
            self.queue.popleft()
            self._pending.discard(req.uid)
            slot = free[0]
            h0 = None
            if self.chunk_len is None:
                # slotless B=1 prefill; the graft is deferred so a request
                # finishing at prefill never touches the cache
                logits, pc = M.prefill(
                    self.params, self.cfg,
                    self._device_batch(req, req.batch["tokens"]),
                    return_hidden=bool(self.speculate), mesh=self.mesh)
                if self.speculate:
                    logits, h0 = logits
            else:
                # bucketed: the chunked prefill IS the placement, through
                # the slot's cache row / block tables
                logits = self._admit_chunked_into(slot, req, plan)
            key = (stream_key(self.seed, req.uid) if req.key is None
                   else stream_key(req.key))
            # emission #1 draws at counter 0, decode steps from 1 on
            e0 = int(self.sampler(Stream.of([key], [0], self.device),
                                  logits)[0])
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
                if self.chunk_len is not None:
                    self._rollback_place(slot, req)
                continue
            free.pop(0)
            if self.chunk_len is None:
                self._place(slot, req, pc, plan)
            self.slot_uid[slot] = req.uid
            self._slot_seq[slot] = self._admit_seq
            self._admit_seq += 1
            self._live_req[req.uid] = req
            self.tok[slot] = e0
            self.pos[slot] = M.decode_pos0(self.cfg, req.prompt_len)
            self.rem[slot] = req.max_new - 1
            self.keys[slot], self.ctr[slot] = key, 1
            # unbucketed admission seeds the draft chain with the prefill's
            # last hidden (the position that emitted e0); bucketed stays
            # cold (its first drafts are simply rejected).  Draft quality
            # never changes the accepted tokens
            self.h_spec[slot] = 0 if h0 is None else h0[0]
        self.stats["peak_live_requests"] = max(
            self.stats["peak_live_requests"], int((self.slot_uid >= 0).sum()))

    # -- decode segment ----------------------------------------------------

    def _segment_kw(self) -> dict:
        if not self.speculate:
            return {}
        return {"speculate": self.speculate, "spec_h": self.h_spec}

    def spec_acceptance(self) -> float:
        """Fraction of the k draft lanes of the live steps that yielded an
        accepted token (0.0 when not speculating or nothing ran)."""
        denom = self.stats["spec_steps"] * self.speculate
        return self.stats["spec_extra_tokens"] / denom if denom else 0.0

    def _segment(self) -> None:
        t0 = time.perf_counter()
        dev = self.device
        res = M.generate(self.params, self.cfg, self.cache,
                         torch.as_tensor(self.tok, device=dev),
                         torch.as_tensor(self.pos, device=dev),
                         steps=self.seg_len, sampler=self.sampler,
                         rng=Stream.of(self.keys, self.ctr, dev),
                         eos_id=self.eos_id,
                         remaining=torch.as_tensor(self.rem, device=dev),
                         mesh=self.mesh, **self._segment_kw())
        # the stream moved on by seg_len steps in every slot
        self.ctr += self.seg_len
        toks = res["tokens"].cpu().numpy()
        valid = res["valid"].cpu().numpy()
        done = res["done"].cpu().numpy()
        # writable copies — _admit() mutates these per slot
        self.tok = res["next_tok"].cpu().numpy().copy()
        self.pos = res["pos"].cpu().numpy().copy()
        self.rem = res["remaining"].cpu().numpy().copy()
        self.stats["decode_s"] += time.perf_counter() - t0
        if self.speculate:
            self.h_spec = res["h_spec"]
            # a live slot always emits at column i*(k+1) of step i, so those
            # columns count its live steps; every further valid column is a
            # token the drafts got for free
            first = valid[:, ::self.speculate + 1]
            self.stats["spec_steps"] += int(first.sum())
            self.stats["spec_extra_tokens"] += int(valid.sum() - first.sum())
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
        # each step can emit up to k+1 tokens a slot when speculating
        self.stats["slot_steps"] += (self.n_slots * self.seg_len
                                     * (self.speculate + 1))
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
        """Drain the queue: segments with admission in between.  On a mesh
        of more than one rank, every rank's completions must be equal."""
        t0 = time.perf_counter()
        while not self.idle:
            self.step()
        self.stats["wall_s"] = (self.stats.get("wall_s", 0.0)
                                + time.perf_counter() - t0)
        if self.mesh is not None and dist.get_world_size() > 1:
            self._check_ranks_agree()
        return self.completions

    def _check_ranks_agree(self) -> None:
        mine = {u: c.tokens.tolist() for u, c in self.completions.items()}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        bad = [r for r, theirs in enumerate(every) if theirs != mine]
        if bad:
            raise RuntimeError(f"rank {dist.get_rank()}: completions differ "
                               f"from ranks {bad}")


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
    deterministic replay (its stream restarts from its key, so its final
    tokens are unchanged).
    The oldest request is never preempted, which guarantees progress.
    ``lazy=False`` claims ``ceil(decode_capacity / block_len)`` blocks
    at admission.  For a family without paged leaves (ssm) no block is
    ever claimed and every table entry stays the trash block.
    """

    def __init__(self, params, cfg: ModelConfig, *, block_len: int = 16,
                 n_blocks: Optional[int] = None, n_slots: int = 4,
                 max_len: int = 128, share_prefix: bool = True,
                 lazy: bool = True, **kw):
        self.block_len = block_len
        self.max_blocks = -(-max_len // block_len)
        # a verify chunk writes up to k positions past the accepted
        # frontier: at a request's capacity that would index past its
        # table, so each table gets spare columns, always the trash block
        spec = int(kw.get("speculate", 0) or 0)
        self._spec_spare = -(-spec // block_len) if spec else 0
        self._table_w = self.max_blocks + self._spec_spare
        # default pool: worst case every slot holds max_len live tokens
        self.n_blocks = (1 + n_slots * self.max_blocks
                         if n_blocks is None else n_blocks)
        self._has_paged = M.has_paged_leaves(cfg)
        self.share_prefix = share_prefix and self._has_paged
        self.lazy = lazy and self._has_paged
        # per-shard free lists over the data axes, as the reference's
        # sharded pool (each data shard a contiguous run of block ids)
        n_shards = 1
        if kw.get("mesh") is not None:
            m = _mesh_axes(kw["mesh"])
            n_data = math.prod(m.shape[a] for a in rules.data_axes_of(m))
            if n_data > 1 and self.n_blocks % n_data == 0:
                n_shards = n_data
        self.alloc = pg.PagedAllocator(self.n_blocks, block_len,
                                       n_shards=n_shards)
        self.block_tables = np.full((n_slots, self._table_w), pg.TRASH,
                                    np.int32)
        self._slot_blocks: Dict[int, List[int]] = {}  # uid -> held block ids
        super().__init__(params, cfg, n_slots=n_slots, max_len=max_len, **kw)
        self.stats.update({"shared_blocks": 0, "fresh_blocks": 0,
                           "peak_live_blocks": 0, "lazy_claimed_blocks": 0,
                           "preemptions": 0})

    # -- cache layout ------------------------------------------------------

    def _init_cache(self) -> None:
        self.cache = M.init_paged_cache(self.cfg, self.n_slots,
                                        self.n_blocks, self.block_len,
                                        device=self.device,
                                        policy=self.policy)

    # -- admission ---------------------------------------------------------

    def _validate_capacity(self, uid: int, P: int, max_new: int) -> None:
        super()._validate_capacity(uid, P, max_new)
        if not self._has_paged:
            return
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
        rung = (self._bucket_rung(req.prompt_len)
                if self.chunk_len is not None else None)
        if not self._has_paged:
            return {"rung": rung, "keys": [], "n_pb": 0, "n_alloc": 0,
                    "missing": 0}
        bl = self.block_len
        pos0 = M.decode_pos0(self.cfg, req.prompt_len)
        n_pb = -(-pos0 // bl)
        if req.plan_keys is None:
            req.plan_keys = (pg.prefix_keys(req.batch, pos0 // bl, bl,
                                            M.decode_offset(self.cfg),
                                            policy=self.kv_dtype)
                             if self.share_prefix else [])
        keys = req.plan_keys
        # lazy admission claims only the prompt's blocks; the rest are
        # claimed per segment as the write frontier crosses boundaries
        n_alloc = n_pb if self.lazy else self._n_total_blocks(req)
        # the lookup part IS re-evaluated per attempt: pool contents
        # change between segments while the request waits for blocks
        missing = n_alloc - sum(1 for k in keys
                                if self.alloc.lookup(k) is not None)
        return {"rung": rung, "keys": keys, "n_pb": n_pb, "n_alloc": n_alloc,
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

    def _set_table_row(self, slot: int, ids) -> None:
        # ids never pass max_blocks, so the _spec_spare columns stay TRASH
        # for the slot's whole life: writes past capacity are diverted
        row = np.full((self._table_w,), pg.TRASH, np.int32)
        row[:len(ids)] = ids
        self.block_tables[slot] = row

    def _place(self, slot: int, req: Request, pc, plan) -> None:
        ids, fresh = self._acquire_blocks(req.uid, plan)
        n_pb, bl = plan["n_pb"], self.block_len
        self._set_table_row(slot, ids)
        sub = M.prefill_into_cache(
            self.cfg, M.init_decode_cache(self.cfg, 1, n_pb * bl,
                                          device=self.device), pc)
        M.scatter_prefill_paged(self.cfg, self.cache, sub, slot, ids[:n_pb],
                                fresh[:n_pb], block_len=bl)

    def _admit_chunked_into(self, slot: int, req: Request, plan):
        """Chunked admission against the paged layout: rung-wide read and
        write tables holding the prompt's blocks (every padded position
        fits; pads past the prompt's blocks land in the trash block).
        The write table sends already-pooled shared prefix blocks to the
        trash block, so content other requests read is never rewritten.
        Eager mode's decode blocks enter the slot's segment table only."""
        rung, bl = plan["rung"], self.block_len
        W = -(-rung // bl)
        read = np.full((1, W), pg.TRASH, np.int32)
        write = np.full((1, W), pg.TRASH, np.int32)
        if self._has_paged:
            ids, fresh = self._acquire_blocks(req.uid, plan)
            n_pb = plan["n_pb"]      # <= W, since pos0 <= rung
            read[0, :n_pb] = ids[:n_pb]
            write[0, :n_pb] = [bid if fr else pg.TRASH
                               for bid, fr in zip(ids[:n_pb], fresh[:n_pb])]
            self._set_table_row(slot, ids)
        dev = self.device
        return super()._admit_chunked_into(
            slot, req, plan, block_tables=torch.as_tensor(read, device=dev),
            write_tables=torch.as_tensor(write, device=dev))

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
        inside the slot's table (the frontier can advance min(seg_len ·
        (speculate + 1), rem) positions; capacity-capped)."""
        bl, needs = self.block_len, {}
        for s in range(self.n_slots):
            uid = int(self.slot_uid[s])
            if uid < 0:
                continue
            adv = int(min(self.seg_len * (self.speculate + 1), self.rem[s]))
            if adv <= 0:
                continue
            # + speculate: the step that lands the last accepted token
            # also wrote its rejected drafts past the frontier
            last_write = int(self.pos[s]) + adv - 1 + self.speculate
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
        if not self._has_paged:
            return
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
        return {**super()._segment_kw(),
                "block_tables": torch.as_tensor(self.block_tables,
                                                device=self.device)}
