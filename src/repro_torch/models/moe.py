"""Mixture-of-Experts FFN layer (routed + shared experts).

Counterpart of ``repro.models.moe`` for one device (``mesh=None``), with
the reference's parameter layout: ``router`` (D, E) in f32, the routed
experts stacked as ``wi_gate`` / ``wi_up`` (E, D, F) and ``wo``
(E, F, D), and the shared experts as one gated MLP of width
F · n_shared under ``shared``.

``moe_dense`` has the reference's two paths:

* ``cfg.use_kernels``: ``kernels/moe_gemm/ops.py::moe_ffn``: dispatch
  into fixed-capacity buffers, the grouped FFN and the weighted combine
  through the hand-written CUDA kernels (their plain versions on CPU
  tensors).  The capacity can drop assignments, as the reference's
  ``use_pallas=True`` path does.
* otherwise the dropless all-experts einsum of the reference's
  ``use_pallas=False`` path.

The serving ``live`` mask (B, S) zeroes dead rows' routing weights,
so a freed slot's garbage lane combines with weight 0 (its routed
output is exactly 0).  As in the reference's one-device path, dead rows
still take capacity ranks in ``moe_ffn``: with at most 8 decode slots
the capacity (at least 8) holds every assignment, so nothing can drop.
A chunked prefill's bucket pads are dead rows at the chunk's tail: they
rank after every live row, so they never crowd one out.

The expert-parallel paths run over a ``DeviceMesh`` (``launch/mesh.py``),
each rank one device of the reference's ``shard_map`` mesh:

* ``moe_a2a``: the rank takes its data shard's rows (all rows when B·S
  does not divide over the data axes), packs them into per-(expert,
  capacity slot) buffers through ``token_dispatch`` (kernel 6), sends
  each expert block to its owner with ``all_to_all_single`` over the
  mesh's "model" group, runs the grouped FFN (kernel 4; kernel 5 in its
  backward) on its own ``E_pad / ep`` experts, sends the results back,
  combines them through ``token_combine`` and all-gathers the data
  shards.  Capacity is per (source rank, expert), from the rank's own
  rows (``_capacity``), so under drops it computes another function
  than ``moe_dense``, as the reference does.
* ``moe_replicated_ep``: every rank holds every row, keeps the
  assignments of its own experts (the mesh's experts one block a rank,
  over every axis) and ends in one ``all_reduce`` over the mesh.

A rank holds only its own experts (``shard_experts``, cut by
``sharding.rules.param_specs``; expert counts that do not divide the
axis are padded with zero experts, which no token is routed to, so
their gradients are zero); ``gather_experts`` puts the whole stacks
back together, and in training ``shard_opt_state`` cuts the AdamW
moments the same way and ``clip_shards`` tells the clip which leaves
are blocks (``optim/adamw.py``).  The
router, the shared experts and the tokens are whole on every rank, and
every rank computes the same output.  Gradients flow through the
collectives with the reference's ``shard_map`` semantics: an output
replicated over r ranks passes each rank 1/r of its cotangent, and a
replicated input's gradient is summed over the ranks that hold it
(``_ShardRows``, ``_GatherRows``, ``_SumGrads``, ``_SumReplicated``),
so every leaf's gradient equals the reference's.
"""
from __future__ import annotations

import math
import re

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels.moe_dispatch.ops import (capacity_positions,
                                                  routing_layouts,
                                                  token_combine,
                                                  token_dispatch)
from repro_torch.kernels.moe_gemm import ops as moe_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules


def init_moe(generator, cfg: ModelConfig, dtype, lead=()):
    """Router, routed experts and shared experts of one MoE sub-layer
    (``lead`` prepends stacked group axes)."""
    D = cfg.d_model
    Fh = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    p = {
        "router": layers.dense_init(generator, (D, E), 0, torch.float32,
                                    lead),
        "wi_gate": layers.dense_init(generator, (E, D, Fh), 1, dtype, lead),
        "wi_up": layers.dense_init(generator, (E, D, Fh), 1, dtype, lead),
        "wo": layers.dense_init(generator, (E, Fh, D), 1, dtype, lead),
    }
    if cfg.n_shared_experts:
        p["shared"] = layers.init_mlp(generator, cfg, D,
                                      Fh * cfg.n_shared_experts, dtype, lead)
    return p


def route(p, cfg: ModelConfig, x, live=None):
    """Returns (weights (T, k) f32, expert ids (T, k), aux loss scalar).

    x: (T, D) flat tokens.  Softmax, then top-k, then renormalise, with
    the load-balance auxiliary loss E · Σ_e f_e · p_e (GShard / Switch).
    ``live`` (T,) bool zeroes dead rows' weights after the
    renormalisation (the aux loss still sees every row, as in the
    reference).
    """
    logits = x.float() @ p["router"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    if live is not None:
        w = torch.where(live[:, None], w, torch.zeros_like(w))
    return w, idx, load_balance_loss(cfg, probs, idx)


def load_balance_loss(cfg: ModelConfig, probs, idx):
    """E · Σ_e f_e · p_e · coef: p_e the mean router probability of
    expert e, f_e the share of assignments routed to it."""
    E = cfg.n_experts
    me = probs.mean(0)                                    # mean prob
    one_hot = F.one_hot(idx, E).float()                   # (T, k, E)
    fe = one_hot.sum(1).mean(0)                           # routed share
    return E * torch.sum(me * fe) * cfg.router_aux_coef


def moe_dense(p, cfg: ModelConfig, x, live=None):
    """x: (B, S, D) -> (out (B, S, D), aux).  Routed experts through
    ``moe_ffn`` (``cfg.use_kernels``) or every expert on every token,
    plus the shared experts.  ``live`` (B, S) bool zeroes dead rows'
    routing weights."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    w, idx, aux = route(p, cfg, xt,
                        None if live is None else live.reshape(-1))
    if cfg.use_kernels:
        out = moe_ops.moe_ffn(xt, w, idx, p["wi_gate"], p["wi_up"], p["wo"],
                              act=cfg.act)
    else:
        h = torch.einsum("td,edf->etf", xt, p["wi_gate"])
        h = layers._act(cfg, h) * torch.einsum("td,edf->etf", xt, p["wi_up"])
        y_all = torch.einsum("etf,efd->etd", h, p["wo"])  # (E, T, D)
        one_hot = F.one_hot(idx, cfg.n_experts).to(xt.dtype)  # (T, k, E)
        comb = torch.einsum("tk,tke->te", w.to(xt.dtype), one_hot)
        out = torch.einsum("te,etd->td", comb, y_all)
    out = out.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + layers.apply_mlp(p["shared"], cfg, x)
    return out, aux


def _expert_ffn(cfg: ModelConfig, wg, wu, wo, x):
    """Batched expert FFN: x (E, C, D), weights (E, D, F) / (E, F, D)."""
    h = layers._act(cfg, torch.einsum("ecd,edf->ecf", x, wg))
    h = h * torch.einsum("ecd,edf->ecf", x, wu)
    return torch.einsum("ecf,efd->ecd", h, wo)


# ---------------------------------------------------------------------------
# collectives, with shard_map's gradients
# ---------------------------------------------------------------------------

class _ShardRows(torch.autograd.Function):
    """Enter a sharded region: rows [lo, hi) of a tensor every rank holds
    whole.  Backward: the rank's gradient of its rows placed in zeros of
    the whole shape and summed over ``group`` (the whole mesh), as
    shard_map's transpose sums a replicated input's cotangents."""

    @staticmethod
    def forward(ctx, x, lo, hi, group):
        ctx.shape, ctx.lo, ctx.hi, ctx.group = x.shape, lo, hi, group
        return x[lo:hi]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.lo:ctx.hi] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


class _GatherRows(torch.autograd.Function):
    """Leave a sharded region: every data shard's rows, gathered over
    ``group`` in shard order on every rank.  Backward: the rank's own
    rows of the cotangent (the same on every rank) over ``n_rep``, the
    ranks that computed those rows: shard_map's transpose of an output
    that is replicated over the axes it does not name."""

    @staticmethod
    def forward(ctx, x, group, index, n_rep):
        ctx.group, ctx.index, ctx.n_rep = group, index, n_rep
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        rows = g.shape[0] // dist.get_world_size(ctx.group)
        g = g[ctx.index * rows:(ctx.index + 1) * rows]
        return g / ctx.n_rep, None, None, None


class _SumGrads(torch.autograd.Function):
    """The identity; the gradient summed over ``group``: a weight block
    replicated over the data axes gathers every shard's gradient."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumReplicated(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``; the cotangent, the same on
    every rank, passes through: psum's transpose under shard_map."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal splits along dim 0 over ``group``;
    its transpose is the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# expert-parallel paths
# ---------------------------------------------------------------------------

def _pad_experts(E: int, ep: int) -> int:
    return -(-E // ep) * ep


def _capacity(cfg: ModelConfig, t_loc: int, E_pad: int, *, align: int) -> int:
    """Per-(source rank, expert) buffer slots.  ``moe_dropless`` sizes for
    the worst case (every local assignment on one expert), so nothing
    drops (serving); else the GShard ``capacity_factor`` tradeoff."""
    if cfg.moe_dropless:
        cap = max(t_loc * cfg.top_k, 1)
    else:
        cap = max(int(math.ceil(t_loc * cfg.top_k * cfg.capacity_factor
                                / E_pad)), 4)
    return -(-cap // align) * align


def _layouts(cfg: ModelConfig, flat_tok, slot, keep, n_slots, T, k):
    """The kernel path's routing layouts (None on the plain path)."""
    if not cfg.use_kernels:
        return None
    return routing_layouts(flat_tok, slot, keep, n_slots, T, k=k)


def _expert_major(buf, ep: int, E_loc: int, cap: int):
    """Received buffers (ep sources x E_loc x cap, D) -> (E_loc, ep · cap,
    D): each local expert's rows from every source."""
    D = buf.shape[-1]
    return buf.reshape(ep, E_loc, cap, D).transpose(0, 1).reshape(
        E_loc, ep * cap, D)


def _source_major(y, ep: int, E_loc: int, cap: int):
    """The inverse of ``_expert_major``: (E_loc, ep · cap, D) -> (ep ·
    E_loc · cap, D), each source's block contiguous for the exchange."""
    D = y.shape[-1]
    return y.reshape(E_loc, ep, cap, D).transpose(0, 1).reshape(
        ep * E_loc * cap, D)


def _a2a_dispatch(xt, flat_tok, slot, keep, lay, *, cfg: ModelConfig,
                  group, ep: int, E_loc: int, cap: int):
    """Stage 1: pack the rows into per-(owner, expert, capacity slot)
    buffers and exchange them with their owners."""
    buf = token_dispatch(xt, flat_tok, slot, keep, ep * E_loc * cap,
                         use_kernel=cfg.use_kernels, layouts=lay)
    return _expert_major(_AllToAll.apply(buf, group), ep, E_loc, cap)


def _a2a_ffn(recv, wg, wu, wo, *, cfg: ModelConfig):
    """Stage 2: the owner's experts over their rows (kernel 4 on the
    kernel path)."""
    if cfg.use_kernels:
        return moe_ops.grouped_ffn(recv, wg, wu, wo, act=cfg.act)
    return _expert_ffn(cfg, wg, wu, wo, recv)


def _a2a_combine(y, flat_tok, slot, keep, w, n_tokens, lay, *,
                 cfg: ModelConfig, group, ep: int, E_loc: int, cap: int):
    """Stage 3: the results back to their sources and the weighted unpack
    to rows."""
    back = _AllToAll.apply(_source_major(y, ep, E_loc, cap), group)
    return token_combine(back, flat_tok, slot, keep, w.reshape(-1), n_tokens,
                         use_kernel=cfg.use_kernels, layouts=lay)


def _a2a_local(xt, w, idx, live, wg, wu, wo, *, cfg: ModelConfig, group,
               ep: int, capacity: int):
    """One rank's share: its rows xt (T_loc, D), their weights and
    global expert ids (T_loc, k), liveness (T_loc,) and its experts
    (E_loc, D, F).  Dead rows take no capacity rank on any rank."""
    T = xt.shape[0]
    k = idx.shape[1]
    E_loc, cap = wg.shape[0], capacity
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device=xt.device) // k
    pos, keep = capacity_positions(flat_e, cap,
                                   valid=live.repeat_interleave(k))
    slot = flat_e * cap + pos            # == owner·E_loc·cap + ...
    lay = _layouts(cfg, flat_tok, slot, keep, ep * E_loc * cap, T, k)
    stage = dict(cfg=cfg, group=group, ep=ep, E_loc=E_loc, cap=cap)
    recv = _a2a_dispatch(xt, flat_tok, slot, keep, lay, **stage)
    y = _a2a_ffn(recv, wg, wu, wo, cfg=cfg)        # (E_loc, ep·cap, D)
    out = _a2a_combine(y, flat_tok, slot, keep, w, T, lay, **stage)
    return out.to(xt.dtype)


def _check_mesh(mesh, x) -> None:
    if not hasattr(mesh, "get_group"):
        raise TypeError(f"the expert-parallel paths run over a DeviceMesh "
                        f"(launch/mesh.py), not {type(mesh).__name__}")
    if mesh.device_type != x.device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run "
                         f"{x.device.type} tensors")
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the whole process group")


def _local_experts(p, E_loc: int):
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    if wg.shape[0] != E_loc:
        raise ValueError(f"a rank holds {E_loc} experts on this mesh, got "
                         f"{wg.shape[0]}: cut them with shard_experts")
    return wg, wu, wo


def _shared(p, cfg: ModelConfig, x, out):
    if cfg.n_shared_experts:
        out = out + layers.apply_mlp(p["shared"], cfg, x)
    return out


def moe_a2a(p, cfg: ModelConfig, x, mesh, *, live=None):
    """x: (B, S, D), whole on every rank; ``p`` holds the rank's
    ``E_pad / ep`` experts.  ``live`` (B, S) bool masks dead serving
    rows out of routing weights and out of every rank's capacity
    ranks.  Returns (out (B, S, D), aux), the same on every rank."""
    _check_mesh(mesh, x)
    B, S, D = x.shape
    m = rules.as_abstract(mesh)
    ep = m.shape["model"]
    E_pad = _pad_experts(cfg.n_experts, ep)
    wg, wu, wo = _local_experts(p, E_pad // ep)
    xt = x.reshape(-1, D)
    T = B * S
    live_t = (torch.ones((T,), dtype=torch.bool, device=x.device)
              if live is None else live.reshape(-1))
    w, idx, aux = route(p, cfg, xt, None if live is None else live_t)
    daxes = rules.data_axes_of(m)
    if daxes not in ((), ("data",)):
        raise NotImplementedError(f"data axes {daxes}: the multi-pod mesh "
                                  "is not ported yet")
    n_data = m.shape.get("data", 1)
    if T % n_data:
        n_data = 1      # tiny decode batches replicate their rows
    t_loc = T // n_data
    cap = _capacity(cfg, t_loc, E_pad, align=8)
    coord = rules.coordinate(mesh)
    d = coord["data"] if n_data > 1 else 0
    lo, hi = d * t_loc, (d + 1) * t_loc
    world = dist.group.WORLD
    data = mesh.get_group("data") if "data" in m.shape else None
    if data is not None:
        wg, wu, wo = (_SumGrads.apply(t, data) for t in (wg, wu, wo))
    out = _a2a_local(_ShardRows.apply(xt, lo, hi, world),
                     _ShardRows.apply(w, lo, hi, world), idx[lo:hi],
                     live_t[lo:hi], wg, wu, wo, cfg=cfg,
                     group=mesh.get_group("model"), ep=ep, capacity=cap)
    if n_data > 1:
        out = _GatherRows.apply(out, data, d, m.size // n_data)
    else:
        # every rank computed every row: each passes 1/size of the
        # cotangent back
        out = _Scale.apply(out, 1.0 / m.size)
    return _shared(p, cfg, x, out.reshape(B, S, D)), aux


class _Scale(torch.autograd.Function):
    """The identity; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _local_mask(flat_e, E_loc: int, dev: int):
    """The assignments to this rank's experts."""
    return (flat_e // E_loc) == dev


def _replicated_ep_local(xt, w, idx, live, wg, wu, wo, *, cfg: ModelConfig,
                         dev: int, capacity: int):
    """Serving-layout expert parallelism on one rank: every row, the
    assignments to this rank's experts kept (and fitting their
    capacity), its partial output; the caller sums over the mesh."""
    T, D = xt.shape
    k = idx.shape[1]
    E_loc, cap = wg.shape[0], capacity
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device=xt.device) // k
    pos, fits = capacity_positions(flat_e, cap,
                                   valid=live.repeat_interleave(k))
    local = _local_mask(flat_e, E_loc, dev)
    keep = local & fits
    slot = torch.where(local, flat_e % E_loc, 0) * cap + pos
    lay = _layouts(cfg, flat_tok, slot, keep, E_loc * cap, T, k)
    buf = token_dispatch(xt, flat_tok, slot, keep, E_loc * cap,
                         use_kernel=cfg.use_kernels, layouts=lay)
    y = _a2a_ffn(buf.reshape(E_loc, cap, D), wg, wu, wo, cfg=cfg)
    out = token_combine(y.reshape(E_loc * cap, D), flat_tok, slot, keep,
                        w.reshape(-1), T, use_kernel=cfg.use_kernels,
                        layouts=lay)
    return out.to(xt.dtype)


def _rank_index(mesh) -> int:
    """This rank's index over every mesh axis, the first major (the
    reference's ``axis_index`` over all axes)."""
    m, coord = rules.as_abstract(mesh), rules.coordinate(mesh)
    idx = 0
    for a in m.axis_names:
        idx = idx * m.shape[a] + coord[a]
    return idx


def moe_replicated_ep(p, cfg: ModelConfig, x, mesh, live=None):
    """Decode-path MoE over the whole mesh: see ``_replicated_ep_local``.
    ``p`` holds the rank's ``E_pad / mesh.size`` experts."""
    _check_mesh(mesh, x)
    B, S, D = x.shape
    n_dev = mesh.size()
    E_pad = _pad_experts(cfg.n_experts, n_dev)
    wg, wu, wo = _local_experts(p, E_pad // n_dev)
    xt = x.reshape(-1, D)
    T = B * S
    live_t = (torch.ones((T,), dtype=torch.bool, device=x.device)
              if live is None else live.reshape(-1))
    w, idx, aux = route(p, cfg, xt, None if live is None else live_t)
    if cfg.moe_dropless:
        cap = _capacity(cfg, T, E_pad, align=4)
    else:
        cap = max(int(math.ceil(T * cfg.top_k * cfg.capacity_factor
                                / E_pad)), 4)
        cap = min(-(-cap // 4) * 4, max(T, 4))
    world = dist.group.WORLD
    out = _replicated_ep_local(_ShardRows.apply(xt, 0, T, world),
                               _ShardRows.apply(w, 0, T, world), idx,
                               live_t, wg, wu, wo, cfg=cfg,
                               dev=_rank_index(mesh), capacity=cap)
    out = _SumReplicated.apply(out, world)
    return _shared(p, cfg, x, out.reshape(B, S, D)), aux


def moe_path(cfg: ModelConfig, mesh) -> str:
    """The path ``apply_moe`` takes: ``cfg.moe_impl``, where "auto" is
    "a2a" on a mesh with a "model" axis of more than one rank in all,
    else "dense"."""
    impl = cfg.moe_impl
    if impl == "auto":
        ok = (mesh is not None and "model" in rules.as_abstract(mesh).shape
              and rules.as_abstract(mesh).size > 1)
        impl = "a2a" if ok else "dense"
    if impl in ("a2a", "replicated_ep") and mesh is None:
        raise ValueError(f"moe_impl={impl!r} runs over a mesh; got none")
    return impl


def shard_experts(params, cfg: ModelConfig, mesh):
    """This rank's parameters for ``moe_path(cfg, mesh)``: every routed
    expert stack (``.../moe/wi_gate``, ``wi_up``, ``wo``) padded with
    zero experts to ``E_pad`` and cut to the rank's block by
    ``rules.param_specs`` (a2a: the expert dim over "model"; replicated_ep:
    ``ep_all``, over the whole mesh), as a copy so that the whole stack can
    be freed (a path of one rank keeps the caller's tensor); every other
    leaf is the caller's tensor.  The dense path keeps every expert."""
    impl = moe_path(cfg, mesh)
    if impl == "dense" or not cfg.is_moe:
        return params
    m = rules.as_abstract(mesh)
    ep = m.size if impl == "replicated_ep" else m.shape["model"]
    E_pad = _pad_experts(cfg.n_experts, ep)

    def pad(leaf):
        e_dim = leaf.ndim - 3
        extra = list(leaf.shape)
        extra[e_dim] = E_pad - leaf.shape[e_dim]
        if extra[e_dim] == 0:
            return leaf
        return torch.cat([leaf, leaf.new_zeros(extra)], e_dim)

    coord = rules.coordinate(mesh)

    def cut(path, leaf):
        if not _is_stack(path, leaf):
            return leaf
        if leaf.shape[leaf.ndim - 3] not in (cfg.n_experts, E_pad):
            raise ValueError(f"{path}: {leaf.shape[leaf.ndim - 3]} experts, "
                             f"the config has {cfg.n_experts} (already cut?)")
        leaf = pad(leaf)
        spec = rules.leaf_spec(path, leaf, m, fsdp=False,
                               ep_all=impl == "replicated_ep")
        part = rules.block(leaf, spec, m, coord)
        return leaf if part.shape == leaf.shape else part.clone()

    return rules.map_with_paths(cut, params)


def _is_stack(path: str, leaf) -> bool:
    """A routed expert stack (..., E, D, F) or its moment of that shape;
    a frozen leaf's 0-d moment is no stack."""
    return bool(re.search(rules.EXPERT_LEAF, path)) and leaf.ndim >= 3


def _expert_group(cfg: ModelConfig, mesh):
    """The process group an expert stack is cut over on ``mesh``, or None
    when ``moe_path`` keeps every expert (a2a: the rank's "model" group,
    whose ranks hold the other blocks in block order; replicated_ep: the
    whole mesh)."""
    if mesh is None or not cfg.is_moe:
        return None
    impl = moe_path(cfg, mesh)
    if impl == "dense":
        return None
    return (dist.group.WORLD if impl == "replicated_ep"
            else mesh.get_group("model"))


def gather_experts(params, cfg: ModelConfig, mesh):
    """The inverse of ``shard_experts``: every rank's block of each routed
    expert stack gathered over the ranks that hold the others, in block
    order, and the zero padding cut off, so that every rank holds the
    whole (..., E, D, F) stacks again.  Other leaves, and every leaf on
    a path that keeps all experts, are returned as they are."""
    group = _expert_group(cfg, mesh)
    if group is None:
        return params

    def whole(path, leaf):
        if not _is_stack(path, leaf):
            return leaf
        e_dim = leaf.ndim - 3
        n = dist.get_world_size(group)
        if n > 1:
            parts = [torch.empty_like(leaf) for _ in range(n)]
            dist.all_gather(parts, leaf.contiguous(), group=group)
            leaf = torch.cat(parts, e_dim)
        return leaf.narrow(e_dim, 0, cfg.n_experts)

    return rules.map_with_paths(whole, params)


def shard_opt_state(state, cfg: ModelConfig, mesh):
    """AdamW state (``optim/adamw.py``) for ``shard_experts``' params: the
    moments of each expert stack cut to the rank's block as the stack is
    (a frozen stack's 0-d moments stay as they are), under every moment
    policy; ``step`` and int8 ``v``'s per-tensor ``v_scale`` (the whole
    tensor's scale) are kept."""
    out = dict(state)
    for k in ("m", "v"):
        out[k] = shard_experts(state[k], cfg, mesh)
    return out


def clip_shards(params, cfg: ModelConfig, mesh):
    """``adamw_update``'s ``shards`` for ``params`` on ``mesh``: (a tree
    True at the expert stacks, their process group), or None where every
    rank holds every expert (the norm then needs no sum over ranks)."""
    group = _expert_group(cfg, mesh)
    if group is None:
        return None
    return rules.map_with_paths(_is_stack, params), group


def apply_moe(p, cfg: ModelConfig, x, mesh=None, live=None):
    """The MoE path of one sub-layer (``moe_path``): ``moe_dense``,
    ``moe_a2a`` or ``moe_replicated_ep``.  ``live`` (B, S) bool is the
    serving mask (None: every row live)."""
    impl = moe_path(cfg, mesh)
    if impl == "replicated_ep":
        return moe_replicated_ep(p, cfg, x, mesh, live)
    if impl == "a2a":
        return moe_a2a(p, cfg, x, mesh, live=live)
    return moe_dense(p, cfg, x, live)
