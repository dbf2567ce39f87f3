"""AdamW with parameter-freezing masks and moment policies.

Copies the math of ``repro.optim.adamw`` (not ``torch.optim.AdamW``):
b2 = 0.95, ``eps`` added outside ``sqrt(vhat)``, a global-norm clip at
1.0 on the f32 norm of *all* leaves (frozen ones included), the clipped
gradient cast back to its parameter's dtype before the moments see it,
bias correction from the incremented step, the new parameter computed
in f32 and cast to the parameter's dtype.  Frozen leaves (``False`` in
the mask) keep scalar zero moments, as in the reference.

Moment storage follows a ``quant.MomentPolicy`` (``resolve_moment_policy``):
f32 moments by default, bf16 ``m`` and ``v`` under ``"bf16"``, bf16 ``m``
and int8 ``v`` with a ``"v_scale"`` tree of 0-d f32 scales under
``"int8"``.  As in the reference the structure carries the policy: a
state with ``"v_scale"`` is dequantized to f32, updated in f32 and
re-quantized.  Where the reference returns new trees, the port updates
the parameter and moment tensors in place, under ``torch.no_grad()``, to
hold one copy of each (a 1.1B model's f32 moments alone are 8.8 GB), and
makes the f32 temporaries of one leaf at a time.

On a mesh the reference's arrays are global, so its norm sees every
expert once.  A rank of the port holds a block of each expert stack
(``models/moe.py::shard_experts``) and the whole of every other leaf,
with the same gradient on every rank.  ``shards=(mask, group)`` says
so: the leaves True in ``mask`` are this rank's blocks of tensors cut
over the process group ``group``, their Σg² is summed over it before
it joins the norm (the other leaves count once, on every rank alike),
and an int8 ``v`` of such a leaf is quantized with the group's largest
value, the global tensor's scale.  ``moe.clip_shards`` builds it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import quant
from repro_torch.utils.pytree import tree_leaves, tree_map


def resolve_moment_policy(policy) -> quant.MomentPolicy:
    """A ``MomentPolicy``, a shorthand string, or None.  Shorthands:
    ``""`` (f32 moments), ``"bf16"`` (both moments bf16), ``"int8"`` (m
    bf16, v int8 + per-tensor scale)."""
    if policy is None or policy == "":
        return quant.MomentPolicy()
    if isinstance(policy, quant.MomentPolicy):
        return policy
    if policy == "bf16":
        return quant.MomentPolicy("bf16", "bf16")
    if policy == "int8":
        return quant.MomentPolicy("bf16", "int8")
    raise ValueError(f"unknown moment policy {policy!r} "
                     "(expected '', 'bf16', 'int8', or a MomentPolicy)")


def adamw_init(params, *, freeze_mask=None, policy=None):
    """freeze_mask: nested dict of bools matching params (True =
    trainable).  Returns {"m", "v", "step" (an int)} with the moments at
    the policy's storage dtypes, and a ``"v_scale"`` tree of 0-d f32
    zeros (one a parameter, frozen ones included) under int8 ``v``."""
    pol = resolve_moment_policy(policy)
    if freeze_mask is None:
        freeze_mask = tree_map(lambda _: True, params)

    def mom(dtype):
        def init(p, trainable):
            shape = p.shape if trainable else ()
            return torch.zeros(shape, dtype=dtype, device=p.device)
        return init

    state = {"m": tree_map(mom(pol.m_storage()), params, freeze_mask),
             "v": tree_map(mom(pol.v_storage()), params, freeze_mask),
             "step": 0}
    if pol.v_quantized:
        state["v_scale"] = tree_map(
            lambda p: torch.zeros((), dtype=torch.float32, device=p.device),
            params)
    return state


_CHUNK = 1 << 26  # elements per f32 temporary of the norm


def _sq_sum(g):
    """Σ g² in f32.  A leaf larger than ``_CHUNK`` elements (an expert
    bank's gradient) is summed chunk by chunk, so its f32 temporaries
    stay small."""
    if g.numel() <= _CHUNK:
        return torch.sum(torch.square(g.float()))
    return sum(torch.sum(torch.square(c.float()))
               for c in g.reshape(-1).split(_CHUNK))


def _clip_scale(grads, max_norm: float, shards=None):
    """(min(1, max_norm / ||grads||), ||grads||), the norm in f32 over
    all leaves (``shards``: see the module docstring), summed in leaf
    order, both 0-d tensors on the device (no host sync)."""
    sq = [_sq_sum(g) for g in tree_leaves(grads)]
    if shards is not None:
        mask, group = shards
        cut = [i for i, m in enumerate(tree_leaves(mask)) if m]
        if cut:
            part = torch.stack([sq[i] for i in cut])
            dist.all_reduce(part, group=group)
            for j, i in enumerate(cut):
                sq[i] = part[j]
    gnorm = torch.sqrt(sum(sq))
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0), gnorm


def global_norm_clip(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / ||grads||), the norm in
    f32 over all leaves.  Returns (clipped tree, norm as a 0-d tensor);
    the scale stays on the device, so clipping costs no host sync."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0, freeze_mask=None,
                 clip_norm: float = 1.0, shards=None):
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, {"grad_norm": 0-d tensor}).  Moments are read in
    f32 (an int8 ``v`` dequantized with its scale), updated in f32 and
    stored back at their own dtype (int8 ``v`` re-quantized).
    ``shards=(mask, group)``: the leaves cut over ranks (module
    docstring); None on one device."""
    if freeze_mask is None:
        freeze_mask = tree_map(lambda _: True, params)
    v_quantized = "v_scale" in state
    step = state["step"] + 1
    scale = None
    if clip_norm:
        # the norm covers every leaf; only trainable gradients are scaled
        # (a frozen expert bank's clipped copy would go unused)
        scale, gnorm = _clip_scale(grads, clip_norm, shards)
    else:
        gnorm = torch.zeros((), dtype=torch.float32)
    # the reference forms the bias corrections in f32
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(step))
    c2 = float(f32(1.0) - f32(b2) ** f32(step))
    lr = float(f32(lr))

    def upd(p, g, m, v, vs, trainable, cut):
        if not trainable:
            return
        if scale is not None:
            g = (g * scale).to(g.dtype)
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        vf = quant.dequantize_v(v, vs) if v_quantized else v.float()
        v_new = b2 * vf + (1 - b2) * torch.square(gf)
        del vf
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        if v_quantized:
            # a block of a cut leaf takes the whole tensor's scale
            q, s = quant.quantize_v(v_new,
                                    group=shards[1] if cut else None)
            v.copy_(q)
            vs.copy_(s)
        else:
            v.copy_(v_new)

    n = len(tree_leaves(params))
    vscales = tree_leaves(state["v_scale"]) if v_quantized else [None] * n
    cuts = tree_leaves(shards[0]) if shards is not None else [False] * n
    for p, g, m, v, vs, t, c in zip(tree_leaves(params), tree_leaves(grads),
                                    tree_leaves(state["m"]),
                                    tree_leaves(state["v"]), vscales,
                                    tree_leaves(freeze_mask), cuts):
        upd(p, g, m, v, vs, t, c)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
