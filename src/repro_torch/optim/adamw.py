"""AdamW with parameter-freezing masks, fp32 moment policy.

Copies the math of ``repro.optim.adamw`` (not ``torch.optim.AdamW``):
b2 = 0.95, ``eps`` added outside ``sqrt(vhat)``, a global-norm clip at
1.0 on the f32 norm of *all* leaves (frozen ones included), the clipped
gradient cast back to its parameter's dtype before the moments see it,
bias correction from the incremented step, the new parameter computed
in f32 and cast to the parameter's dtype.  Frozen leaves (``False`` in
the mask) keep scalar zero moments, as in the reference.

Moments are f32.  The reference's bf16/int8 moment policies
(``models/quant.py::MomentPolicy``) are not ported yet and raise.
Where the reference returns new trees, the port updates the parameter
and moment tensors in place, under ``torch.no_grad()``, to hold one copy
of each: a 1.1B model's f32 moments alone are 8.8 GB.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


def adamw_init(params, *, freeze_mask=None, policy=None):
    """freeze_mask: nested dict of bools matching params (True =
    trainable).  Returns {"m", "v" (f32 trees), "step" (an int)}."""
    if policy not in (None, ""):
        raise NotImplementedError(
            f"AdamW moment policy {policy!r} is not ported yet (fp32 only)")
    if freeze_mask is None:
        freeze_mask = tree_map(lambda _: True, params)

    def mom(p, trainable):
        shape = p.shape if trainable else ()
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(mom, params, freeze_mask),
            "v": tree_map(mom, params, freeze_mask),
            "step": 0}


_CHUNK = 1 << 26  # elements per f32 temporary of the norm


def _sq_sum(g):
    """Σ g² in f32.  A leaf larger than ``_CHUNK`` elements (an expert
    bank's gradient) is summed chunk by chunk, so its f32 temporaries
    stay small."""
    if g.numel() <= _CHUNK:
        return torch.sum(torch.square(g.float()))
    return sum(torch.sum(torch.square(c.float()))
               for c in g.reshape(-1).split(_CHUNK))


def _clip_scale(grads, max_norm: float):
    """(min(1, max_norm / ||grads||), ||grads||), the norm in f32 over
    all leaves, both 0-d tensors on the device (no host sync)."""
    gnorm = torch.sqrt(sum(_sq_sum(g) for g in tree_leaves(grads)))
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
                 clip_norm: float = 1.0):
    """One AdamW step, in place on ``params`` and ``state``.  Returns
    (params, state, {"grad_norm": 0-d tensor})."""
    if freeze_mask is None:
        freeze_mask = tree_map(lambda _: True, params)
    step = state["step"] + 1
    scale = None
    if clip_norm:
        # the norm covers every leaf; only trainable gradients are scaled
        # (a frozen expert bank's clipped copy would go unused)
        scale, gnorm = _clip_scale(grads, clip_norm)
    else:
        gnorm = torch.zeros((), dtype=torch.float32)
    # the reference forms the bias corrections in f32
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(step))
    c2 = float(f32(1.0) - f32(b2) ** f32(step))
    lr = float(f32(lr))

    def upd(p, g, m, v, trainable):
        if not trainable:
            return
        if scale is not None:
            g = (g * scale).to(g.dtype)
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * torch.square(gf)
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    for p, g, m, v, t in zip(tree_leaves(params), tree_leaves(grads),
                             tree_leaves(state["m"]), tree_leaves(state["v"]),
                             tree_leaves(freeze_mask)):
        upd(p, g, m, v, t)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
