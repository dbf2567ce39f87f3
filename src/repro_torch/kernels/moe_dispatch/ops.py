"""MoE dispatch/combine: routing layout, capacity accounting, drop
semantics, and the fused token movement with its gradient.

Counterpart of ``repro.kernels.moe_dispatch.ops``.  ``capacity_positions``
ranks each (token, expert) assignment within its expert;
``token_dispatch`` / ``token_combine`` move rows between the flat token
array and flat capacity slots.  Both movements are one primitive,

    out[dst_rows[i]] += scale[i] * src[src_rows[i]]      i = 0..R-1

which replaces the Pallas TPU kernel ``gather_scatter_add_rows``
(``repro/kernels/moe_dispatch/kernel.py``, ``_gsa_kernel``).  The CUDA
source is ``csrc/moe_dispatch.cu``.  A CPU tensor runs the plain
version in ``ref.py``; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches.

The kernel is deterministic and adds in the TPU kernel's order: the
wrapper sorts the row ids stably by destination (index bookkeeping, as
``capacity_positions``' argsort), and one block per output row sums its
segment in the original row order in f32.  The reference's
``fits_vmem`` budget (a TPU VMEM limit that sends large movements to the
XLA scatter-add) has no counterpart: on the card every movement takes
the kernel.

``gather_scatter_add`` is a ``torch.autograd.Function``: its backward is
the same movement with source and destination swapped (the transpose of
a scatter-add), plus the gradient of ``scale`` as a plain row dot, as
``_gsa_bwd`` in the reference.  ``use_kernel=False`` selects the plain
scatter-add of the reference's non-Pallas path (natively
differentiable); both share the index and mask computation, so every
path agrees on which tokens drop.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch.ref import gather_scatter_add_ref

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("moe_dispatch")
        fn = lib.gather_scatter_add
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.moe_dispatch_error_string.argtypes = [ctypes.c_int]
        lib.moe_dispatch_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.moe_dispatch_error_string)
    return _fn


def capacity_positions(flat_e, cap: int, valid=None):
    """Rank of each assignment within its expert + keep mask.

    flat_e: (N,) expert ids.  Returns (pos (N,) int32, keep (N,) bool)
    where ``pos`` is the arrival rank among equal expert ids (stable in
    token order — GShard drop semantics) and ``keep = pos < cap``.
    ``valid`` (N,) bool ranks invalid assignments in a sentinel bucket
    past every real expert id, so they take no capacity, and drops them.
    """
    n = flat_e.shape[0]
    key = flat_e.to(torch.int32)
    if valid is not None:
        key = torch.where(valid, key, torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    pos_sorted = (torch.arange(n, device=key.device)
                  - torch.searchsorted(sorted_e, sorted_e, side="left"))
    pos = torch.zeros((n,), dtype=torch.int32, device=key.device)
    pos[order] = pos_sorted.to(torch.int32)
    keep = pos < cap
    if valid is not None:
        keep = keep & valid
    return pos, keep


def gather_scatter_add_rows(src, src_rows, dst_rows, scale, n_out: int):
    """src (Ns, D); src_rows, dst_rows, scale (R,) -> (n_out, D) in
    ``src.dtype``, accumulated in f32.  Rows with ``scale == 0`` still
    move and add nothing (the reference's dropped assignments)."""
    global LAUNCHES
    R = src_rows.shape[0]
    if src.dim() != 2 or src_rows.dim() != 1 or dst_rows.shape != (R,) \
            or scale.shape != (R,):
        raise ValueError(f"expected src (Ns, D) and (R,) rows and scale, got "
                         f"{tuple(src.shape)}, {tuple(src_rows.shape)}, "
                         f"{tuple(dst_rows.shape)}, {tuple(scale.shape)}")
    if src_rows.is_floating_point() or dst_rows.is_floating_point():
        raise TypeError("row ids must be integers")
    if len({t.device for t in (src, src_rows, dst_rows, scale)}) != 1:
        raise ValueError("all inputs must lie on one device")
    if src.device.type == "cpu":
        return gather_scatter_add_ref(src, src_rows, dst_rows, scale, n_out)
    if src.device.type != "cuda":
        raise ValueError(f"gather_scatter_add: unsupported device "
                         f"{src.device}")
    if src.dtype not in _DTYPES:
        raise TypeError(f"gather_scatter_add: dtype {src.dtype} not in "
                        f"{list(_DTYPES)}")
    Ns, D = src.shape
    if max(R, Ns, n_out, D) >= 2 ** 31:
        raise ValueError("gather_scatter_add: sizes must fit in int32")
    # out-of-range ids are a caller bug: a device-side assert, no sync
    torch._assert_async(((src_rows >= 0) & (src_rows < Ns)).all())
    torch._assert_async(((dst_rows >= 0) & (dst_rows < n_out)).all())
    out = torch.empty((n_out, D), dtype=src.dtype, device=src.device)
    if n_out == 0 or D == 0:
        return out
    src = src.contiguous()
    order = torch.argsort(dst_rows, stable=True)
    seg = torch.searchsorted(
        dst_rows[order].contiguous(),
        torch.arange(n_out + 1, device=src.device, dtype=dst_rows.dtype),
        side="left").to(torch.int32)
    rows = src_rows[order].to(torch.int32).contiguous()
    scl = scale.float()[order].contiguous()
    fn, err_str = _kernel()
    err = fn(src.data_ptr(), _DTYPES[src.dtype], rows.data_ptr(),
             scl.data_ptr(), seg.data_ptr(), out.data_ptr(), n_out, D,
             torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "gather_scatter_add", err_str)
    LAUNCHES += 1
    return out


class _GSA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, scale, src_rows, dst_rows, n_out):
        ctx.save_for_backward(src, scale, src_rows, dst_rows)
        return gather_scatter_add_rows(src, src_rows, dst_rows, scale, n_out)

    @staticmethod
    def backward(ctx, dout):
        src, scale, src_rows, dst_rows = ctx.saved_tensors
        doutf = dout.float()
        dsrc = dscale = None
        if ctx.needs_input_grad[0]:
            # the transpose of a scatter-add is the same movement, reversed
            dsrc = gather_scatter_add_rows(doutf, dst_rows, src_rows, scale,
                                           src.shape[0]).to(src.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (src[src_rows.long()].float()
                      * doutf[dst_rows.long()]).sum(-1).to(scale.dtype)
        return dsrc, dscale, None, None, None


def gather_scatter_add(src, scale, src_rows, dst_rows, n_out: int):
    """Trainable ``gather_scatter_add_rows`` (gradients for ``src`` and
    ``scale``)."""
    return _GSA.apply(src, scale, src_rows, dst_rows, n_out)


def token_dispatch(xt, flat_tok, slot, keep, n_slots: int, *,
                   use_kernel: bool = True):
    """Pack tokens into flat capacity slots: out (n_slots, D) with
    ``out[slot[i]] += xt[flat_tok[i]]`` for kept assignments (dropped
    ones move to slot 0 with scale 0)."""
    scale = keep.float()
    dst = torch.where(keep, slot, torch.zeros_like(slot))
    if use_kernel:
        return gather_scatter_add(xt, scale, flat_tok, dst, n_slots)
    out = torch.zeros((n_slots, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    return out.index_add(0, dst.long(),
                         scale[:, None].to(xt.dtype) * xt[flat_tok.long()])


def token_combine(y2d, flat_tok, slot, keep, weights, n_tokens: int, *,
                  use_kernel: bool = True):
    """Unpack expert outputs back to tokens, applying routing weights:
    out (n_tokens, D) with ``out[flat_tok[i]] += w[i] * y2d[slot[i]]``
    for kept assignments (dropped assignments contribute zero)."""
    scale = torch.where(keep, weights, torch.zeros_like(weights))
    srcr = torch.where(keep, slot, torch.zeros_like(slot))
    if use_kernel:
        return gather_scatter_add(y2d, scale, srcr, flat_tok, n_tokens)
    gathered = torch.where(keep[:, None], y2d[srcr.long()],
                           torch.zeros((), dtype=y2d.dtype,
                                       device=y2d.device))
    out = torch.zeros((n_tokens, y2d.shape[1]), dtype=y2d.dtype,
                      device=y2d.device)
    return out.index_add(0, flat_tok.long(),
                         gathered * scale[:, None].to(y2d.dtype))
