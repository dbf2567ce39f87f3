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
``LAUNCHES`` counts kernel launches (one a call), ``LAUNCHES_BY_INSTANCE``
the same launches by the instance they took (``instance``).

The kernel is deterministic and adds in the TPU kernel's order: the
entries are grouped stably by destination (a ``RowLayout``: segment
offsets into a stable order, index bookkeeping as ``capacity_positions``'
argsort) and each output row sums its segment in the original row order
in f32.  A routed layer's four movements use two layouts, built once a
routing by ``routing_layouts``: by slot (dispatch forward, combine
backward) and by token (combine forward, dispatch backward).  The
reference's ``fits_vmem`` budget (a TPU VMEM limit that sends large
movements to the XLA scatter-add) has no counterpart: on the card every
movement takes the kernel.

``gather_scatter_add`` is a ``torch.autograd.Function``: its backward is
the same movement with source and destination swapped (the transpose of
a scatter-add), reading ``dout`` in its own dtype (the forward output's,
which is the source's) and writing ``dsrc`` in it, and, where ``scale``
needs a gradient, the same launch computes it as a row dot (``_gsa_bwd``
in the reference) in a fixed order: lane partials, then a shuffle tree
(``dscale_in_kernel_order``).
``use_kernel=False`` selects the plain scatter-add of the reference's
non-Pallas path (natively differentiable); every path shares the index
and mask computation, so they agree on which tokens drop.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch.ref import gather_scatter_add_ref

LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {"vec": 0, "general": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/moe_dispatch.cu: segments longer than LONG walk their zero-scale
# entries apart, in units of PIECE entries
LONG, PIECE = 64, 32
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("moe_dispatch")
        p, i = ctypes.c_void_p, ctypes.c_int
        general = lib.gather_scatter_add_general
        general.argtypes = [p, i, p, p, p, p, p, i, i, p, p, p]
        general.restype = i
        vec = lib.gather_scatter_add_vec
        vec.argtypes = [p, i, p, p, p, p, p, p, p, p, i, p, p, i, i, i, p]
        vec.restype = i
        lib.moe_dispatch_error_string.argtypes = [i]
        lib.moe_dispatch_error_string.restype = ctypes.c_char_p
        _fn = (general, vec, lib.moe_dispatch_error_string)
    return _fn


def chunk_columns(dtype) -> int:
    """Columns of one 16-byte access of the ``vec`` instance: 8 bf16 or 4
    f32."""
    return 16 // dtype.itemsize


def pass_columns(dtype) -> int:
    """Columns a lane's eight 16-byte chunks cover in one pass of the
    ``vec`` instance, a warp's 32 lanes together."""
    return 32 * 8 * chunk_columns(dtype)


def instance(src, dot_src=None) -> str:
    """The instance a CUDA launch on these tensors takes: ``vec`` (16-byte
    accesses) where a row of ``src`` is whole 16-byte chunks (D a multiple
    of 8 in bf16, of 4 in f32) and ``src`` and ``dot_src`` start 16-byte
    aligned; else ``general``.  Decided from dtypes, shapes and pointers,
    before the launch."""
    D = src.shape[-1]
    ok = (src.dtype in _DTYPES and D % chunk_columns(src.dtype) == 0
          and src.data_ptr() % 16 == 0
          and (dot_src is None or dot_src.data_ptr() % 16 == 0))
    return "vec" if ok else "general"


class RowLayout:
    """R entries grouped by their destination row.

    ``ids`` (R,) int32: each entry's destination in ``[0, n)``, original
    order.  ``seg`` (n + 1,) int32: row r's entries sit at sorted
    positions ``seg[r] .. seg[r+1]``.  ``order`` (R,) int32: the entry at
    each sorted position (stable: equal destinations in original order),
    or None where that is the identity.  ``sorted_ids`` (R,) int32: the
    destination at each sorted position, or None where no row is split
    (the identity layout: k entries a row, walked in order whatever k).
    Built on the entries' device; the range check runs once, when the
    layout is built.
    """

    def __init__(self, ids, n, seg, order, sorted_ids):
        self.ids, self.n = ids, n
        self.seg, self.order, self.sorted_ids = seg, order, sorted_ids
        self._scratch = {}

    @classmethod
    def by_sort(cls, rows, n: int) -> "RowLayout":
        """Any destinations: a stable argsort and a searchsorted."""
        ids = _ids(rows, n)
        order = torch.argsort(ids, stable=True)
        sorted_ids = ids[order]
        seg = torch.searchsorted(
            sorted_ids, torch.arange(n + 1, device=ids.device,
                                     dtype=torch.int32), side="left")
        return cls(ids, n, seg.to(torch.int32), order.to(torch.int32),
                   sorted_ids)

    @classmethod
    def by_blocks(cls, rows, n: int, k: int) -> "RowLayout":
        """Destinations ``arange(n * k) // k`` (already sorted, k entries
        a row): the identity order and offsets ``k * r``, no sort.  The
        premise is asserted on the device."""
        ids = _ids(rows, n)
        if ids.shape[0] != n * k:
            raise ValueError(f"by_blocks: {ids.shape[0]} entries, expected "
                             f"{n} x {k}")
        ar = torch.arange(n * k, device=ids.device, dtype=torch.int32)
        torch._assert_async((ids == ar // k).all())
        seg = torch.arange(n + 1, device=ids.device, dtype=torch.int32) * k
        return cls(ids, n, seg, None, None)

    def scratch(self, D: int):
        """The ``vec`` instance's scratch for long segments at row length
        D: the owners' f32 sums and the zeroed non-finite bitmaps with
        their tickets, which each launch leaves at zero.  None where no
        row is split.  Allocated once per layout and D."""
        if self.sorted_ids is None:
            return None
        if D not in self._scratch:
            units = -(-self.ids.shape[0] // PIECE)
            # a 64-bit mask a lane a pass (a pass is at least 1024
            # columns), then the ticket
            stride = 32 * -(-D // 1024) + 1
            dev = self.ids.device
            self._scratch[D] = (
                torch.empty((units, D), dtype=torch.float32, device=dev),
                torch.zeros((units, stride), dtype=torch.int64, device=dev),
                stride)
        return self._scratch[D]


def _ids(rows, n: int):
    """rows as int32, each in [0, n) (checked on the device, no sync)."""
    if rows.dim() != 1 or rows.is_floating_point():
        raise TypeError(f"row ids must be a 1-d integer tensor, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if max(rows.shape[0], n) >= 2 ** 31:
        raise ValueError("gather_scatter_add: sizes must fit in int32")
    if rows.device.type == "cuda":
        # out-of-range ids are a caller bug: a device-side assert, no sync
        torch._assert_async(((rows >= 0) & (rows < n)).all())
    return rows.to(torch.int32).contiguous()


def routing_layouts(flat_tok, slot, keep, n_slots: int, n_tokens: int, *,
                    k: int | None = None):
    """The two layouts a routed layer's four movements share: by slot
    (destination ``where(keep, slot, 0)``: dispatch forward, combine
    backward) and by token (``flat_tok``: combine forward, dispatch
    backward).  ``k``: ``flat_tok`` is ``arange(n_tokens * k) // k``, as
    ``moe_ffn`` builds it, and its layout needs no sort."""
    dst = torch.where(keep, slot, torch.zeros_like(slot))
    by_slot = RowLayout.by_sort(dst, n_slots)
    by_token = (RowLayout.by_sort(flat_tok, n_tokens) if k is None
                else RowLayout.by_blocks(flat_tok, n_tokens, k))
    return by_slot, by_token


def _plain(src, src_ids, dst_ids, scale, n_out, dot_src):
    """The plain versions of a movement and its dot, for CPU tensors."""
    out = gather_scatter_add_ref(src, src_ids, dst_ids, scale, n_out)
    if dot_src is None:
        return out, None
    return out, (dot_src[dst_ids.long()].float()
                 * src[src_ids.long()].float()).sum(-1)


def _move(src, scale, src_ids, dst: RowLayout, *, dot_src=None):
    """out (dst.n, D) in src's dtype with out[dst.ids[i]] += scale[i] *
    src[src_ids[i]] summed in f32, and with ``dot_src`` (dst.n, D) also
    dscale[i] = dot(dot_src[dst.ids[i]], src[src_ids[i]]) in f32 (else
    None).  One kernel launch on the card; the plain versions for CPU
    tensors."""
    global LAUNCHES
    if src.device.type == "cpu":
        return _plain(src, src_ids, dst.ids, scale, dst.n, dot_src)
    if src.device.type != "cuda":
        raise ValueError(f"gather_scatter_add: unsupported device "
                         f"{src.device}")
    if src.dtype not in _DTYPES:
        raise TypeError(f"gather_scatter_add: dtype {src.dtype} not in "
                        f"{list(_DTYPES)}")
    if dot_src is not None and (dot_src.dtype != src.dtype
                                or dot_src.shape != (dst.n, src.shape[1])):
        raise ValueError(f"dot_src must be ({dst.n}, {src.shape[1]}) in "
                         f"{src.dtype}, got {dot_src.dtype} "
                         f"{tuple(dot_src.shape)}")
    R, D, n_out = src_ids.shape[0], src.shape[1], dst.n
    out = torch.empty((n_out, D), dtype=src.dtype, device=src.device)
    dscale = None if dot_src is None else torch.empty(
        (R,), dtype=torch.float32, device=src.device)
    if n_out == 0 or D == 0:
        if dscale is not None:
            dscale.zero_()
        return out, dscale
    src = src.contiguous()
    dot_src = None if dot_src is None else dot_src.contiguous()
    scl = scale.float().contiguous()
    inst = instance(src, dot_src)
    general, vec, err_str = _kernel()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    dot_ptr = None if dot_src is None else dot_src.data_ptr()
    ds_ptr = None if dscale is None else dscale.data_ptr()
    order = None if dst.order is None else dst.order.data_ptr()
    if inst == "vec":
        scratch = dst.scratch(D)
        long_sum, long_bits, stride = scratch or (None, None, 0)
        err = vec(src.data_ptr(), _DTYPES[src.dtype], out.data_ptr(),
                  src_ids.data_ptr(), scl.data_ptr(),
                  order, dst.seg.data_ptr(),
                  None if scratch is None else dst.sorted_ids.data_ptr(),
                  None if scratch is None else long_sum.data_ptr(),
                  None if scratch is None else long_bits.data_ptr(), stride,
                  dot_ptr, ds_ptr, n_out, D, R, stream)
    else:
        err = general(src.data_ptr(), _DTYPES[src.dtype], src_ids.data_ptr(),
                      scl.data_ptr(), order, dst.seg.data_ptr(),
                      out.data_ptr(), n_out, D, dot_ptr, ds_ptr, stream)
    _build.check(err, f"gather_scatter_add ({inst})", err_str)
    LAUNCHES += 1
    LAUNCHES_BY_INSTANCE[inst] += 1
    return out, dscale


def gather_scatter_add_rows(src, src_rows, dst_rows, scale, n_out: int):
    """src (Ns, D); src_rows, dst_rows, scale (R,) -> (n_out, D) in
    ``src.dtype``, accumulated in f32.  Rows with ``scale == 0`` still
    move and add nothing (the reference's dropped assignments).  Builds
    its own layout of ``dst_rows``."""
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
        return _plain(src, src_rows, dst_rows, scale, n_out, None)[0]
    if src.device.type != "cuda":
        raise ValueError(f"gather_scatter_add: unsupported device "
                         f"{src.device}")
    return _move(src, scale, _ids(src_rows, src.shape[0]),
                 RowLayout.by_sort(dst_rows, n_out))[0]


def dscale_in_kernel_order(dot_src, src):
    """The routing-weight gradient in the ``vec`` instance's order, for
    rows ``dot_src`` (R, D) and ``src`` (R, D) paired entry by entry, as
    the backward forms it (the source written in its own dtype): each of
    32 lanes sums the products of its columns in f32 (16-byte chunks c =
    lane, lane + 32, ..., a chunk's columns in order, products and sums
    rounded separately), the lanes are folded by the shuffle tree (xor
    16, 8, 4, 2, 1), and passes of ``pass_columns`` columns are added in
    order.  What the kernel computes, bit for bit; a plain version of its
    order, not of the function (``.sum(-1)`` adds in another)."""
    cw = chunk_columns(src.dtype)
    width = pass_columns(src.dtype)
    R, D = src.shape
    a, b = dot_src.float(), src.float()
    lanes = torch.arange(32, device=src.device)
    total = None
    for p0 in range(0, D, width):
        part = torch.zeros((R, 32), dtype=torch.float32, device=src.device)
        for m in range(width // (32 * cw)):
            for k in range(cw):
                cols = p0 + (m * 32 + lanes) * cw + k
                live = cols < D
                cols = torch.where(live, cols, 0)
                prod = a[:, cols] * b[:, cols]
                part = torch.where(live, part + prod, part)
        for off in (16, 8, 4, 2, 1):
            part = part + part[:, lanes ^ off]
        total = part[:, 0] if total is None else total + part[:, 0]
    return total


def move(src, scale, src_lay: RowLayout, dst_lay: RowLayout, *,
         dot_src=None):
    """One movement on given layouts: out (dst_lay.n, D) with
    out[dst_lay.ids[i]] += scale[i] * src[src_lay.ids[i]], and with
    ``dot_src`` (dst_lay.n, D) also dscale[i] = dot(dot_src[
    dst_lay.ids[i]], src[src_lay.ids[i]]).  Returns (out, dscale or
    None)."""
    if src.dim() != 2 or scale.shape != src_lay.ids.shape:
        raise ValueError(f"expected src (Ns, D) and (R,) rows and scale, got "
                         f"{tuple(src.shape)}, {tuple(src_lay.ids.shape)}, "
                         f"{tuple(scale.shape)}")
    if src.shape[0] != src_lay.n:
        raise ValueError(f"src has {src.shape[0]} rows, its layout "
                         f"{src_lay.n}")
    if len({t.device for t in (src, scale, src_lay.ids)}) != 1:
        raise ValueError("all inputs must lie on one device")
    return _move(src, scale, src_lay.ids, dst_lay, dot_src=dot_src)


class _GSA(torch.autograd.Function):
    """The layouts' tensors are saved with ``save_for_backward`` (so a
    recomputing checkpoint frees them with the rest) and the backward's
    layout is rebuilt from them; its scratch, where a long segment needs
    one, is allocated anew there."""

    @staticmethod
    def forward(ctx, src, scale, src_lay, dst_lay):
        ctx.save_for_backward(src, scale, src_lay.ids, src_lay.seg,
                              src_lay.order, src_lay.sorted_ids, dst_lay.ids)
        return move(src, scale, src_lay, dst_lay)[0]

    @staticmethod
    def backward(ctx, dout):
        src, scale, ids, seg, order, sorted_ids, dst_ids = ctx.saved_tensors
        if not any(ctx.needs_input_grad[:2]):
            return None, None, None, None
        # the transpose of a scatter-add is the same movement, reversed;
        # dout in its own dtype (src's), dscale in the same launch
        src_lay = RowLayout(ids, src.shape[0], seg, order, sorted_ids)
        dsrc, dscale = _move(
            dout.contiguous(), scale, dst_ids, src_lay,
            dot_src=src if ctx.needs_input_grad[1] else None)
        return (dsrc if ctx.needs_input_grad[0] else None,
                None if dscale is None else dscale.to(scale.dtype),
                None, None)


def gather_scatter_add(src, scale, src_rows, dst_rows, n_out: int):
    """Trainable ``gather_scatter_add_rows`` (gradients for ``src`` and
    ``scale``), with the layouts of both row arrays built here."""
    return _GSA.apply(src, scale, RowLayout.by_sort(src_rows, src.shape[0]),
                      RowLayout.by_sort(dst_rows, n_out))


def _kernel_layouts(layouts):
    if layouts is None:
        raise ValueError("the kernel path needs layouts=routing_layouts(...) "
                         "of this routing")
    return layouts


def token_dispatch(xt, flat_tok, slot, keep, n_slots: int, *,
                   use_kernel: bool = True, layouts=None):
    """Pack tokens into flat capacity slots: out (n_slots, D) with
    ``out[slot[i]] += xt[flat_tok[i]]`` for kept assignments (dropped
    ones move to slot 0 with scale 0).  The kernel path needs
    ``layouts``, ``routing_layouts`` of these same flat_tok, slot and keep
    (``moe_ffn`` builds them once for both movements); they are not
    checked against the arrays."""
    scale = keep.float()
    dst = torch.where(keep, slot, torch.zeros_like(slot))
    if use_kernel:
        by_slot, by_token = _kernel_layouts(layouts)
        return _GSA.apply(xt, scale, by_token, by_slot)
    out = torch.zeros((n_slots, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    return out.index_add(0, dst.long(),
                         scale[:, None].to(xt.dtype) * xt[flat_tok.long()])


def token_combine(y2d, flat_tok, slot, keep, weights, n_tokens: int, *,
                  use_kernel: bool = True, layouts=None):
    """Unpack expert outputs back to tokens, applying routing weights:
    out (n_tokens, D) with ``out[flat_tok[i]] += w[i] * y2d[slot[i]]``
    for kept assignments (dropped assignments contribute zero).
    ``layouts`` as for ``token_dispatch``."""
    scale = torch.where(keep, weights, torch.zeros_like(weights))
    srcr = torch.where(keep, slot, torch.zeros_like(slot))
    if use_kernel:
        by_slot, by_token = _kernel_layouts(layouts)
        return _GSA.apply(y2d, scale, by_slot, by_token)
    gathered = torch.where(keep[:, None], y2d[srcr.long()],
                           torch.zeros((), dtype=y2d.dtype,
                                       device=y2d.device))
    out = torch.zeros((n_tokens, y2d.shape[1]), dtype=y2d.dtype,
                      device=y2d.device)
    return out.index_add(0, flat_tok.long(),
                         gathered * scale[:, None].to(y2d.dtype))


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
