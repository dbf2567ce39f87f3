"""Public wrappers of the grouped expert GEMM kernels, trainable.

Counterpart of ``repro.kernels.moe_gemm.ops``.  Two Pallas TPU kernels
of ``repro/kernels/moe_gemm/kernel.py`` are replaced by
``csrc/moe_gemm.cu`` (its header says what bounds each on the H100 and
what the design does about it):

* ``grouped_ffn_ecd`` (``_ffn_kernel``) by ``grouped_ffn_fwd``: the
  gated expert FFN over fixed-capacity (E, C, D) buffers, in two stages.
  bf16 inputs run both on the tensor cores: h = act(x@wg)·(x@wu) in f32,
  stored as two bf16 planes hi = bf16(h), lo = bf16(h - hi) (the bytes
  of one f32 h), then y = lo@wo + hi@wo in f32, rounded once.  f32
  inputs keep f32 h in scratch and f32 products on the CUDA cores;
* ``grouped_matmul`` (``_matmul_kernel``) by ``grouped_matmul``:
  per-expert (E, M, K) @ (E, K, N), f32 sums rounded once to
  ``out_dtype``, operands read through their strides (transposes are
  views); ``plus=(a2, b2)`` adds a second product into the same sum in
  the same launch.  ``instance`` picks the kernel's instance from dtypes,
  strides and pointers alone: ``wgmma`` (two bf16 operands TMA can
  read: tensor cores), ``wgmma_split`` (one of them a ``Split``, an f32
  value as two bf16 terms made by ``split_f32``), ``f32`` (two f32
  operands: CUDA cores, as the f32 models need) and ``general`` (any
  other mix or layout, CUDA cores).

A CPU tensor runs the plain versions in ``ref.py``; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts each wrapper's kernel
launches; the FFN's two stages are one C call and count once under
``grouped_ffn`` (its f32 instance's products reuse the grouped-matmul
code inside that call), so ``LAUNCHES["grouped_matmul"]`` counts the
backward's products and ``LAUNCHES_BY_INSTANCE`` the same launches by
instance; ``LAUNCHES["split_f32"]`` counts the split passes.

``grouped_ffn`` is a ``torch.autograd.Function`` whose backward is the
reference's ``_grouped_ffn_bwd``: it recomputes g, u and h and forms the
eight grouped products with ``grouped_matmul`` (dx's two in one
launch); the gated activation's VJP is plain autograd, as it is
``jax.vjp`` in the reference.  For bf16 on the card, dg, du and h are
split once each and the weight gradients and dx are written in their
own dtypes by the kernel.
``moe_ffn`` composes the dispatch, ``grouped_ffn`` and the combine with
the reference's capacity ``max(ceil(T·k/E)·2, 8)``, so it drops the same
assignments the reference drops.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch.ops import (capacity_positions,
                                                  routing_layouts,
                                                  token_combine,
                                                  token_dispatch)
from repro_torch.kernels.moe_gemm.ref import (Split, gated_act,
                                              grouped_ffn_ref,
                                              grouped_matmul_ref,
                                              split_f32_ref)

LAUNCHES = {"grouped_ffn": 0, "grouped_matmul": 0, "split_f32": 0}
LAUNCHES_BY_INSTANCE = {"wgmma": 0, "wgmma_split": 0, "general": 0,
                        "f32": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}
_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.library("moe_gemm")
        ops = ctypes.POINTER(ctypes.c_int64)
        shape = [ctypes.c_int] * 5 + [ctypes.c_void_p]   # E M N K0 K1 stream
        gmm = lib.grouped_matmul
        gmm.argtypes = ([ops] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p, ctypes.c_int] + shape)
        tc = lib.grouped_matmul_wgmma
        tc.argtypes = gmm.argtypes
        split = lib.split_f32
        split.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                  ctypes.c_void_p]
        ffn = lib.grouped_ffn_fwd
        ffn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
        for f in (gmm, tc, split, ffn):
            f.restype = ctypes.c_int
        lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        _fns = (gmm, tc, split, ffn, lib.moe_gemm_error_string)
    return _fns


def _cuda_checks(name, ts):
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: all inputs must lie on one device")
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in ts:
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not in {list(_DTYPES)}")
    return dev


def _planes(t):
    return (t.hi, t.lo) if isinstance(t, Split) else (t,)


def _tma_major(t, k_axis: int):
    """How TMA reads one bf16 plane of an (E, R0, R1) operand whose K axis
    is ``k_axis`` (2 for A, 1 for B): "k" if K has stride 1, "mn" if the
    other matrix axis has; None if neither does or TMA cannot take it (a
    base off 16 bytes, the rows' or experts' stride not a multiple of 16
    bytes, rows that overlap)."""
    if t.dtype != torch.bfloat16 or t.data_ptr() % 16:
        return None
    other = 3 - k_axis
    st, sh = t.stride(), t.shape
    if st[k_axis] == 1:
        major, inner, outer = "k", k_axis, other
    elif st[other] == 1:
        major, inner, outer = "mn", other, k_axis
    else:
        return None
    if st[outer] % 8 or st[outer] < sh[inner]:
        return None
    if sh[0] > 1 and (st[0] % 8 or st[0] < st[outer] * sh[outer]):
        return None
    return major


def _plan(pairs):
    """(instance, A MN-major, B MN-major) of a launch on these pairs."""
    ts = [t for p in pairs for t in p]
    f32 = [not isinstance(t, Split) and t.dtype == torch.float32 for t in ts]
    if all(f32):
        return "f32", 0, 0
    split = {(isinstance(a, Split), isinstance(b, Split)) for a, b in pairs}
    if any(f32) or len(split) > 1 or (True, True) in split:
        return "general", 0, 0
    lay = {(tuple(_tma_major(p, 2) for p in _planes(a)),
            tuple(_tma_major(p, 1) for p in _planes(b))) for a, b in pairs}
    if len(lay) > 1:
        return "general", 0, 0
    (la, lb), = lay
    if None in la + lb or len(set(la)) > 1 or len(set(lb)) > 1:
        return "general", 0, 0
    inst = "wgmma_split" if True in next(iter(split)) else "wgmma"
    return inst, int(la[0] == "mn"), int(lb[0] == "mn")


def instance(a, b, plus=None) -> str:
    """The instance a CUDA launch of ``grouped_matmul`` on these operands
    takes (see the module's docstring), from dtypes, strides and
    pointers alone."""
    return _plan([(a, b)] + ([tuple(plus)] if plus is not None else []))[0]


def _desc(t):
    """An operand as the C entry points read it: its pointer, its second
    term's (0 if none), its element strides along e and its two matrix
    axes.  A single expert's e stride is never used: it is replaced by
    one TMA takes."""
    p = _planes(t)
    st = list(p[0].stride())
    if p[0].shape[0] == 1:
        span = max(s * n for s, n in zip(st[1:], p[0].shape[1:]))
        st[0] = -(-span // 8) * 8
    return (p[0].data_ptr(), p[1].data_ptr() if len(p) > 1 else 0, *st)


def _kind(t):
    return torch.bfloat16 if isinstance(t, Split) else t.dtype


def split_f32(t):
    """f32 t -> ``Split(hi, lo)``, hi = bf16(t), lo = bf16(t - hi), both
    contiguous, in one bf16 buffer of about t's bytes (lo starts on a
    16-byte boundary, as TMA needs).  One pass over t, so a tensor that
    feeds several products is split once."""
    global LAUNCHES
    if t.dtype != torch.float32:
        raise TypeError(f"split_f32: expected float32, got {t.dtype}")
    if t.device.type == "cpu":
        return split_f32_ref(t)
    _cuda_checks("split_f32", (t,))
    t = t.contiguous()
    n = t.numel()
    gap = -(-n // 8) * 8
    buf = torch.empty(gap + n, dtype=torch.bfloat16, device=t.device)
    hi, lo = buf[:n].view(t.shape), buf[gap:].view(t.shape)
    if n:
        _, _, split, _, err_str = _kernels()
        err = split(t.data_ptr(), hi.data_ptr(), lo.data_ptr(), n,
                    torch.cuda.current_stream(t.device).cuda_stream)
        _build.check(err, "split_f32", err_str)
        LAUNCHES["split_f32"] += 1
    return Split(hi, lo)


def grouped_matmul(a, b, *, out_dtype=torch.float32, plus=None):
    """a (E, M, K) @ b (E, K, N) [+ a2 (E, M, K2) @ b2 (E, K2, N) for
    ``plus=(a2, b2)``] -> (E, M, N) in ``out_dtype``: f32 sums of the
    products, rounded once.  Operands are tensors in bf16 or f32, any
    strides (transposes are views), or ``Split``s; the second pair's
    operands share the first pair's dtypes."""
    global LAUNCHES
    pairs = [(a, b)] + ([tuple(plus)] if plus is not None else [])
    E, M = a.shape[0], a.shape[1]
    N = b.shape[-1]
    for x, y in pairs:
        if x.dim() != 3 or y.dim() != 3 or x.shape[:2] != (E, M) \
                or y.shape[0] != E or y.shape[2] != N \
                or x.shape[2] != y.shape[1]:
            raise ValueError(f"expected a (E, M, K) and b (E, K, N) of one "
                             f"E, M and N; got {tuple(x.shape)}, "
                             f"{tuple(y.shape)}")
    for t in (t for p in pairs for t in p if isinstance(t, Split)):
        if t.hi.shape != t.lo.shape or t.hi.stride() != t.lo.stride() \
                or {t.hi.dtype, t.lo.dtype} != {torch.bfloat16}:
            raise ValueError("grouped_matmul: a Split's terms must be bf16 "
                             "of one shape and strides")
    planes = [p for x, y in pairs for t in (x, y) for p in _planes(t)]
    if all(p.device.type == "cpu" for p in planes):
        return grouped_matmul_ref(a, b, out_dtype, plus)
    dev = _cuda_checks("grouped_matmul", planes)
    if out_dtype not in _DTYPES:
        raise TypeError(f"grouped_matmul: out_dtype {out_dtype} not in "
                        f"{list(_DTYPES)}")
    if any((_kind(x), _kind(y)) != (_kind(a), _kind(b)) for x, y in pairs):
        raise TypeError("grouped_matmul: the pairs' operands must share "
                        "dtypes")
    out = torch.empty((E, M, N), dtype=out_dtype, device=dev)
    pairs = [(x, y) for x, y in pairs if x.shape[2] > 0]
    if out.numel() == 0:
        return out
    if not pairs:
        return out.zero_()
    inst, ta, tb = _plan(pairs)
    descs = [v for x, y in pairs for v in (*_desc(x), *_desc(y))]
    ops = (ctypes.c_int64 * len(descs))(*descs)
    K0, K1 = pairs[0][0].shape[2], pairs[-1][0].shape[2]
    gmm, tc, _, _, err_str = _kernels()
    rest = (out.data_ptr(), _DTYPES[out_dtype], E, M, N, K0, K1,
            torch.cuda.current_stream(dev).cuda_stream)
    if inst.startswith("wgmma"):
        err = tc(ops, len(pairs), ta, tb, *rest)
    else:
        err = gmm(ops, len(pairs), _DTYPES[_kind(a)], _DTYPES[_kind(b)],
                  *rest)
    _build.check(err, f"grouped_matmul ({inst})", err_str)
    LAUNCHES["grouped_matmul"] += 1
    LAUNCHES_BY_INSTANCE[inst] += 1
    return out


def grouped_ffn_fwd(x, wg, wu, wo, *, act: str = "silu"):
    """x (E, C, D), wg/wu (E, D, F), wo (E, F, D) -> y (E, C, D) in x's
    dtype, f32 sums inside, one rounding at the end.  The hidden h lies
    between the stages in a scratch of 4·E·C·F bytes: two bf16 planes
    (hi, lo) for bf16 inputs, f32 h for f32.  Any alignment and any D
    and F are taken (a row or pointer unfit for 16-byte copies is read
    element by element).  No gradient: ``grouped_ffn`` carries it."""
    global LAUNCHES
    E, C, D = x.shape
    Fh = wg.shape[-1]
    if wg.shape != (E, D, Fh) or wu.shape != (E, D, Fh) \
            or wo.shape != (E, Fh, D):
        raise ValueError(f"expected x (E, C, D), wg/wu (E, D, F), wo (E, F, "
                         f"D); got {tuple(x.shape)}, {tuple(wg.shape)}, "
                         f"{tuple(wu.shape)}, {tuple(wo.shape)}")
    if act not in _ACTS:
        raise ValueError(f"act must be one of {list(_ACTS)}, got {act!r}")
    ts = (x, wg, wu, wo)
    if all(t.device.type == "cpu" for t in ts):
        return grouped_ffn_ref(x, wg, wu, wo, act=act)
    dev = _cuda_checks("grouped_ffn", ts)
    if len({t.dtype for t in ts}) != 1:
        raise TypeError("grouped_ffn: x and the weights must share a dtype")
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    if Fh == 0:
        return y.zero_()
    x, wg, wu, wo = (t.contiguous() for t in ts)
    if x.dtype == torch.bfloat16:
        h = torch.empty((2, E, C, Fh), dtype=x.dtype, device=dev)  # hi, lo
        u = None
    else:
        h, u = (torch.empty((E, C, Fh), dtype=x.dtype, device=dev)
                for _ in range(2))
    _, _, _, ffn, err_str = _kernels()
    err = ffn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wo.data_ptr(),
              h.data_ptr(), None if u is None else u.data_ptr(), y.data_ptr(),
              _DTYPES[x.dtype], _ACTS[act], E, C, D, Fh,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "grouped_ffn", err_str)
    LAUNCHES["grouped_ffn"] += 1
    return y


class _GroupedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wg, wu, wo, act):
        ctx.save_for_backward(x, wg, wu, wo)
        ctx.act = act
        return grouped_ffn_fwd(x, wg, wu, wo, act=act)

    @staticmethod
    def backward(ctx, dy):
        x, wg, wu, wo = ctx.saved_tensors
        tr = lambda t: t.transpose(1, 2)  # noqa: E731 (a view, no copy)
        g = grouped_matmul(x, wg)                    # (E, C, F) f32
        u = grouped_matmul(x, wu)
        with torch.enable_grad():
            g.requires_grad_(True)
            u.requires_grad_(True)
            h = gated_act(ctx.act, g, u)
        dh = grouped_matmul(dy, tr(wo))               # (E, C, F)
        dg, du = torch.autograd.grad(h, (g, u), dh)
        h = h.detach()
        del g, u, dh
        if dy.is_cuda and all(t.dtype == torch.bfloat16
                              for t in (x, wg, wu, wo, dy)):
            # the f32 operand of each mixed product as two bf16 terms,
            # split once for the one or two products it feeds
            dg, du, h = split_f32(dg), split_f32(du), split_f32(h)
        dx = grouped_matmul(dg, tr(wg), out_dtype=x.dtype,
                            plus=(du, tr(wu)))
        dwg = grouped_matmul(tr(x), dg, out_dtype=wg.dtype)  # (E, D, F)
        dwu = grouped_matmul(tr(x), du, out_dtype=wu.dtype)
        dwo = grouped_matmul(tr(h), dy, out_dtype=wo.dtype)  # (E, F, D)
        return dx, dwg, dwu, dwo, None


def grouped_ffn(x, wg, wu, wo, *, act: str = "silu"):
    """Fixed-capacity grouped FFN, differentiable in all four inputs."""
    return _GroupedFFN.apply(x, wg, wu, wo, act)


def moe_ffn(xt, w, idx, wg, wu, wo, *, act: str = "silu"):
    """Routed token-level MoE for the single-device path: dispatch into
    capacity buffers, grouped FFN, weighted combine.  xt (T, D); w, idx
    (T, k); wg/wu (E, D, F); wo (E, F, D).  Assignments past an expert's
    capacity drop, as in the reference."""
    T, D = xt.shape
    k = idx.shape[1]
    E = wg.shape[0]
    cap = max(-(-T * k // E) * 2, 8)  # the reference's static capacity
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(T * k, device=xt.device) // k
    pos, keep = capacity_positions(flat_e, cap)
    slot = flat_e * cap + pos
    # the four movements' two layouts, once a call
    lay = routing_layouts(flat_tok, slot, keep, E * cap, T, k=k)
    buf = token_dispatch(xt, flat_tok, slot, keep, E * cap, layouts=lay)
    y = grouped_ffn(buf.reshape(E, cap, D), wg, wu, wo, act=act)
    out = token_combine(y.reshape(E * cap, D), flat_tok, slot, keep,
                        w.reshape(-1), T, layouts=lay)
    return out.to(xt.dtype)
