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
  per-expert (E, M, K) @ (E, K, N) in f32, operands in bf16 or f32 read
  through their strides, so transposes are views.

A CPU tensor runs the plain versions in ``ref.py``; a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts each wrapper's kernel
launches; the FFN's two stages are one C call and count once under
``grouped_ffn`` (its f32 instance's products reuse the grouped-matmul
code inside that call), so ``LAUNCHES["grouped_matmul"]`` counts the
backward's products.

``grouped_ffn`` is a ``torch.autograd.Function`` whose backward is the
reference's ``_grouped_ffn_bwd``: it recomputes g, u and h and forms the
eight grouped products with ``grouped_matmul``; the gated activation's
VJP is plain autograd, as it is ``jax.vjp`` in the reference.
``moe_ffn`` composes the dispatch, ``grouped_ffn`` and the combine with
the reference's capacity ``max(ceil(T·k/E)·2, 8)``, so it drops the same
assignments the reference drops.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_dispatch.ops import (capacity_positions,
                                                  token_combine,
                                                  token_dispatch)
from repro_torch.kernels.moe_gemm.ref import (gated_act, grouped_ffn_ref,
                                              grouped_matmul_ref)

LAUNCHES = {"grouped_ffn": 0, "grouped_matmul": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"silu": 0, "gelu": 1}
_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.library("moe_gemm")
        gmm = lib.grouped_matmul
        i64 = ctypes.c_int64
        gmm.argtypes = ([ctypes.c_void_p, ctypes.c_int, i64, i64, i64] * 2
                        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
        gmm.restype = ctypes.c_int
        ffn = lib.grouped_ffn_fwd
        ffn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])
        ffn.restype = ctypes.c_int
        lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
        lib.moe_gemm_error_string.restype = ctypes.c_char_p
        _fns = (gmm, ffn, lib.moe_gemm_error_string)
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


def grouped_matmul(a, b, *, out_dtype=torch.float32):
    """a (E, M, K) @ b (E, K, N) -> (E, M, N) in ``out_dtype``, f32
    products.  Either operand may be a strided view (a transpose)."""
    global LAUNCHES
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"expected a (E, M, K) and b (E, K, N), got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return grouped_matmul_ref(a, b, out_dtype)
    dev = _cuda_checks("grouped_matmul", (a, b))
    if out_dtype not in _DTYPES:
        raise TypeError(f"grouped_matmul: out_dtype {out_dtype} not in "
                        f"{list(_DTYPES)}")
    E, M, K = a.shape
    N = b.shape[2]
    out = torch.empty((E, M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    gmm, _, err_str = _kernels()
    err = gmm(a.data_ptr(), _DTYPES[a.dtype], *a.stride(),
              b.data_ptr(), _DTYPES[b.dtype], *b.stride(),
              out.data_ptr(), _DTYPES[out_dtype], E, M, N, K,
              torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "grouped_matmul", err_str)
    LAUNCHES["grouped_matmul"] += 1
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
    _, ffn, err_str = _kernels()
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
        del g, u
        dx = grouped_matmul(dg, tr(wg))
        dx += grouped_matmul(du, tr(wu))
        dwg = grouped_matmul(tr(x), dg)               # (E, D, F)
        dwu = grouped_matmul(tr(x), du)
        dwo = grouped_matmul(tr(h), dy)               # (E, F, D)
        return (dx.to(x.dtype), dwg.to(wg.dtype), dwu.to(wu.dtype),
                dwo.to(wo.dtype), None)


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
    buf = token_dispatch(xt, flat_tok, slot, keep, E * cap)
    y = grouped_ffn(buf.reshape(E, cap, D), wg, wu, wo, act=act)
    out = token_combine(y.reshape(E * cap, D), flat_tok, slot, keep,
                        w.reshape(-1), T)
    return out.to(xt.dtype)
