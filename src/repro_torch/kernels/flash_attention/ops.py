"""Public wrapper of the flash-attention kernel, with its gradient.

Replaces ``repro.kernels.flash_attention.kernel.flash_attention_bhsd``
(the Pallas TPU kernel ``_attn_kernel``) behind the signature of
``repro.kernels.flash_attention.ops.flash_attention``.  The CUDA source
is ``csrc/flash_attention.cu``; its header says what bounds it on the
H100 (arithmetic, at prefill shapes) and what the design does about it.

A CPU tensor runs the plain version in ``ref.py``, and autograd goes
straight through it.  A CUDA tensor launches the kernel or raises —
nothing falls back — inside a ``torch.autograd.Function`` whose backward
is the reference's ``_fa_bhsd_bwd``: it recomputes the dense
``flash_attention_ref`` on the saved q, k, v and differentiates that
(scores (B·H, Sq, Sk) live in the backward only).  The GQA repeat in
``flash_attention_ref`` sums the K/V gradients over each group's query
heads, as the VJP of the reference's ``jnp.repeat`` does.  ``LAUNCHES``
counts kernel launches, so a run can show the path went through it;
``LAUNCHES_BIDIR`` those of them with ``causal=False`` (the
encoder-decoder family's encoder).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LAUNCHES = 0
LAUNCHES_BIDIR = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims csrc/flash_attention.cu is built for (dispatch_d)
_HEAD_DIMS = (16, 24, 32, 64, 96, 112, 128, 256)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("flash_attention")
        fn = lib.flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Sq,H,D) and k/v (B,Sk,KH,D) of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} "
                         f"disagree on batch, head dim or head grouping")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share a float32 or bfloat16 dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: (B, Sq, H, D), k/v: (B, Sk, KH, D) -> (B, Sq, H, D).

    Query head h attends kv head h // (H // KH); scale 1/sqrt(D);
    causal positions start at 0 for both q and k, as in the reference.
    """
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(softcap))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        return _flash_fwd(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_attention_ref(*qkv, **ctx.kw)
        dq, dk, dv = torch.autograd.grad(out, qkv, dout)
        return dq, dk, dv, None, None, None


def _flash_fwd(q, k, v, *, causal, window, softcap):
    """The kernel launch (CUDA tensors)."""
    global LAUNCHES, LAUNCHES_BIDIR
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    # the bf16 kernel copies rows with 16-byte cp.async (csrc: cp_async16)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention: the bf16 kernel reads "
                                 f"rows with 16-byte copies; {name} must be "
                                 f"16-byte aligned")
    fn, err_str = _kernel()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], B, Sq, Sk, H, KH, D, int(bool(causal)),
             int(window), float(softcap), 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention", err_str)
    LAUNCHES += 1
    if not causal:
        LAUNCHES_BIDIR += 1
    return out
