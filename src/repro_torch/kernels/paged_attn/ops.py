"""Public wrapper of the paged-attention kernel (decode; C-query chunks).

Replaces ``repro.kernels.paged_attn.kernel.paged_attention_bhgd`` (the
Pallas TPU kernel ``_paged_kernel``, unquantized branch) behind the
signature of ``repro.kernels.paged_attn.ops.paged_decode_attention``.
The CUDA source is ``csrc/paged_attn.cu``; its header says what bounds
it on the H100 (memory: every visible K/V row read once) and what the
design does about it.

``layers.attention_decode`` calls this after inserting the chunk's k/v
into the pool.  The engine keeps every table entry a valid pool row
(trash block 0 for unallocated tail entries) and ``pos + C - 1`` inside
the table, which ``layers.paged_insert`` checks when it writes.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises — nothing falls back.  ``LAUNCHES``
counts kernel launches, so a run can show the path went through it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("paged_attn")
        fn = lib.paged_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.paged_attention_error_string)
    return _fn


def _check_inputs(q, k_pool, v_pool, block_table, pos):
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"expected q (B,C,H,D) and pools (n_blocks,bl,KH,D) "
                         f"of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, _, H, D = q.shape
    if k_pool.shape[3] != D or H % k_pool.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and pools "
                         f"{tuple(k_pool.shape)} disagree on head dim or "
                         f"head grouping")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or pos.shape != (B,):
        raise ValueError(f"expected block_table (B={B}, nbt) and pos (B,), "
                         f"got {tuple(block_table.shape)}, {tuple(pos.shape)}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_table and pos must be int32")
    if not (q.dtype == k_pool.dtype == v_pool.dtype) \
            or q.dtype not in _DTYPES:
        raise TypeError(f"q and the pools must share a float32 or bfloat16 "
                        f"dtype, got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    devs = {t.device for t in (q, k_pool, v_pool, block_table, pos)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must lie on one device, got {devs}")


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, *,
                           window: int = 0, softcap: float = 0.0):
    """q: (B, C, H, D); pools: (n_blocks, block_len, KH, D);
    block_table: (B, nbt) int32; pos: (B,) int32 position of the FIRST
    query (queries are consecutive) -> (B, C, H, D).  Scale 1/sqrt(D).
    """
    global LAUNCHES
    _check_inputs(q, k_pool, v_pool, block_table, pos)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    ts = (q, k_pool, v_pool, block_table, pos)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_decode_attention: the kernel reads pool rows "
                         "with 16-byte loads; pools must be 16-byte aligned")
    B, C, H, D = q.shape
    bl, KH = k_pool.shape[1], k_pool.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    fn, err_str = _kernel()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], B, C, H, KH, D, bl, block_table.shape[1],
             int(window), float(softcap), 1.0 / math.sqrt(D),
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention", err_str)
    LAUNCHES += 1
    return out
