"""Public wrapper of the paged-attention kernel (decode; C-query chunks).

Replaces ``repro.kernels.paged_attn.kernel.paged_attention_bhgd`` (the
Pallas TPU kernel ``_paged_kernel``, both branches) behind the signature
of ``repro.kernels.paged_attn.ops.paged_decode_attention``.  The CUDA
source is ``csrc/paged_attn.cu``; its header says what bounds it on the
H100 (at decode's shapes the launch and a chain of dependent memory
round trips; the bytes only at long contexts) and what the design does
about it: the context is split across blocks and merged in a fixed
order inside the same launch.  ``split_plan`` picks the split
from shapes only (never from ``pos``, so a decode step needs no host
sync); the wrapper hands the kernel f32 scratch for the partials
(``torch.empty``) and a per-device array of int32 counters, zeroed once
and grown when needed, which every launch leaves at zero.  Launches
that share a device run on one stream at a time.

``layers.attention_decode`` calls this after inserting the chunk's k/v
into the pool.  The engine keeps every table entry a valid pool row
(trash block 0 for unallocated tail entries) and ``pos + C - 1`` inside
the table, which ``layers.paged_insert`` checks when it writes.

q, the pools and the output are each float32 or bfloat16 (a ``bf16`` or
``fp32`` cache policy may differ from the model's dtype).  Quantized
pools (int8 or fp8 e4m3 rows under a ``quant.CachePolicy``) come with
their f32 ``k_scale``/``v_scale`` pools (n_blocks, block_len, KH), read
through the same table; the kernel dequantizes each row in registers.
``out_dtype`` names the output's dtype: the pools' by default, as in the
reference, and required for quantized pools.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises — nothing falls back.  ``LAUNCHES``
counts launches over unquantized pools and ``LAUNCHES_QUANT`` over
quantized ones, so a run can show which branch the path went through;
``LAUNCHES_CHUNK`` counts the launches of either with more than one
query row a slot (C > 1: chunked admission).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

LAUNCHES = 0
LAUNCHES_QUANT = 0
LAUNCHES_CHUNK = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}
_POOL_DTYPES = {**_DTYPES, **_QUANT_DTYPES}
# the head dims csrc/paged_attn.cu is built for (by_dim)
_HEAD_DIMS = (16, 24, 32, 64, 96, 112, 128, 256)
ROWS = 8             # query rows a block takes (csrc: RC)
MAX_SPLITS = 64      # csrc: MAX_SPLITS
BLOCKS_PER_SM = 2    # what the split aims to put on each SM
_fn = None
_COUNTERS = {}       # device index -> int32 counters, all zero between launches
_SM_COUNT = {}


def tile_keys(D: int, elem_size: int) -> int:
    """Keys per tile of the kernel's instance (csrc: tile_keys): 64, or 32
    and 16 for pool rows over 256 and 512 bytes."""
    row = D * elem_size
    return 64 if row <= 256 else 32 if row <= 512 else 16


def _row_groups(B, C, H, KH):
    """(kv head, slot, ROWS query rows) groups: the blocks of one slice."""
    return KH * B * -(-C * (H // KH) // ROWS)


def split_plan(B, C, H, KH, D, elem_size, block_len, nbt, n_sm):
    """(tiles_per_split, n_split) from shapes only: the table's logical
    positions in tiles, cut into the fewest equal slices that put about
    BLOCKS_PER_SM blocks on each of ``n_sm`` SMs, at most MAX_SPLITS."""
    tiles = -(-nbt * block_len // tile_keys(D, elem_size))
    base = _row_groups(B, C, H, KH)
    tps = max(1, tiles * base // (BLOCKS_PER_SM * n_sm),
              -(-tiles // MAX_SPLITS))
    return tps, -(-tiles // tps)


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("paged_attn")
        args = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn = lib.paged_attention_fwd
        fn.argtypes = args
        fn.restype = ctypes.c_int
        split = lib.paged_attention_fwd_split
        split.argtypes = args + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        split.restype = ctypes.c_int
        config = lib.paged_attention_config
        config.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        config.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, split, config, lib.paged_attention_error_string)
    return _fn


def kernel_config(pool_dtype, D):
    """(keys per tile, dynamic shared memory bytes) of the kernel's
    instance for a pool dtype and head dim, as the CUDA source has them."""
    _, _, config, err_str = _kernel()
    tk, smem = ctypes.c_int(), ctypes.c_int()
    err = config(_POOL_DTYPES[pool_dtype], D, ctypes.byref(tk),
                 ctypes.byref(smem))
    _build.check(err, "paged_attention_config", err_str)
    return tk.value, smem.value


def _counters(device, n):
    """The device's counters, at least n of them (zeros)."""
    c = _COUNTERS.get(device.index)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = c
    return c


def _sm_count(device):
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _check_inputs(q, k_pool, v_pool, block_table, pos, k_scale, v_scale,
                  out_dtype):
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
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
    if q.dtype not in _DTYPES or out_dtype not in (None, *_DTYPES):
        raise TypeError(f"q and out_dtype must be float32 or bfloat16, got "
                        f"{q.dtype}, {out_dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"the pools differ in dtype: {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    ts = [q, k_pool, v_pool, block_table, pos]
    if k_scale is None:
        if k_pool.dtype not in _DTYPES:
            raise TypeError(f"pools without scales must be float32 or "
                            f"bfloat16, got {k_pool.dtype}")
    else:
        if k_pool.dtype not in _QUANT_DTYPES:
            raise TypeError(f"scaled pools must be int8 or float8_e4m3fn, "
                            f"got {k_pool.dtype}")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.dtype != torch.float32 or s.shape != k_pool.shape[:3]:
                raise ValueError(f"{name} must be float32 of shape "
                                 f"{tuple(k_pool.shape[:3])}, got {s.dtype} "
                                 f"{tuple(s.shape)}")
        if out_dtype is None:
            raise ValueError("out_dtype is required for quantized pools")
        ts += [k_scale, v_scale]
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"all inputs must lie on one device, got {devs}")


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, *,
                           window: int = 0, softcap: float = 0.0,
                           k_scale=None, v_scale=None, out_dtype=None):
    """q: (B, C, H, D); pools: (n_blocks, block_len, KH, D);
    block_table: (B, nbt) int32; pos: (B,) int32 position of the FIRST
    query (queries are consecutive) -> (B, C, H, D) in ``out_dtype``
    (default: the pools' dtype).  Scale 1/sqrt(D).
    ``k_scale``/``v_scale``: f32 (n_blocks, block_len, KH) for int8/fp8
    pools, which need ``out_dtype``.
    """
    global LAUNCHES, LAUNCHES_QUANT, LAUNCHES_CHUNK
    _check_inputs(q, k_pool, v_pool, block_table, pos, k_scale, v_scale,
                  out_dtype)
    quantized = k_scale is not None
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_table, pos,
                                   window=window, softcap=softcap,
                                   k_scale=k_scale, v_scale=v_scale,
                                   out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    ts = (q, k_pool, v_pool, block_table, pos) + (
        (k_scale, v_scale) if quantized else ())
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention: inputs must be contiguous")
    B, C, H, D = q.shape
    bl, KH = k_pool.shape[1], k_pool.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {D} not in "
                         f"{_HEAD_DIMS}")
    # the kernel reads a pool row with 16-byte loads, or 8-byte ones
    # where a row is not a multiple of 16 bytes (csrc: row_load_bytes)
    row_bytes = D * k_pool.element_size()
    vb = 16 if row_bytes % 16 == 0 else 8
    if k_pool.data_ptr() % vb or v_pool.data_ptr() % vb:
        raise ValueError(f"paged_decode_attention: the kernel reads pool "
                         f"rows with {vb}-byte loads; pools must be "
                         f"{vb}-byte aligned")
    out = torch.empty(q.shape, dtype=out_dtype or v_pool.dtype,
                      device=q.device)
    nbt = block_table.shape[1]
    tps, n_split = split_plan(B, C, H, KH, D, k_pool.element_size(), bl, nbt,
                              _sm_count(q.device))
    fn, fn_split, _, err_str = _kernel()
    args = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], _POOL_DTYPES[k_pool.dtype],
            _DTYPES[out.dtype], B, C, H, KH, D, bl, nbt, int(window),
            float(softcap), 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if n_split == 1:
        err = fn(*args)
    else:
        groups = _row_groups(B, C, H, KH)
        part = torch.empty(groups * n_split * ROWS * (D + 2),
                           dtype=torch.float32, device=q.device)
        err = fn_split(*args, part.data_ptr(),
                       _counters(q.device, groups).data_ptr(), tps, n_split)
    _build.check(err, "paged_decode_attention", err_str)
    if quantized:
        LAUNCHES_QUANT += 1
    else:
        LAUNCHES += 1
    if C > 1:
        LAUNCHES_CHUNK += 1
    return out
