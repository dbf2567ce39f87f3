"""Public wrappers of the fused KD-loss kernel, with their gradients.

Replaces ``repro.kernels.kd_loss.kernel.kd_loss_fwd`` (the Pallas TPU
kernel ``_kd_kernel``) behind the signatures of
``repro.kernels.kd_loss.ops.ce_from_hidden`` / ``ce_kl_from_hidden``.
The CUDA source is ``csrc/kd_loss.cu``; its header says what bounds it
on the H100 (arithmetic: 2·T·D·V flops) and what the design does about
it (vocab split across the grid, a merge kernel, and for bf16 TMA and
``wgmma`` with the statistics kept in registers).

Forward: a CPU tensor runs the plain version in ``ref.py``; a CUDA
tensor launches the kernel or raises — nothing falls back.  The kernel
reads ``ws`` (D, V) row-major: a tied head's ``embed.T`` is a transposed
view, which the wrapper copies with ``.contiguous()`` (only tied
families pay it).  ``instance`` picks the kernel's instance from dtypes,
shapes and pointers alone: ``wgmma`` (bf16 whose rows and bases suit
TMA), ``general`` (any other bf16), ``f32``.  ``LAUNCHES`` counts kernel
launches, ``LAUNCHES_BY_INSTANCE`` the same launches by instance and
``LAUNCHES_BY_MODE`` by mode (``ce`` alone, or ``kd`` with a teacher).

Backward: ``_ce_bwd`` / ``_ce_kl_bwd`` of the reference, the same on the
CPU and on the card: two passes over vocab blocks of ``block_v``
columns, in f32.  Pass 1 streams the logsumexp statistics; pass 2
recomputes each logit block and forms

  dz = (softmax(z_s) - onehot)·dce  [+ τ·(softmax(z_s/τ) - softmax(z_t/τ))·dkl]

times the softcap derivative, then ``dhs += dz @ wbᵀ`` and
``dws_blk = hsᵀ @ dz`` with ``torch.matmul``: the plain large products
the reference leaves to XLA.  The teacher gets no gradient (Eq. 10 has
a frozen teacher), as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kd_loss.ref import ce_kl_ref, ce_ref

LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {"wgmma": 0, "general": 0, "f32": 0}
LAUNCHES_BY_MODE = {"ce": 0, "kd": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# per instance (kd_loss.cu): rows and vocab columns a block's tile (the
# wgmma instance's KD tiles are half as wide: 128 columns a side), and
# the blocks an SM its grid is sized for (the wgmma instance: one wave of
# one block an SM; the others: about four an SM)
TILES = {"wgmma": (128, 256, 1), "general": (64, 128, 4), "f32": (64, 128, 4)}
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("kd_loss")
        fn = lib.kd_loss_fwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        tc = lib.kd_loss_fwd_wgmma
        tc.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        tc.restype = ctypes.c_int
        lib.kd_loss_nstat.restype = ctypes.c_int
        lib.kd_loss_error_string.argtypes = [ctypes.c_int]
        lib.kd_loss_error_string.restype = ctypes.c_char_p
        _fn = (fn, tc, lib.kd_loss_nstat(), lib.kd_loss_error_string)
    return _fn


def tile_shape(inst: str, teacher: bool = False):
    """(rows, vocab columns) of one block's tile in ``inst``."""
    rows, cols, _ = TILES[inst]
    return rows, cols // 2 if inst == "wgmma" and teacher else cols


def vocab_splits(T: int, V: int, n_sm: int, inst: str = "wgmma",
                 teacher: bool = False):
    """(splits, tiles per split) of ``inst``'s grid of (row tile, vocab
    split) blocks: at most its blocks an SM on ``n_sm`` SMs, at least
    one split, every split non-empty."""
    tile_t, tile_v = tile_shape(inst, teacher)
    n_rt = -(-T // tile_t)
    n_vt = -(-V // tile_v)
    ns = max(1, min(n_vt, TILES[inst][2] * n_sm // n_rt))
    tps = -(-n_vt // ns)
    return -(-n_vt // tps), tps


def instance(hs, ws, ht=None, wt=None) -> str:
    """The instance a CUDA launch on these (contiguous) tensors takes:
    ``wgmma`` for bf16 whose row lengths (Ds, Dt, V) are multiples of 8
    and whose bases are 16-byte aligned (TMA's strides and addresses),
    ``general`` for any other bf16, ``f32`` for f32."""
    if hs.dtype == torch.float32:
        return "f32"
    ts = [hs, ws] if ht is None else [hs, ws, ht, wt]
    if all(t.shape[1] % 8 == 0 and t.data_ptr() % 16 == 0 for t in ts):
        return "wgmma"
    return "general"


def _check_inputs(hs, ws, ht, wt, labels):
    if hs.dim() != 2 or ws.dim() != 2 or hs.shape[1] != ws.shape[0]:
        raise ValueError(f"expected hs (T, D) and ws (D, V), got "
                         f"{tuple(hs.shape)}, {tuple(ws.shape)}")
    if labels.shape != (hs.shape[0],) or labels.is_floating_point():
        raise ValueError(f"expected integer labels ({hs.shape[0]},), got "
                         f"{labels.dtype}{tuple(labels.shape)}")
    ts = [hs, ws, labels]
    if (ht is None) != (wt is None):
        raise ValueError("pass both ht and wt, or neither")
    if ht is not None:
        if ht.dim() != 2 or wt.dim() != 2 or ht.shape[0] != hs.shape[0] \
                or ht.shape[1] != wt.shape[0] or wt.shape[1] != ws.shape[1]:
            raise ValueError(f"expected ht (T, Dt) and wt (Dt, V) beside hs "
                             f"{tuple(hs.shape)}, ws {tuple(ws.shape)}; got "
                             f"{tuple(ht.shape)}, {tuple(wt.shape)}")
        if ht.dtype != hs.dtype or wt.dtype != ws.dtype:
            raise TypeError("teacher and student tensors must share a dtype")
        ts += [ht, wt]
    if hs.dtype != ws.dtype:
        raise TypeError(f"hs and ws must share a dtype, got {hs.dtype}, "
                        f"{ws.dtype}")
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must lie on one device")


def kd_loss_fwd(hs, ws, ht, wt, labels, *, tau: float = 1.0,
                softcap_s: float = 0.0, softcap_t: float = 0.0):
    """hs (T, Ds), ws (Ds, V), ht (T, Dt) | None, wt (Dt, V) | None,
    labels (T,) -> (ce, kl, correct), each f32 (T,); kl is 0 without a
    teacher.  No gradient: ``ce_from_hidden`` / ``ce_kl_from_hidden``
    carry it."""
    global LAUNCHES
    _check_inputs(hs, ws, ht, wt, labels)
    if hs.device.type == "cpu":
        if ht is None:
            ce, cor = ce_ref(hs, ws, labels, softcap=softcap_s)
            return ce, torch.zeros_like(ce), cor
        return ce_kl_ref(hs, ws, ht, wt, labels, tau=tau,
                         softcap_s=softcap_s, softcap_t=softcap_t)
    if hs.device.type != "cuda":
        raise ValueError(f"kd_loss_fwd: unsupported device {hs.device}")
    if hs.dtype not in _DTYPES:
        raise TypeError(f"kd_loss_fwd: dtype {hs.dtype} not in "
                        f"{list(_DTYPES)}")
    if labels.dtype != torch.int32:
        raise TypeError(f"kd_loss_fwd: labels must be int32, got "
                        f"{labels.dtype}")
    if not tau > 0:
        raise ValueError(f"kd_loss_fwd: tau must be positive, got {tau}")
    T, Ds = hs.shape
    V = ws.shape[1]
    with_teacher = ht is not None
    hs, ws, labels = hs.contiguous(), ws.contiguous(), labels.contiguous()
    if with_teacher:
        ht, wt = ht.contiguous(), wt.contiguous()
    Dt = ht.shape[1] if with_teacher else 0
    fn, fn_wgmma, nstat, err_str = _kernel()
    inst = instance(hs, ws, ht, wt)
    n_sm = torch.cuda.get_device_properties(hs.device).multi_processor_count
    ns, tps = vocab_splits(T, V, n_sm, inst, with_teacher)
    f32 = dict(dtype=torch.float32, device=hs.device)
    ce, kl, cor = (torch.empty(T, **f32) for _ in range(3))
    part = torch.empty(nstat * ns * T, **f32)
    part_arg = torch.empty(ns * T, dtype=torch.int32, device=hs.device)
    ptrs = (hs.data_ptr(), ws.data_ptr(),
            ht.data_ptr() if with_teacher else None,
            wt.data_ptr() if with_teacher else None,
            labels.data_ptr(), ce.data_ptr(), kl.data_ptr(), cor.data_ptr(),
            part.data_ptr(), part_arg.data_ptr())
    rest = (T, Ds, Dt, V, ns, tps, int(with_teacher), float(tau),
            float(softcap_s), float(softcap_t),
            torch.cuda.current_stream(hs.device).cuda_stream)
    if inst == "wgmma":
        err = fn_wgmma(*ptrs, *rest)
    else:
        err = fn(*ptrs, _DTYPES[hs.dtype], *rest)
    _build.check(err, f"kd_loss_fwd ({inst})", err_str)
    LAUNCHES += 1
    LAUNCHES_BY_INSTANCE[inst] += 1
    LAUNCHES_BY_MODE["kd" if with_teacher else "ce"] += 1
    return ce, kl, cor


# ---------------------------------------------------------------------------
# backward: vocab-blocked, two passes, f32 (CPU and card alike)
# ---------------------------------------------------------------------------

def _softcap_and_grad(z, cap):
    if not cap:
        return z, None
    t = torch.tanh(z / cap)
    return t * cap, 1.0 - t * t


def _lse_stats(hf, w, *, softcap, block_v, tau: float = 1.0):
    """Streaming logsumexp of softcap(hf @ w) / τ over vocab blocks."""
    T, V = hf.shape[0], w.shape[1]
    m = torch.full((T,), -1e30, dtype=torch.float32, device=hf.device)
    l = torch.zeros((T,), dtype=torch.float32, device=hf.device)
    for v0 in range(0, V, block_v):
        z, _ = _softcap_and_grad(hf @ w[:, v0:v0 + block_v].float(), softcap)
        z = z / tau
        m_new = torch.maximum(m, z.amax(-1))
        l = l * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(-1)
        m = m_new
    return m, l


def _blocked_bwd(hs, ws, ht, wt, labels, dce, dkl, *, tau, softcap_s,
                 softcap_t, block_v):
    """(dhs, dws) of Σ ce·dce (+ Σ kl·dkl) through the vocab blocks."""
    hsf = hs.float()
    V = ws.shape[1]
    kw = dict(block_v=block_v)
    m_s, l_s = _lse_stats(hsf, ws, softcap=softcap_s, **kw)
    kd = ht is not None
    if kd:
        htf = ht.float()
        m_st, l_st = _lse_stats(hsf, ws, softcap=softcap_s, tau=tau, **kw)
        m_tt, l_tt = _lse_stats(htf, wt, softcap=softcap_t, tau=tau, **kw)
    dhs = torch.zeros_like(hsf)
    dws = torch.empty((ws.shape[0], V), dtype=torch.float32,
                      device=hs.device)
    lab = labels.long()[:, None]
    for v0 in range(0, V, block_v):
        wb = ws[:, v0:v0 + block_v].float()
        z, dcap = _softcap_and_grad(hsf @ wb, softcap_s)
        vids = torch.arange(v0, v0 + wb.shape[1], device=hs.device)
        onehot = (vids[None, :] == lab).float()
        p_raw = torch.exp(z - m_s[:, None]) / l_s[:, None]
        dz = (p_raw - onehot) * dce[:, None]
        if kd:
            zt, _ = _softcap_and_grad(
                htf @ wt[:, v0:v0 + block_v].float(), softcap_t)
            p_st = torch.exp(z / tau - m_st[:, None]) / l_st[:, None]
            p_tt = torch.exp(zt / tau - m_tt[:, None]) / l_tt[:, None]
            dz = dz + tau * (p_st - p_tt) * dkl[:, None]
        if dcap is not None:
            dz = dz * dcap
        dhs += dz @ wb.T
        dws[:, v0:v0 + wb.shape[1]] = hsf.T @ dz
    return dhs.to(hs.dtype), dws.to(ws.dtype)


class _CE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs, ws, labels, softcap, block_v):
        ce, _, cor = kd_loss_fwd(hs, ws, None, None, labels,
                                 softcap_s=softcap)
        ctx.save_for_backward(hs, ws, labels)
        ctx.softcap, ctx.block_v = softcap, block_v
        ctx.mark_non_differentiable(cor)
        return ce, cor

    @staticmethod
    def backward(ctx, dce, _dcor):
        hs, ws, labels = ctx.saved_tensors
        dhs, dws = _blocked_bwd(hs, ws, None, None, labels, dce, None,
                                tau=1.0, softcap_s=ctx.softcap,
                                softcap_t=0.0, block_v=ctx.block_v)
        return dhs, dws, None, None, None


class _CEKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hs, ws, ht, wt, labels, tau, softcap_s, softcap_t,
                block_v):
        ce, kl, cor = kd_loss_fwd(hs, ws, ht, wt, labels, tau=tau,
                                  softcap_s=softcap_s, softcap_t=softcap_t)
        ctx.save_for_backward(hs, ws, ht, wt, labels)
        ctx.kw = dict(tau=tau, softcap_s=softcap_s, softcap_t=softcap_t,
                      block_v=block_v)
        ctx.mark_non_differentiable(cor)
        return ce, kl, cor

    @staticmethod
    def backward(ctx, dce, dkl, _dcor):
        hs, ws, ht, wt, labels = ctx.saved_tensors
        dhs, dws = _blocked_bwd(hs, ws, ht, wt, labels, dce, dkl, **ctx.kw)
        # the teacher is frozen (Eq. 10): no gradient for ht / wt
        return dhs, dws, None, None, None, None, None, None, None


def ce_from_hidden(hh, w, labels, *, softcap: float = 0.0,
                   block_v: int = 512):
    """hh: (..., D), w: (D, V), labels: (...) -> (nll (...), correct (...))."""
    shape = labels.shape
    ce, cor = _CE.apply(hh.reshape(-1, hh.shape[-1]), w, labels.reshape(-1),
                        float(softcap), block_v)
    return ce.reshape(shape), cor.reshape(shape)


def ce_kl_from_hidden(hh_s, w_s, hh_t, w_t, labels, *, tau: float = 1.0,
                      softcap_s: float = 0.0, softcap_t: float = 0.0,
                      block_v: int = 512):
    """(..., Ds) student + (..., Dt) teacher hiddens -> (ce, kl, correct)."""
    shape = labels.shape
    ce, kl, cor = _CEKL.apply(
        hh_s.reshape(-1, hh_s.shape[-1]), w_s,
        hh_t.reshape(-1, hh_t.shape[-1]), w_t, labels.reshape(-1),
        float(tau), float(softcap_s), float(softcap_t), block_v)
    return ce.reshape(shape), kl.reshape(shape), cor.reshape(shape)
