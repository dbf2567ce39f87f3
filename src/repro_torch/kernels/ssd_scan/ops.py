"""Public wrapper of the SSD chunked-scan kernel (Mamba-2 prefill).

Replaces ``repro.kernels.ssd_scan.kernel.ssd_scan_bh`` (the Pallas TPU
kernel ``_ssd_kernel``) behind the signature of
``repro.kernels.ssd_scan.ops.ssd``, in the model's layout.  The CUDA
source is ``csrc/ssd_scan.cu``; its header says what bounds it on the
H100 (bytes: at the ssm prefill's shape about 20 MB against 5 GFLOP
counted once at the bf16 tensor-core rate) and how the design meets it.

The kernel reads x, B and C through their strides, so the model hands it
views of its conv output, and B/C once per group: ``Bh``/``Ch`` may be
(B, S, H, N) or (B, S, G, N) with G dividing H (head h reads group
h // (H / G)), where the reference repeats each group to H heads first.

``instance`` picks the kernel's instance from dtypes, shapes, strides
and pointers alone, before the launch:

- ``tc``: bf16 with P and N multiples of 16, N <= ``TC_MAX_N``, every
  stride of x, B and C a multiple of 8 elements and their bases 16-byte
  aligned (the model's views of its conv output qualify).  C·Bᵀ, the
  intra-chunk product, the carried-state term and the state update run
  on the tensor cores (``mma.sync``, ``cp.async``); the f32 operands W,
  h_in and B∘w enter them as two bf16 terms each;
- ``general``: any other bf16, f32 FMAs on the CUDA cores;
- ``f32``: f32, the same CUDA-core kernel in f32.

A CPU tensor runs the plain version in ``ref.py``; a CUDA tensor
launches the kernel or raises — nothing falls back.  ``LAUNCHES`` counts
the calls that launch the kernel (three CUDA launches on one stream
each), ``LAUNCHES_BY_INSTANCE`` the same calls by instance, and
``LAUNCHES_H0`` those of them that start from a carried ``init_state``
(chunked admission), so a run can
show the path went through it.

Under autograd a CUDA call runs inside ``_SSD``, a
``torch.autograd.Function``: its forward is the kernel, and it saves the
inputs.  Its backward is ``ssd_bwd``, which recomputes the plain
version ``ref.ssd_scan_ref`` on the saved inputs and differentiates it
with the cotangents of y and of the final state, as the reference
trains through XLA's autodiff of its ``ssd_chunked`` (its Pallas scan
has no VJP).  The plain version's group expansion sums the gradients of
B and C over the heads of each group, and its ``cumsum`` carries the
cotangent of dt·A back through the chunk.  There is no backward kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {"tc": 0, "general": 0, "f32": 0}
LAUNCHES_H0 = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 1024
TC_MAX_N = 256   # csrc/ssd_scan.cu: the tc instance's shared tiles
_fn = None


class _Args(ctypes.Structure):
    """Mirror of ``SsdArgs`` in ``csrc/ssd_scan.cu`` (strides in
    elements)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "dt", "A", "b", "c", "h0", "y", "hout", "hbuf",
                  "clast", "hin_hi", "hin_lo", "cumdt")]
                + [(n, ctypes.c_int) for n in
                   ("batch", "S", "H", "G", "P", "N", "Q", "nC", "dtype")]
                + [(n, ctypes.c_longlong) for n in
                   ("xs_b", "xs_s", "xs_h", "ds_b", "ds_s", "ds_h",
                    "bs_b", "bs_s", "bs_g", "cs_b", "cs_s", "cs_g")])


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.library("ssd_scan")
        fns = {}
        for inst, name in (("cuda_cores", "ssd_scan_fwd"),
                           ("tc", "ssd_scan_fwd_tc")):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[inst] = fn
        lib.ssd_scan_tc_smem.argtypes = [ctypes.c_int] * 3
        lib.ssd_scan_tc_smem.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fn = (fns, lib.ssd_scan_tc_smem, lib.ssd_scan_error_string)
    return _fn


def tc_smem_bytes(chunk: int, N: int):
    """(chunk-state, outputs) dynamic shared memory bytes of the tc
    instance's blocks at this chunk and N, as the CUDA source has them."""
    _, smem, _ = _kernel()
    return smem(chunk, N, 0), smem(chunk, N, 1)


def instance(xh, Bh, Ch) -> str:
    """The instance a CUDA launch on these tensors takes: ``tc`` for bf16
    with P and N multiples of 16, N <= TC_MAX_N, and every stride of x, B
    and C a multiple of 8 elements with 16-byte-aligned bases (cp.async's
    16-byte copies), ``general`` for any other bf16, ``f32`` for f32."""
    if xh.dtype == torch.float32:
        return "f32"
    P, N = xh.shape[3], Bh.shape[3]
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % 8 == 0 for st in t.stride()[:3])
                  for t in (xh, Bh, Ch))
    if P % 16 == 0 and N % 16 == 0 and N <= TC_MAX_N and aligned:
        return "tc"
    return "general"


def _check_inputs(xh, dt, A, Bh, Ch, init_state):
    if xh.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bh.dim() != 4 \
            or Bh.shape != Ch.shape:
        raise ValueError(
            f"expected xh (B,S,H,P), dt (B,S,H), A (H,) and Bh/Ch (B,S,G,N) "
            f"of one shape, got {tuple(xh.shape)}, {tuple(dt.shape)}, "
            f"{tuple(A.shape)}, {tuple(Bh.shape)}, {tuple(Ch.shape)}")
    Bsz, S, H, P = xh.shape
    G, N = Bh.shape[2], Bh.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) \
            or tuple(Bh.shape[:2]) != (Bsz, S) or H % G:
        raise ValueError(
            f"shapes disagree: xh {tuple(xh.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, Bh/Ch {tuple(Bh.shape)} (G must divide H)")
    if init_state is not None and tuple(init_state.shape) != (Bsz, H, P, N):
        raise ValueError(f"init_state {tuple(init_state.shape)} != "
                         f"{(Bsz, H, P, N)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 or (
            init_state is not None and init_state.dtype != torch.float32):
        raise TypeError("dt, A and init_state must be float32")
    if not (xh.dtype == Bh.dtype == Ch.dtype) or xh.dtype not in _DTYPES:
        raise TypeError(f"xh, Bh and Ch must share a float32 or bfloat16 "
                        f"dtype, got {xh.dtype}, {Bh.dtype}, {Ch.dtype}")
    ts = [t for t in (xh, dt, A, Bh, Ch, init_state) if t is not None]
    if len({t.device for t in ts}) != 1:
        raise ValueError("all inputs must lie on one device")
    return ts


def ssd(xh, dt, A, Bh, Ch, *, chunk: int = 128, init_state=None):
    """Model-layer layout: xh (B, S, H, P); dt (B, S, H) f32 (softplus'd);
    A (H,) f32, negative; Bh/Ch (B, S, H, N) or (B, S, G, N);
    init_state (B, H, P, N) f32 or None.  Returns (y (B, S, H, P) in xh's
    dtype, final state (B, H, P, N) f32), as
    ``repro.kernels.ssd_scan.ops.ssd``."""
    ts = _check_inputs(xh, dt, A, Bh, Ch, init_state)
    if xh.device.type == "cpu":
        return ssd_scan_ref(xh, dt, A, Bh, Ch, chunk=chunk,
                            init_state=init_state)
    if xh.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {xh.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return _SSD.apply(xh, dt, A, Bh, Ch, init_state, int(chunk))
    return _ssd_fwd(xh, dt, A, Bh, Ch, chunk=chunk, init_state=init_state)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dt, A, Bh, Ch, init_state, chunk):
        ctx.save_for_backward(xh, dt, A, Bh, Ch, init_state)
        ctx.chunk = chunk
        return _ssd_fwd(xh, dt, A, Bh, Ch, chunk=chunk,
                        init_state=init_state)

    @staticmethod
    def backward(ctx, dy, dh_final):
        return (*ssd_bwd(ctx.saved_tensors, dy, dh_final, chunk=ctx.chunk),
                None)


def ssd_bwd(saved, dy, dh_final, *, chunk: int):
    """Gradients of ``ssd`` with respect to (xh, dt, A, Bh, Ch,
    init_state), each in its input's dtype and shape (None for an absent
    ``init_state``): the plain version recomputed on ``saved`` (those six
    inputs) and differentiated with the cotangents ``dy`` of y and
    ``dh_final`` of the final state (None: zero).  Bh/Ch given per group
    (B, S, G, N) get the sum over each group's heads."""
    ins = [None if t is None else t.detach().requires_grad_(True)
           for t in saved]
    xh, dt, A, Bh, Ch, h0 = ins
    with torch.enable_grad():
        y, h = ssd_scan_ref(xh, dt, A, Bh, Ch, chunk=chunk, init_state=h0)
    outs, cots = [y], [dy]
    if dh_final is not None:
        outs.append(h)
        cots.append(dh_final)
    wrt = [t for t in ins if t is not None]
    grads = iter(torch.autograd.grad(outs, wrt, cots))
    return tuple(None if t is None else next(grads) for t in ins)


def _ssd_fwd(xh, dt, A, Bh, Ch, *, chunk, init_state):
    """The kernel launch (CUDA tensors)."""
    global LAUNCHES, LAUNCHES_H0
    for name, t in (("xh", xh), ("Bh", Bh), ("Ch", Ch)):
        if t.stride(3) != 1:
            raise ValueError(f"ssd: {name} needs unit stride along its last "
                             f"axis, got strides {t.stride()}")
    if not A.is_contiguous() or (init_state is not None
                                 and not init_state.is_contiguous()):
        raise ValueError("ssd: A and init_state must be contiguous")
    Bsz, S, H, P = xh.shape
    G, N = Bh.shape[2], Bh.shape[3]
    Q = min(int(chunk), S)
    if not 1 <= Q <= MAX_CHUNK:
        raise ValueError(f"ssd: chunk {Q} not in [1, {MAX_CHUNK}]")
    nC = -(-S // Q)
    dev = xh.device
    inst = instance(xh, Bh, Ch)
    y = torch.empty((Bsz, S, H, P), dtype=xh.dtype, device=dev)
    hout = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    # chunk states; in general/f32 then in place the state entering each
    # chunk, in tc that state as two bf16 planes (hi, lo)
    hbuf = torch.empty((Bsz * H, nC, P, N), dtype=torch.float32, device=dev)
    clast = torch.empty((Bsz * H, nC), dtype=torch.float32, device=dev)
    tc = inst == "tc"
    planes = (torch.empty((2, Bsz * H, nC, P, N), dtype=torch.bfloat16,
                          device=dev) if tc else None)
    # tc: each chunk's cumsum and dt, rows padded to 4 floats (16 bytes)
    cumdt = (torch.empty((Bsz * H, nC, 2, -(-Q // 4) * 4),
                         dtype=torch.float32, device=dev) if tc else None)
    a = _Args(xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bh.data_ptr(),
              Ch.data_ptr(),
              0 if init_state is None else init_state.data_ptr(),
              y.data_ptr(), hout.data_ptr(), hbuf.data_ptr(),
              clast.data_ptr(),
              0 if planes is None else planes[0].data_ptr(),
              0 if planes is None else planes[1].data_ptr(),
              0 if cumdt is None else cumdt.data_ptr(),
              Bsz, S, H, G, P, N, Q, nC,
              _DTYPES[xh.dtype],
              *xh.stride()[:3], *dt.stride(), *Bh.stride()[:3],
              *Ch.stride()[:3])
    fns, _, err_str = _kernel()
    fn = fns["tc" if tc else "cuda_cores"]
    err = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"ssd ({inst})", err_str)
    LAUNCHES += 1
    LAUNCHES_BY_INSTANCE[inst] += 1
    if init_state is not None:
        LAUNCHES_H0 += 1
    return y, hout
