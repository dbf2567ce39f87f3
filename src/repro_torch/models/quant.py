"""Storage dtype policies for decode caches and optimizer moments.

Counterpart of ``repro.models.quant``.  A ``CachePolicy`` names the storage
dtype of the attention KV leaves in a decode cache (contiguous or
paged).  Quantized policies (int8 / fp8 e4m3) store each KV row with a
per-(position, kv-head) float32 scale computed at WRITE time — amax over
the leaf's trailing feature axis — so every row dequantizes as
``q.float() * scale``.  The scale rides the cache as a sibling leaf keyed
``<leaf>_scale`` (``k`` -> ``k_scale``): the structure carries the
policy, and ``policy_of`` recovers it from any cache.

Scales are per position, not per block: a block's bytes are then a pure
function of its token content, which keeps the paged allocator's
content-keyed prefix sharing sound.

``bf16`` / ``fp32`` policies only change the leaf dtype and add no
scale leaves; ``""`` (default) keeps the parameters' dtype.

Quantize rounds exactly as the reference: ``x / scale`` (a division, not
a multiply by the reciprocal), half-to-even rounding for int8, a
round-to-nearest-even cast for fp8, so codes and scales are bit-equal.

``MomentPolicy`` is the optimizer-state analogue (see
``repro_torch.optim.adamw``): the first AdamW moment in bf16, the second
in bf16 or in int8 with one per-tensor float32 scale, on a codebook
log-spaced in the sqrt domain (``quantize_v``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

# symmetric quantization ranges: int8 uses the full signed byte minus
# the asymmetric -128; fp8 e4m3 (no infinities) saturates at +-448
QMAX = {"int8": 127.0, "fp8": 448.0}
KV_DTYPES = ("", "fp32", "bf16", "fp8", "int8")
FP8 = torch.float8_e4m3fn
_STORAGE = {"fp32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8, "fp8": FP8}
# guard against zero rows: amax 0 would make the scale 0 and the
# quantize-time division 0/0
_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """KV-cache storage policy.  ``kv_dtype`` in ``KV_DTYPES``."""
    kv_dtype: str = ""

    def __post_init__(self):
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype {self.kv_dtype!r} not in {KV_DTYPES}")

    @property
    def quantized(self) -> bool:
        return self.kv_dtype in ("int8", "fp8")

    @property
    def qmax(self) -> float:
        return QMAX[self.kv_dtype]

    def storage_dtype(self, param_dtype: torch.dtype) -> torch.dtype:
        """The dtype KV leaves are allocated at (param dtype when '')."""
        if not self.kv_dtype:
            return param_dtype
        return _STORAGE[self.kv_dtype]


def quantize(x, kv_dtype: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` along its LAST axis.

    Returns ``(q, scale)`` with ``q.shape == x.shape`` at the storage
    dtype and ``scale.shape == x.shape[:-1]`` in float32, such that
    ``dequantize(q, scale) ~= x``.
    """
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.clamp_min(amax, _EPS) / QMAX[kv_dtype]
    q = xf / scale[..., None]
    if kv_dtype == "int8":
        q = torch.clamp(torch.round(q), -127.0, 127.0).to(torch.int8)
    else:
        q = torch.clamp(q, -448.0, 448.0).to(FP8)
    return q, scale


def dequantize(q, scale, dtype=torch.float32):
    """Inverse of ``quantize``: per-row rescale back to ``dtype``."""
    return (q.float() * scale[..., None].float()).to(dtype)


def kv_dtype_of_leaf(leaf) -> str:
    """The quantized policy a DATA leaf's dtype implies ('' if none)."""
    if leaf.dtype == torch.int8:
        return "int8"
    if leaf.dtype == FP8:
        return "fp8"
    return ""


def is_scale_key(key: str) -> bool:
    return key.endswith("_scale")


def scale_name(key: str) -> str:
    return key + "_scale"


def policy_of(cache) -> CachePolicy:
    """Recover the CachePolicy from a cache's structure: quantized caches
    carry ``<leaf>_scale`` siblings whose data leaf's dtype names the
    policy.  Caches without scale leaves map to the default policy (which
    also covers bf16/fp32: their leaves are written with ``.to``)."""
    if not isinstance(cache, dict):
        return CachePolicy()
    for key, val in cache.items():
        if isinstance(val, dict):
            pol = policy_of(val)
            if pol.quantized:
                return pol
        elif is_scale_key(key):
            kv = kv_dtype_of_leaf(cache[key[:-len("_scale")]])
            if kv:
                return CachePolicy(kv)
    return CachePolicy()


# ---------------------------------------------------------------------------
# optimizer-state policy (used by repro_torch.optim.adamw)
# ---------------------------------------------------------------------------

MOMENT_DTYPES = ("", "fp32", "bf16", "int8")
_MOMENT_STORAGE = {"": torch.float32, "fp32": torch.float32,
                   "bf16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class MomentPolicy:
    """AdamW moment storage policy.

    ``m_dtype`` applies to the first moment (fp32 or bf16: int8 is not
    offered, a sign-sensitive EMA of gradients degrades too fast).
    ``v_dtype`` applies to the second moment; ``int8`` stores v with ONE
    per-tensor float32 scale leaf (``quantize_v``).
    """
    m_dtype: str = ""
    v_dtype: str = ""

    def __post_init__(self):
        if self.m_dtype not in ("", "fp32", "bf16"):
            raise ValueError(f"m_dtype {self.m_dtype!r} invalid")
        if self.v_dtype not in MOMENT_DTYPES:
            raise ValueError(f"v_dtype {self.v_dtype!r} invalid")

    @property
    def v_quantized(self) -> bool:
        return self.v_dtype == "int8"

    def m_storage(self) -> torch.dtype:
        return _MOMENT_STORAGE[self.m_dtype]

    def v_storage(self) -> torch.dtype:
        if self.v_quantized:
            return torch.int8
        return _MOMENT_STORAGE[self.v_dtype]


# log-level span of the int8 v codebook: level 1 sits 6 decades of
# sqrt(v) below the per-tensor amax (level 127); ~11% relative
# resolution per level on sqrt(v), the quantity the Adam update
# consumes.  Linear levels would round small v entries to 0 and turn
# ``m / (sqrt(v) + eps)`` into a giant sign-SGD step.
_V_ALPHA = 13.815511  # ln(1e6)


def quantize_v(v_f32, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 quantization of a (non-negative) second moment.

    Codes are log-spaced in the sqrt domain: code q > 0 decodes to
    ``scale * exp(_V_ALPHA * (q - 127) / 127)`` of sqrt(v) (code 127 =
    the tensor's amax, code 1 ~ amax * 1e-6); code 0 is exact zero, so a
    fresh state round-trips exactly.  Entries below the codebook floor
    saturate UP to code 1: overestimating a tiny v underestimates the
    step.  Returns ``(q, scale)`` with a 0-d float32 ``scale``.  The f32
    ops are the reference's, in its order; ``log`` may differ from XLA's
    by an ulp, so a code at a level boundary can differ by one.
    ``group``: ``v_f32`` is this rank's block of a tensor cut over that
    process group, and the scale is the whole tensor's (the largest
    value over the group).
    """
    r = torch.sqrt(v_f32)
    amax = torch.max(r)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax, _EPS)
    lvl = 127.0 + torch.log(torch.clamp_min(r, _EPS) / scale) * (
        127.0 / _V_ALPHA)
    q = torch.clamp(torch.round(lvl), 1.0, 127.0)
    q = torch.where(r > 0, q, 0.0).to(torch.int8)
    return q, scale.float()


def dequantize_v(q, scale) -> torch.Tensor:
    """Inverse of ``quantize_v``: f32 v, exact zeros where the code is 0."""
    qf = q.float()
    r = scale.float() * torch.exp(_V_ALPHA * (qf - 127.0) / 127.0)
    return torch.where(q > 0, torch.square(r), 0.0)
