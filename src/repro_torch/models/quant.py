"""Storage dtype policies for decode caches.

Counterpart of the cache half of ``repro.models.quant`` (the optimizer
``MomentPolicy`` is not ported yet).  A ``CachePolicy`` names the storage
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
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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
