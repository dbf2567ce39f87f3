"""Local-knowledge proxy models (paper §IV.B, Fig. 4).

Counterpart of ``repro.core.proxy``.  Within each knowledge domain C_i
the uploaded on-device LLMs are element-wise weight-averaged into a
proxy model m̄_i that stands in for the whole cluster during
distillation — this caps the number of teacher forward passes at K
regardless of the device count N (the paper's scalability answer,
Challenge 2).  ``tree_average`` sums in f32 in member order and casts
back, as the reference does, so a proxy is bit-identical to the
reference's in f32 and in bf16.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.core.clustering import ClusterResult
from repro_torch.utils.pytree import tree_average


def build_proxies(device_params: Sequence, clusters: ClusterResult,
                  device_arch: Sequence[int]) -> List[Dict]:
    """Returns one proxy per non-empty cluster:
    {"params", "members", "arch", "cluster"} (clusters must be
    arch-consistent; a mixed one raises ``ValueError``).  A one-member
    cluster's proxy is that member's parameters, not a copy."""
    proxies = []
    for j, members in enumerate(clusters.members):
        if not members:
            continue
        archs = {int(device_arch[m]) for m in members}
        if len(archs) != 1:
            raise ValueError(f"cluster {j} mixes architectures {archs}")
        proxies.append({
            "params": tree_average([device_params[m] for m in members]),
            "members": members,
            "arch": archs.pop(),
            "cluster": j,
        })
    return proxies
