"""Plain PyTorch version of the fused gather/scatter-add token movement
(``csrc/moe_dispatch.cu``), a counterpart of
``repro.kernels.moe_dispatch.ref``."""
from __future__ import annotations

import torch


def gather_scatter_add_ref(src, src_rows, dst_rows, scale, n_out: int):
    """out[dst_rows[i]] += scale[i] * src[src_rows[i]] in f32, returned in
    ``src.dtype``.  On the CPU ``index_add_`` adds the rows in order, as
    the TPU kernel walks them."""
    rows = scale.float()[:, None] * src.float()[src_rows.long()]
    out = torch.zeros((n_out, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    out.index_add_(0, dst_rows.long(), rows)
    return out.to(src.dtype)
