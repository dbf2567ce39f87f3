"""Global MoE model merge (paper §IV.D, Fig. 6).

Counterpart of ``repro.core.merge``.  Merge rule:

* expert e of every MoE block copies the FFN of base model e mod K
  (Eq. 12; round-robin when there are fewer base models than experts);
* embedding, self-attention, output head and norms are the element-wise
  average over the K base models (Eq. 13);
* the shared experts tile the average FFN, ``wo`` divided by their
  number, so together they compute the average FFN;
* the router keeps its fresh initialisation; it is trained in Phase III.

The MoE config's ``moe_d_ff`` must equal the base models' ``d_ff`` (the
upcycling invariant, Fig. 1): ``base_config_of`` gives that base config.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.utils.pytree import tree_average, tree_map


def base_config_of(moe_cfg: ModelConfig, name: str = "") -> ModelConfig:
    """The dense 'MoE base model' config this MoE upcycles from (Fig. 1)."""
    return moe_cfg.replace(
        name=name or (moe_cfg.name + "-base"),
        arch_type="dense",
        n_experts=0, n_shared_experts=0, top_k=0, moe_d_ff=0,
        first_dense_layers=0, n_mtp=0,
        d_ff=moe_cfg.moe_d_ff or moe_cfg.d_ff,
    )


_AVG_TOP = ("embed", "final_norm", "lm_head")
_AVG_BLOCK = ("ln1", "ln2", "ln1_post", "ln2_post", "attn")


def _cast_copy(a, m):
    # a fresh tensor: tuning updates the merged model in place, and must
    # not write through into a base model
    return a.to(dtype=m.dtype, copy=True)


def merge_into_moe(generator, moe_cfg: ModelConfig,
                   base_params_list: Sequence, *, params=None) -> dict:
    """Builds global MoE params from K dense base models (Fig. 6).

    The MoE's own parameters (the router, and everything the merge
    overwrites) are drawn from ``generator`` (a seeded
    ``torch.Generator`` on the target device), or copied from
    ``params`` (e.g. the reference's init, converted), which stays as it
    is.
    """
    E = moe_cfg.n_experts
    K = len(base_params_list)
    if K < 1:
        raise ValueError("merge_into_moe needs at least one base model")
    moe_params = (M.init_params(moe_cfg, generator=generator)
                  if params is None else tree_map(torch.clone, params))
    avg = tree_average(list(base_params_list))

    # ---- top-level shared layers: average (Eq. 13) ----------------------
    for name in _AVG_TOP:
        if name in moe_params and name in avg:
            moe_params[name] = tree_map(_cast_copy, avg[name],
                                        moe_params[name])

    # ---- per block: average attention/norms, copy expert FFNs (Eq. 12) --
    blocks = moe_params["blocks"]
    asub = avg["blocks"]["sub0"]
    for i in range(moe_cfg.layers_per_scan):
        sub = blocks[f"sub{i}"]
        for name in _AVG_BLOCK:
            if name in sub and name in asub:
                sub[name] = tree_map(_cast_copy, asub[name], sub[name])
        # experts: (nG, E, D, F) <- base e mod K (nG, D, F)
        for wname in ("wi_gate", "wi_up", "wo"):
            dt = sub["moe"][wname].dtype
            sub["moe"][wname] = torch.stack(
                [base_params_list[e % K]["blocks"]["sub0"]["mlp"][wname]
                 .to(dt) for e in range(E)], dim=1)
        # shared experts: tile the average FFN
        if moe_cfg.n_shared_experts and "shared" in sub["moe"]:
            n_sh = moe_cfg.n_shared_experts
            am = asub["mlp"]
            sh = sub["moe"]["shared"]
            dt = M._dtype(moe_cfg)
            sh["wi_gate"] = am["wi_gate"].repeat(1, 1, n_sh).to(dt)
            sh["wi_up"] = am["wi_up"].repeat(1, 1, n_sh).to(dt)
            sh["wo"] = (am["wo"].repeat(1, n_sh, 1) / n_sh).to(dt)
    return moe_params
