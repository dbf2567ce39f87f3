"""Cross-architecture knowledge distillation (paper §IV.C).

Counterpart of ``repro.core.distill``.  ``L_KD = L_CE + α·L_FM + β·L_KL``
(Eq. 11):

* L_CE — the student's own autoregressive loss on (public) server data;
* L_FM — VAA feature matching across J representation stages (Eq. 9);
* L_KL — KL(teacher ‖ student) over next-token distributions (Eq. 10),
  computed sequence-chunked so (B, S, V) teacher and student logits are
  never materialised at once.  With ``use_kernels`` each chunk goes
  through the fused kd_loss kernel in KD mode
  (``kernels/kd_loss/ops.py::ce_kl_from_hidden``), which streams vocab
  tiles of both heads; else through the reference's plain branch.

The teacher runs once per batch under ``torch.no_grad()``; its stage
features and final hidden states are reused by the student update.  The
reference compiles the epoch into one scanned program; the port runs the
same steps eagerly (``optim.loops.scan_epoch``), updating the student
and VAA parameters in place.

``mesh`` (``launch/mesh.py``) reaches ``M.backbone`` of the teacher and
the student, as in the reference, where only a MoE's experts take a
path of their own on a mesh (``models/moe.py``; an MoE student then
holds the rank's block of its experts, ``shard_experts``, and the clip
sums the blocks over their ranks).  The teacher and Phase II's student
base are dense, so on this layout the mesh changes nothing there: the
dense weights stay whole on every rank.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import vaa as vaa_mod
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import scan_epoch
from repro_torch.utils.pytree import tree_leaves, tree_unflatten_like


# ---------------------------------------------------------------------------
# stage selection
# ---------------------------------------------------------------------------

def select_stages(stages, n_stages: int) -> List[torch.Tensor]:
    """(nG, B, S, D) per-group outputs -> J evenly spaced stage tensors
    (the last repeated when the model has fewer groups than J)."""
    nG = stages.shape[0]
    idx = np.unique(np.round(np.linspace(1, nG, n_stages)).astype(int) - 1)
    while len(idx) < n_stages:  # tiny models: repeat last stage
        idx = np.append(idx, idx[-1])
    return [stages[int(i)] for i in idx]


@torch.no_grad()
def teacher_forward(t_params, t_cfg: ModelConfig, batch, *, n_stages: int,
                    mesh=None):
    """Frozen teacher pass.  Returns {"h": final hidden, "stages": J
    stage tensors}, none of which carries a graph.  Without autograd the
    model's remat wrapper runs each group once (no checkpoint)."""
    h, _, _, stages = M.backbone(t_params, t_cfg, batch, collect_stages=True,
                                 mesh=mesh)
    return {"h": h, "stages": select_stages(stages, n_stages)}


# ---------------------------------------------------------------------------
# chunked CE + KL
# ---------------------------------------------------------------------------

def _head_w(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def chunked_ce_kl(s_params, s_cfg: ModelConfig, h_s, t_params, t_cfg,
                  h_t, labels, mask, *, temperature: float = 1.0,
                  use_kernels: bool = False):
    """Loop over sequence chunks of ``s_cfg.loss_chunk`` (h_s, h_t,
    labels and mask padded together); returns (ce_sum, kl_sum, tok,
    correct) as f32 scalars.  KL is τ²·KL(softmax(z_t/τ) ‖ softmax(z_s/τ)).
    Each chunk is rematerialised in the backward when ``s_cfg.remat``."""
    B, S, _ = h_s.shape
    C = min(s_cfg.loss_chunk, S)
    pad = (-S) % C
    if pad:
        h_s = F.pad(h_s, (0, 0, 0, pad))
        h_t = F.pad(h_t, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    n = h_s.shape[1] // C
    tau = temperature

    def body(hh_s, hh_t, ll, mm):
        if use_kernels:
            from repro_torch.kernels.kd_loss import ops as kd_ops
            ce, kl, correct = kd_ops.ce_kl_from_hidden(
                hh_s, _head_w(s_params, s_cfg), hh_t,
                _head_w(t_params, t_cfg), ll, tau=tau,
                softcap_s=s_cfg.final_logit_softcap,
                softcap_t=t_cfg.final_logit_softcap)
        else:
            logit_s = M._head(s_params, s_cfg, hh_s)
            with torch.no_grad():
                logit_t = M._head(t_params, t_cfg, hh_t)
            lse_s = torch.logsumexp(logit_s, dim=-1)
            # gather takes int64 indices
            gold = torch.gather(logit_s, -1, ll.long()[..., None])[..., 0]
            ce = lse_s - gold
            logp_s = torch.log_softmax(logit_s / tau, dim=-1)
            logp_t = torch.log_softmax(logit_t / tau, dim=-1)
            p_t = torch.exp(logp_t)
            kl = torch.sum(p_t * (logp_t - logp_s), dim=-1) * (tau ** 2)
            correct = (torch.argmax(logit_s, -1) == ll).float()
        mmf = mm.float()
        return (torch.sum(ce * mmf), torch.sum(kl * mmf), torch.sum(mmf),
                torch.sum(correct * mmf))

    body = M._maybe_remat(s_cfg, body)
    zero = torch.zeros((), dtype=torch.float32, device=h_s.device)
    ce_s = kl_s = tok_s = cor_s = zero
    for i in range(n):
        sl = slice(i * C, (i + 1) * C)
        a, b, c, d = body(h_s[:, sl], h_t[:, sl], labels[:, sl],
                          mask[:, sl])
        ce_s, kl_s, tok_s, cor_s = ce_s + a, kl_s + b, tok_s + c, cor_s + d
    return ce_s, kl_s, tok_s, cor_s


# ---------------------------------------------------------------------------
# full distillation objective
# ---------------------------------------------------------------------------

def distill_loss(trainable, s_cfg: ModelConfig, t_params, t_cfg: ModelConfig,
                 batch, teacher_out, *, alpha: float = 1.0, beta: float = 1.0,
                 temperature: float = 2.0, n_stages: int = 4,
                 vaa_heads: int = 4, p_q: int = 64, mesh=None):
    """trainable = {"student": student_params, "vaa": vaa_params}.

    Eq. 11: L_KD = L_CE + α L_FM + β L_KL (+ the student's MoE aux loss,
    0 for the dense base).  Returns (total, metrics)."""
    s_params, vaa_params = trainable["student"], trainable["vaa"]
    h_s, aux, _, stages = M.backbone(s_params, s_cfg, batch,
                                     collect_stages=True, mesh=mesh)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce, kl, tok, cor = chunked_ce_kl(
        s_params, s_cfg, h_s, t_params, t_cfg, teacher_out["h"], labels, mask,
        temperature=temperature, use_kernels=s_cfg.use_kernels)
    tok = torch.clamp(tok, min=1.0)
    ce, kl = ce / tok, kl / tok
    fm = vaa_mod.feature_matching_loss(
        vaa_params, select_stages(stages, n_stages), teacher_out["stages"],
        n_heads=vaa_heads, p_q=p_q)
    total = ce + alpha * fm + beta * kl + aux
    metrics = {"ce": ce, "kl": kl, "fm": fm, "aux": aux,
               "accuracy": cor / tok}
    return total, metrics


def make_distill_step(s_cfg: ModelConfig, t_cfg: ModelConfig, *, alpha, beta,
                      temperature, n_stages, vaa_heads, p_q,
                      optimizer_update, mesh=None):
    """``step(trainable, opt_state, t_params, batch, lr) -> (trainable,
    opt_state, loss, metrics)``: the teacher pass, the gradient of Eq. 11
    with respect to every student and VAA leaf, and
    ``optimizer_update(grads, opt_state, trainable, lr=lr, shards=)``
    (``shards``: ``moe.clip_shards``, None unless a MoE student's experts
    are cut over the mesh), in place on ``trainable`` and ``opt_state``."""

    def step(trainable, opt_state, t_params, batch, lr):
        teacher_out = teacher_forward(t_params, t_cfg, batch,
                                      n_stages=n_stages, mesh=mesh)
        leaves = [p.requires_grad_(True) for p in tree_leaves(trainable)]
        loss, metrics = distill_loss(
            trainable, s_cfg, t_params, t_cfg, batch, teacher_out,
            alpha=alpha, beta=beta, temperature=temperature,
            n_stages=n_stages, vaa_heads=vaa_heads, p_q=p_q, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        del leaves, teacher_out
        trainable, opt_state, stats = optimizer_update(
            tree_unflatten_like(trainable, grads), opt_state, trainable,
            lr=lr, shards=moe.clip_shards(trainable, s_cfg, mesh))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(stats)
        return trainable, opt_state, loss.detach(), metrics

    return step


def make_distill_epoch(s_cfg: ModelConfig, t_cfg: ModelConfig, *, steps,
                       schedule, alpha, beta, temperature, n_stages,
                       vaa_heads, p_q, optimizer_update,
                       on_step: Optional[Callable] = None, mesh=None):
    """``epoch(trainable, opt_state, t_params, batches) -> (trainable,
    opt_state, losses)`` over stacked ``{tokens/labels: (steps, B, S)}``
    batches, the lr ``schedule`` applied to the step counter
    (``optim.loops.scan_epoch``).  ``on_step(step, loss)``, if given,
    runs after each step."""
    step_fn = make_distill_step(
        s_cfg, t_cfg, alpha=alpha, beta=beta, temperature=temperature,
        n_stages=n_stages, vaa_heads=vaa_heads, p_q=p_q,
        optimizer_update=optimizer_update, mesh=mesh)

    def epoch(trainable, opt_state, t_params, batches):
        def carry_step(carry, b, lr):
            trainable, opt_state, loss, _ = step_fn(*carry, t_params, b, lr)
            return (trainable, opt_state), loss

        (trainable, opt_state), losses = scan_epoch(
            carry_step, schedule, steps, on_step=on_step)(
                (trainable, opt_state), batches)
        return trainable, opt_state, losses

    return epoch
