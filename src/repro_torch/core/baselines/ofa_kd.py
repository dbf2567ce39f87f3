"""OFA-KD [Hao et al., NeurIPS'23]: cross-architecture KD via logit space.

Counterpart of ``repro.core.baselines.ofa_kd``.  Instead of aligning
features in a learned common space (VAA), OFA-KD projects the student's
*intermediate* stage features into the logits space with small exit
heads and aligns each against the **teacher's final logits** (KL).
Everything else is the DeepFusion pipeline (clustering, proxies, merge,
tune), so the feature-alignment mechanism is the only variable.

One deliberate difference: the final CE + KL goes through
``chunked_ce_kl`` with ``use_kernels=s_cfg.use_kernels`` (the kd_loss
kernel in KD mode on the card), where the reference's ``ofa_loss``
leaves its ``use_pallas`` at the default, False.  Both branches compute
the same function.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import distill as D
from repro_torch.data.federated import FederatedCorpus
from repro_torch.federated.server import DeepFusionServer, ServerConfig
from repro_torch.federated.simulation import SimulationConfig, evaluate_model
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               scan_epoch)
from repro_torch.utils.pytree import (tree_leaves, tree_map,
                                      tree_unflatten_like)


def init_ofa_heads(generator, *, n_stages: int, d_student: int, vocab: int,
                   rank: int = 64):
    """Low-rank exit heads, stage feature -> logits, f32, drawn from
    ``generator`` (a seeded ``torch.Generator``; the draws differ from
    ``jax.random``)."""
    return {
        "down": layers.dense_init(generator, (n_stages, d_student, rank), 1),
        "up": layers.dense_init(generator, (n_stages, rank, vocab), 1),
    }


def ofa_loss(trainable, s_cfg: ModelConfig, t_params, t_cfg: ModelConfig,
             batch, teacher_out, *, beta: float, temperature: float,
             n_stages: int, gamma_stage: float = 0.5, mesh=None):
    """CE + β·KL on the final logits + γ·(mean over J stages of the exit
    head's τ²-scaled KL to the teacher's final logits) + the MoE aux
    loss.  Returns (total, metrics).  ``mesh`` reaches the student's
    ``M.backbone``, as in the reference: a MoE student's experts take
    their expert-parallel path and hold the rank's block
    (``models/moe.py::shard_experts``); a dense student is unchanged."""
    s_params, heads = trainable["student"], trainable["ofa"]
    h_s, aux, _, stages = M.backbone(s_params, s_cfg, batch,
                                     collect_stages=True, mesh=mesh)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    ce, kl, tok, cor = D.chunked_ce_kl(
        s_params, s_cfg, h_s, t_params, t_cfg, teacher_out["h"], labels, mask,
        temperature=temperature, use_kernels=s_cfg.use_kernels)
    tok = torch.clamp(tok, min=1.0)
    ce, kl = ce / tok, kl / tok
    # stage exits vs the teacher's final logits (the teacher is frozen)
    with torch.no_grad():
        t_logits = M._head(t_params, t_cfg, teacher_out["h"])
        logp_t = torch.log_softmax(t_logits / temperature, dim=-1)
        p_t = torch.exp(logp_t)
    stage_kl = torch.zeros((), dtype=torch.float32, device=h_s.device)
    for j, f in enumerate(D.select_stages(stages, n_stages)):
        z = (f.float() @ heads["down"][j]) @ heads["up"][j]
        logp_s = torch.log_softmax(z / temperature, dim=-1)
        stage_kl = stage_kl + torch.mean(torch.sum(
            p_t * (logp_t - logp_s), -1)) * temperature ** 2
    stage_kl = stage_kl / n_stages
    total = ce + beta * kl + gamma_stage * stage_kl + aux
    return total, {"ce": ce, "kl": kl, "stage_kl": stage_kl,
                   "accuracy": cor / tok}


class OFAServer(DeepFusionServer):
    def distill_proxy(self, proxy_item, base_cfg, *, init_params=None,
                      seed_offset: int = 0):
        """OFA-KD in place of Phase II's VAA distillation: the student
        drawn from a ``torch.Generator`` seeded ``seed + 404 +
        seed_offset`` (or copied from ``init_params``) and the exit heads
        from ``seed + 505 + seed_offset`` (the reference's keys).
        Returns (student params, per-step losses)."""
        scfg = self.cfg
        dev = self.device
        t_cfg = self.device_cfgs[proxy_item["arch"]]
        t_params = proxy_item["params"]

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(
                scfg.seed + offset + seed_offset)

        s_params = tree_map(lambda t: t.detach().to(dev, copy=True),
                            init_params) if init_params is not None else \
            M.init_params(base_cfg, generator=gen(404))
        heads = init_ofa_heads(gen(505), n_stages=scfg.n_stages,
                               d_student=base_cfg.d_model,
                               vocab=base_cfg.vocab_size)
        trainable = {"student": s_params, "ofa": heads}
        opt = adamw_init(trainable)
        steps = scfg.distill_steps

        def step(carry, batch, lr):
            trainable, opt = carry
            teacher_out = D.teacher_forward(t_params, t_cfg, batch,
                                            n_stages=scfg.n_stages)
            leaves = [p.requires_grad_(True) for p in tree_leaves(trainable)]
            loss, _ = ofa_loss(trainable, base_cfg, t_params, t_cfg, batch,
                               teacher_out, beta=scfg.beta,
                               temperature=scfg.temperature,
                               n_stages=scfg.n_stages)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            del leaves, teacher_out
            adamw_update(tree_unflatten_like(trainable, grads), opt,
                         trainable, lr=lr)
            return (trainable, opt), loss.detach()

        epoch = scan_epoch(step, cosine_schedule(scfg.distill_lr, steps,
                                                 warmup=max(steps // 20, 1)),
                           steps, on_step=self.on_step)
        batches = self.corpus.mixed_eval_batches(steps, scfg.distill_batch,
                                                 scfg.seq_len)
        (trainable, _), losses = epoch(
            (trainable, opt), {k: v.to(dev) for k, v in batches.items()})
        hist = [float(x) for x in losses.cpu()]  # the epoch's one sync
        self.log(f"OFA-KD: proxy c{proxy_item['cluster']} distilled "
                 f"loss {hist[0]:.3f}->{hist[-1]:.3f}")
        return trainable["student"], hist


def run_ofa_kd(sim: SimulationConfig, server_cfg: ServerConfig,
               device_cfgs: Sequence[ModelConfig], *, uploads,
               corpus: FederatedCorpus, log: Callable[[str], None] = print,
               device="cuda"):
    """The DeepFusion server pipeline with OFA-KD as Phase II, on shared
    ``uploads``, then ``evaluate_model``.  Returns (moe_params, report)."""
    server = OFAServer(server_cfg, corpus, device_cfgs, log=log,
                       device=device)
    moe_params, report = server.run(uploads)
    metrics = evaluate_model(moe_params, server_cfg.moe_cfg, corpus,
                             seq_len=sim.seq_len)
    report["metrics"] = metrics
    return moe_params, report
