"""Server-side distillation launcher: the DeepFusion pipeline as a CLI.

Counterpart of ``repro.launch.distill_run``, with the same flags, the
same tiny f32 families (a gpt2-like and a llama-like device model, a
4-expert MoE) and the same closing line, plus ``--device`` (the card
unless ``cpu`` is named).

  PYTHONPATH=src python -m repro_torch.launch.distill_run \\
      --devices 8 --domains 4 --experts 4 --steps 40 [--method fedkmt]
  PYTHONPATH=src python -m repro_torch.launch.distill_run --device cpu \\
      --devices 4 --steps 4
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint import save_pytree
from repro_torch.federated.server import ServerConfig
from repro_torch.federated.simulation import SimulationConfig, run_deepfusion
from repro_torch.models.config import ModelConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--domains", type=int, default=4)
    ap.add_argument("--experts", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40,
                    help="device/distill/tune step budget")
    ap.add_argument("--seq", type=int, default=48)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--method", default="deepfusion",
                    choices=["deepfusion", "fedkmt"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    small = dict(vocab_size=args.vocab, dtype="float32", remat=False,
                 attn_chunk_q=32, attn_chunk_k=32, loss_chunk=32)
    dev_a = ModelConfig(name="gpt2-tiny", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=4, head_dim=16, d_ff=128,
                        norm_type="layernorm", act="gelu", mlp_gated=False,
                        pos_embedding="sinusoidal", **small).validate()
    dev_b = ModelConfig(name="llama-tiny", n_layers=3, d_model=96, n_heads=4,
                        n_kv_heads=2, head_dim=24, d_ff=192,
                        **small).validate()
    moe_cfg = ModelConfig(name="moe", arch_type="moe", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                          d_ff=128, n_experts=args.experts, top_k=2,
                          moe_d_ff=128, n_shared_experts=1,
                          **small).validate()
    sim = SimulationConfig(n_devices=args.devices, n_domains=args.domains,
                           vocab=args.vocab, seq_len=args.seq,
                           device_steps=args.steps, device_batch=8,
                           seed=args.seed)
    scfg = ServerConfig(moe_cfg=moe_cfg, distill_steps=args.steps,
                        distill_batch=8, tune_steps=args.steps, tune_batch=8,
                        seq_len=args.seq, n_stages=2, p_q=32, vaa_dim=64,
                        seed=args.seed,
                        alpha=0.0 if args.method == "fedkmt" else 1.0)
    params, report = run_deepfusion(sim, scfg, [dev_a, dev_b],
                                    device=args.device)
    m = report["metrics"]
    print(f"\n{args.method}: log-ppl {m['log_ppl']:.4f} "
          f"acc {m['accuracy']:.3f} comm {report['comm_bytes']/1e6:.1f} MB")
    if args.save:
        save_pytree(params, args.save)
        print("saved", args.save)
    return params, report


if __name__ == "__main__":
    main()
