"""End-to-end training driver (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 8 --seq 256 [--scale 0.25] [--resume] \
        [--device cpu]

It trains on the CUDA card unless ``--device`` names another, from seeded
weights, with the whole substrate engaged: pipeline -> train step ->
async checkpoints -> fault-tolerant restart. ``--scale 1.0`` trains the
full config. The model runs with ``use_pallas=False``, as the
reference's driver does: neither package has backward kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs import get_arch, reduced
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def scaled_config(arch: str, scale: float):
    cfg = get_arch(arch)
    if scale >= 1.0:
        return cfg
    groups, per = cfg.scan_groups()
    d = max(64, int(cfg.d_model * scale) // 16 * 16)
    heads = max(1, int(cfg.num_heads * scale))
    while cfg.num_heads % heads or heads > cfg.num_heads:
        heads -= 1
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return reduced(
        cfg,
        num_layers=per * max(2, int(groups * scale)),
        d_model=d,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=max(128, int(cfg.d_ff * scale) // 16 * 16 or 128),
        vocab_size=min(cfg.vocab_size, 8192),
        head_dim=max(16, int((cfg.resolved_head_dim) * scale) // 8 * 8),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", type=float, default=0.25,
                    help="model scale fraction; 1.0 trains the full config")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default="artifacts/train_metrics.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = scaled_config(args.arch, args.scale)
    cfg = dataclasses.replace(cfg, loss_chunk=min(cfg.loss_chunk, args.seq))
    if not args.resume:
        import shutil

        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    trainer = Trainer(
        cfg,
        TrainerConfig(
            steps=args.steps,
            global_batch=args.batch,
            seq_len=args.seq,
            ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
            microbatches=args.microbatches,
            log_every=1,
        ),
        opt_cfg=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
        device=args.device,
    )
    result = trainer.run()
    losses = result["losses"]
    k = max(len(losses) // 4, 1)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    final_step = result["final_step"]
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"steps={final_step} loss {first:.3f} -> {last:.3f}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    if args.steps >= 25:
        assert last < first, "loss did not decrease"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
