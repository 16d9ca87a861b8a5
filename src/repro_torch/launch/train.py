"""Training launcher: `PYTHONPATH=src python -m repro_torch.launch.train
--arch <id> [--reduced] [--steps N] [--batch B] [--seq S] [--lr LR]
[--grad-accum K] [--grad-compression] [--ckpt DIR] [--torch-device cuda]`.

The reference's ``repro.launch.train`` with the same flags and lines,
plus the port's ``--torch-device`` (default the card: a missing card
raises; ``--torch-device cpu`` runs the plain PyTorch versions) and a
last line with the final loss at full precision.  Weights are random,
drawn from a fixed seed; ``--ckpt`` saves there and resumes from the
newest checkpoint in it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.models.model import RunFlags
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.trainer import TrainConfig, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced (CPU-runnable) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the tensors live (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train runs on a CUDA device "
                           "and none is available; pass --torch-device cpu "
                           "to run the plain PyTorch versions")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    tc = TrainConfig(
        steps=args.steps, batch_size=args.batch, seq_len=args.seq,
        checkpoint_dir=args.ckpt, grad_compression=args.grad_compression,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
        flags=RunFlags(grad_accum=args.grad_accum))
    h = train(cfg, tc, device=dev)
    if h["loss"]:
        print(f"[train] final loss {h['loss'][-1]!r} after {tc.steps} "
              f"steps")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
