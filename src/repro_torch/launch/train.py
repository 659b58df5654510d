"""Training launcher, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b-smoke \
        --steps 20 [--seq 128 --batch 8] [--ckpt DIR] [--lr 3e-4] [--seed 0] \
        [--device cpu]

Trains on the CUDA card unless ``--device`` names another device (``cpu``
runs every GEMM's plain version).  Prints the logged steps' loss, gradient
norm and learning rate, then ``training done``.  With ``--ckpt`` it resumes
from the latest checkpoint there.  The reference's ``--mesh`` and
``--elastic`` are not ported.
"""
from __future__ import annotations

import argparse

from ..configs import get_config
from ..configs.base import ShapeConfig
from ..optim.adamw import OptConfig
from ..train.trainer import Trainer


def opt_config(steps: int, lr: float) -> OptConfig:
    """The launcher's schedule for a run of ``steps``: linear warmup over a
    tenth of the run plus one step (at most 100) to ``lr``, then cosine
    decay to the run's end."""
    return OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1),
                     total_steps=steps)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    trainer = Trainer(cfg, shape, opt_config(args.steps, args.lr),
                      seed=args.seed, ckpt_dir=args.ckpt, device=args.device)
    trainer.run(args.steps)
    print("training done")


if __name__ == "__main__":
    main()
