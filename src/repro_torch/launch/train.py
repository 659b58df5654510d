"""Training launcher: one device, or a mesh of process-group ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b-smoke \
        --steps 20 [--seq 128 --batch 8] [--ckpt DIR] [--lr 3e-4] [--seed 0] \
        [--device cpu] [--mesh DxM [--backend gloo|nccl]] \
        [--elastic [--model-parallel T]]

Trains on the CUDA card unless ``--device`` names another device (``cpu``
runs every GEMM's plain version).  Prints the logged steps' loss, gradient
norm and learning rate, then ``training done``.  With ``--ckpt`` it resumes
from the latest checkpoint there.

``--mesh DxM`` trains on a (data D, model M) mesh (``--mesh D``: (D, 1)):
ZeRO-3 over data, tensor parallelism over model (``train.Trainer(mesh=)``).
Under ``torchrun`` (``WORLD_SIZE`` in the environment) this process is one
rank of that world, on ``cuda:$LOCAL_RANK``; otherwise it spawns D x M
local ranks that meet on a ``file://`` store, rank r on ``cuda:r`` modulo
the cards (all on ``--device cpu`` when asked).  ``--backend``: the
process groups' (default NCCL on cards, gloo on the CPU); two ranks on one
card need ``gloo`` -- NCCL raises there, and the launcher never switches.

``--elastic`` runs under ``runtime.elastic.ElasticRunner``: a
``HostFailure`` mid-run (injected with
``REPRO_CHAOS="shard_loss@N:chips=K"``) shrinks the mesh to the surviving
ranks, keeping the model-parallel degree (``--model-parallel``, default
M), restores the latest checkpoint and resumes with deterministic data
replay.  Requires ``--ckpt``.  A rank whose process really died is not
recovered: that needs a new world (torchrun's elastic agent).
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

import torch

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


def mesh_dims(text: str) -> tuple[int, int]:
    """"DxM" -> (D, M); "D" -> (D, 1)."""
    dims = tuple(int(p) for p in text.split("x"))
    if len(dims) == 1:
        dims = dims + (1,)
    if len(dims) != 2 or min(dims) < 1:
        raise ValueError(f"--mesh {text!r}: expected DxM")
    return dims


def _rank_device(args, local_rank: int) -> torch.device:
    if args.device is not None:
        dev = torch.device(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, init_method: str, args) -> None:
    """One rank of the mesh run: join the world, train, leave."""
    import torch.distributed as dist

    from .mesh import make_mesh
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = _rank_device(args, local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        cfg = get_config(args.arch)
        shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                            kind="train")
        opt = opt_config(args.steps, args.lr)
        dims = mesh_dims(args.mesh)
        if args.elastic:
            from ..runtime.elastic import ElasticRunner
            runner = ElasticRunner(
                cfg, shape, opt, ckpt_dir=args.ckpt,
                model_parallel=args.model_parallel or dims[1],
                total_chips=math.prod(dims), seed=args.seed,
                backend=args.backend, device=dev)
            runner.run(args.steps)
            if rank == 0:
                for h in runner.history:
                    print("elastic:", h, flush=True)
        else:
            mesh = make_mesh(dims, ("data", "model"), backend=args.backend,
                             device=dev)
            Trainer(cfg, shape, opt, mesh=mesh, seed=args.seed,
                    ckpt_dir=args.ckpt).run(args.steps)
    finally:
        dist.destroy_process_group()


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
    ap.add_argument("--mesh", default=None,
                    help="DxM = (data, model) ranks; D alone = (D, 1)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the mesh's process groups (default: NCCL on "
                         "cards, gloo on the CPU)")
    ap.add_argument("--elastic", action="store_true",
                    help="recover from HostFailure by re-meshing onto the "
                         "surviving ranks (checkpoint-restart; needs --ckpt "
                         "and --mesh)")
    ap.add_argument("--model-parallel", type=int, default=None,
                    help="TP degree kept across elastic re-meshes "
                         "(default: the model axis of --mesh)")
    args = ap.parse_args(argv)
    if args.elastic and not (args.ckpt and args.mesh):
        ap.error("--elastic needs --ckpt and --mesh")

    if args.mesh is None:
        cfg = get_config(args.arch)
        shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch,
                            kind="train")
        Trainer(cfg, shape, opt_config(args.steps, args.lr), seed=args.seed,
                ckpt_dir=args.ckpt, device=args.device).run(args.steps)
        print("training done")
        return
    world = math.prod(mesh_dims(args.mesh))
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"--mesh {args.mesh} needs {world} ranks, "
                             f"torchrun started {os.environ['WORLD_SIZE']}")
        rank = int(os.environ["RANK"])
        _rank_main(rank, world, "env://", args)
        if rank == 0:
            print("training done")
        return
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        mp.start_processes(_rank_main, args=(world, f"file://{tmp}/store",
                                             args),
                           nprocs=world, start_method="spawn")
    print("training done")


if __name__ == "__main__":
    main()
