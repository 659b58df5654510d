"""Where a decode step's time goes on the card: ``torch.profiler`` over
steady-state decode steps of the serving engine.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen3-1.7b] [--slots 4] [--steps 5] [--layers N]

Fills every slot with a request (random weights from ``--seed``), runs a
few warm decode steps, then profiles ``--steps`` decode steps and prints:
the step wall time (host clock, ``ServeEngine.walls``), the device busy
time per step (the sum of CUDA kernel and copy durations in the trace), the
device idle share, and device time by kernel group.  The last line is one
JSON object with the same numbers.  ``--layers`` cuts the depth (every
width as published), so that a model whose full depth does not fit one
card -- mixtral-8x7b, llama4-scout-17b-a16e -- can be profiled.  With
``$REPRO_PLAN_CACHE`` naming a measured plan store (``core.gemm.autotune``)
the step serves its plans; the plan modes printed say how many did.  Needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..configs import get_config
from ..core.device import resolve_device
from ..core.gemm import plan_mode_stats
from ..models.model import init_params
from ..serve.engine import Request, ServeEngine

# Device-event groups, matched by substring of the kernel name in order:
# the SwiGLU pairs' bodies before the one-panel kernels' (each body's
# symbol names its kernel: the stream's Tag type, the tensor cores' and the
# FMA body's kernel function).
GROUPS = (("ftimm_gemm_swiglu stream", "ftimm_gemm_swiglu_stream"),
          ("ftimm_gemm_swiglu tensor cores", "ftimm_gemm_swiglu_tc_kernel"),
          ("ftimm_gemm_swiglu", "ftimm_gemm_swiglu_kernel"),
          ("ftimm_gemm_grouped_swiglu stream",
           "ftimm_gemm_grouped_swiglu_stream"),
          ("ftimm_gemm_grouped_swiglu tensor cores",
           "ftimm_gemm_grouped_swiglu_tc_kernel"),
          ("ftimm_gemm_grouped_swiglu", "ftimm_gemm_grouped_swiglu_kernel"),
          ("ftimm_gemm_ragged_swiglu stream",
           "ftimm_gemm_ragged_swiglu_stream"),
          ("ftimm_gemm_ragged_swiglu tensor cores",
           "ftimm_gemm_ragged_swiglu_tc_kernel"),
          ("ftimm_gemm_grouped", "ftimm_gemm_grouped_kernel"),
          ("ftimm_gemm_grouped stream", "ftimm_gemm_grouped_stream"),
          ("ftimm_gemm_grouped tensor cores", "ftimm_gemm_grouped_tc_kernel"),
          ("ftimm_gemm_ragged_swiglu", "ftimm_gemm_ragged_swiglu_kernel"),
          ("ftimm_gemm_ragged", "ftimm_gemm_ragged_kernel"),
          ("ftimm_gemm_ragged stream", "ftimm_gemm_ragged_stream"),
          ("ftimm_gemm_ragged tensor cores", "ftimm_gemm_ragged_tc_kernel"),
          ("ftimm_gemm_splitk tensor cores", "ftimm_gemm_splitk_tc_kernel"),
          ("ftimm_gemm_splitk", "ftimm_gemm_splitk_kernel"),
          ("ftimm_gemm stream", "ftimm_gemm_stream_"),
          ("ftimm_gemm tensor cores", "ftimm_gemm_tc_kernel"),
          ("ftimm_gemm fma", "ftimm_gemm_kernel"),
          ("host <-> device copy", "memcpy"),
          ("copy / cast", "copy"),
          ("index / gather / scatter", "index"),
          ("reduce", "reduce"))


def group_of(name: str) -> str:
    low = name.lower()
    for group, key in GROUPS:
        if key in low:
            return group
    return "other elementwise"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (default: as published)")
    args = ap.parse_args(argv)

    device = resolve_device(None)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    new = args.warm + args.steps + 4
    engine = ServeEngine(cfg, init_params(cfg, args.seed, device=device),
                         batch_slots=args.slots, device=device,
                         max_len=args.prompt_len + new + 8)
    rng = np.random.default_rng(args.seed)
    for i in range(args.slots):
        engine.submit(Request(rid=i, max_new_tokens=new, prompt=rng.integers(
            2, cfg.vocab_size, args.prompt_len).astype(np.int32)))
    for _ in range(args.warm):          # admits every request, then decodes
        engine.step()
    if engine.queue or not all(engine.active):
        raise RuntimeError("slots not all busy after warm-up")

    first = len(engine.walls["decode"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            engine.step()
        torch.cuda.synchronize(device)
    walls = engine.walls["decode"][first:]

    by_group: dict[str, float] = collections.Counter()
    by_kernel: dict[str, list] = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        by_group[group_of(evt.name)] += us
        k = by_kernel.setdefault(evt.name, [0, 0.0])
        k[0] += 1
        k[1] += us
    busy_ms = sum(by_group.values()) / 1e3 / args.steps
    wall_ms = statistics.median(walls) * 1e3
    print(f"{torch.cuda.get_device_name(device)}: {args.arch} at "
          f"{cfg.num_layers} layers, {args.slots} slots, {args.steps} decode "
          f"steps profiled; plan modes {plan_mode_stats()}")
    print(f"step wall median {wall_ms:.2f} ms; device busy "
          f"{busy_ms:.2f} ms/step; idle share {1 - busy_ms / wall_ms:.3f}")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:26s} {us / 1e3 / args.steps:9.3f} ms/step")
    print("top device kernels (per step):")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (count, us) in top:
        print(f"  {us / 1e3 / args.steps:8.3f} ms  x{count // args.steps:<4d}"
              f" {name[:100]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(device), "arch": args.arch,
        "layers": cfg.num_layers, "slots": args.slots, "steps": args.steps,
        "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms,
        "device_ms_per_step": {g: us / 1e3 / args.steps
                               for g, us in by_group.items()},
        "launches_per_step": sum(c for c, _ in by_kernel.values())
        / args.steps, "plan_modes": plan_mode_stats()}))


if __name__ == "__main__":
    main()
