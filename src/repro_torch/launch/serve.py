"""Serving launcher: batched requests through the slot engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 8 --max-new 16 [--plan-cache build/plan_cache_<card>.json]

Runs on the CUDA card, every GEMM through the ftIMM kernels; with no card
it raises unless ``--device cpu`` asks for the plain versions on the CPU
(``--arch qwen3-1.7b-smoke --device cpu`` is the CPU-sized run).  The
recurrent families (``mamba2-370m``, ``zamba2-7b``) and the
encoder-decoder (``whisper-base``) serve on the engine's dense-slot rung:
exact-length prefill into a slot cache (whisper's holds each slot's cross
K / V of the encoder rows), no page pool, no buckets and no cost model.
The vision-language ``llava-next-34b`` serves on the paged rung, each
request's pages holding its patch rows in front of its tokens.  The stub
frontends' frames and patch embeddings are zeros, as in the reference.

Warmup loads a measured plan store (``--plan-cache``, else
``$REPRO_PLAN_CACHE``, else ``results/plan_cache.json`` when present)
before the engine plans anything, so every GEMM whose signature the store
holds for this device serves its measured plan (``mode == "cached"``).  A
store measured on another device adopts nothing.
"""
from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np

from ..configs import get_config
from ..core.device import resolve_device
from ..core.gemm import (autotune, epilogue_stats, plan_mode_stats,
                         plan_store)
from ..kernels.ftimm import launch_counts
from ..models.model import init_params
from ..serve.engine import Request, ServeEngine

_DEFAULT_CACHE = pathlib.Path(__file__).resolve().parents[3] \
    / "results" / "plan_cache.json"


def load_plan_cache(path: str | None) -> int:
    """The warmup load: ``path``, else ``$REPRO_PLAN_CACHE``, else the
    repo's ``results/plan_cache.json`` when present.  Returns the plans
    adopted (0 when nothing loads: serving goes on with analytic plans) and
    prints them and the records quarantined."""
    path = path or os.environ.get(plan_store.ENV_VAR) \
        or (str(_DEFAULT_CACHE) if _DEFAULT_CACHE.exists() else None)
    if not path:
        return 0
    n = autotune.load_plan_cache(path)
    store = plan_store.get_store()
    print(f"plan cache: {n} measured plans adopted from {path} "
          f"(device {plan_store.device_kind()}), "
          f"{len(store.quarantined)} quarantined")
    if store.quarantined:
        codes = sorted({c for v in store.quarantined.values() for c in v})
        print(f"plan cache: quarantined records ({', '.join(codes)}) plan "
              "analytically")
    return n


def fusion_coverage() -> str:
    """Epilogue-fusion census of the served GEMMs, per plan family."""
    stats = epilogue_stats()
    if not stats:
        return "(no epilogue-carrying GEMMs served)"
    fused = sum(v.get("fused", 0) for v in stats.values())
    total = fused + sum(v.get("separate", 0) for v in stats.values())
    per_family = ", ".join(
        f"{fam}: {v.get('fused', 0)}/{v.get('fused', 0) + v.get('separate', 0)}"
        for fam, v in sorted(stats.items()))
    return f"{fused}/{total} fused ({per_family})"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool size in pages (default: slots x max pages)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline; admission control prices "
                         "against it once calibrated")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--plan-cache", default=None,
                    help="measured plan store to load at warmup")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    load_plan_cache(args.plan_cache)
    cfg = get_config(args.arch)
    params = init_params(cfg, args.seed, device=device)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.prompt_len + args.max_new + 8,
                         page_size=args.page_size, num_pages=args.num_pages,
                         seed=args.seed, device=device)
    if engine.paged:
        cost = engine.cost.snapshot()
        print(f"warmup: buckets={cost['buckets']} "
              f"planned {cost['warmed_signatures']} GEMM signatures "
              f"(plan-store lookups={cost['store_lookups']} "
              f"hits={cost['store_hits']}), "
              f"KV pool {engine.alloc.total} pages x {engine.page_size} "
              f"rows on {device}")
    else:
        mb = {k: t.numel() * t.element_size() / 1e6
              for k, t in engine.cache.items()}
        cross = sum(v for k, v in mb.items() if k.startswith("cross"))
        print(f"warmup: exact-length prefill (no buckets, no cost model), "
              f"slot cache {sum(mb.values()):.3f} MB ({args.slots} slots, "
              f"{', '.join(engine.cache)}"
              + (f"; cross K/V {cross:.3f} MB" if cross else "")
              + f") on {device}")
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(2, cfg.vocab_size,
                                        args.prompt_len).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    deadline_s=args.deadline_s)
            for i in range(args.requests)]
    engine.run(reqs)
    for r in reqs:
        tag = " SHED" if r.shed else (" TIMEOUT" if r.timed_out else "")
        print(f"req {r.rid}{tag}: {r.out_tokens}")
    modes = {fam: v for fam, v in plan_mode_stats().items()
             if fam != "epilogue"}
    print("plan modes:", modes or "(no planned GEMMs served)")
    print("epilogue fusion:", fusion_coverage())
    print("kernel launches:", launch_counts())
    health = engine.health()
    print("health:", "DEGRADED" if health["degraded_mode"] else "ok",
          f"faults={health['faults']}")
    print("serving done")


if __name__ == "__main__":
    main()
