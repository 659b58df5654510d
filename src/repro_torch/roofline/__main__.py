"""One step's buckets and its roofline on the H100 (``roofline.step_perf``,
``roofline.build_roofline``).

    PYTHONPATH=src python -m repro_torch.roofline \
        --arch qwen3-1.7b [--layers N] [--batch 4] [--seq 80] [--kind decode]
        [--ep-shards N]

``--ep-shards``: the MoE experts cut over N ranks; the step then carries
the expert-parallel token exchange in its ``moe_a2a`` bucket.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from ..configs import ShapeConfig, get_config
from .analysis import build_roofline, model_flops_estimate
from .perf_model import step_perf


def main(argv=None) -> None:
    """Print the buckets by bytes, then the totals and terms; the last line
    is one JSON object.  ``--seq``: the cache rows of a decode step, the
    sequence of a train or prefill step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=80)
    ap.add_argument("--kind", default="decode",
                    choices=("decode", "prefill", "train"))
    ap.add_argument("--ep-shards", type=int, default=1)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = ShapeConfig(f"{args.kind}_{args.batch}x{args.seq}", args.seq,
                        args.batch, args.kind)
    perf = step_perf(cfg, shape, ep_shards=args.ep_shards)
    r = build_roofline(arch=args.arch, shape=shape.name,
                       analytic_flops=perf.flops,
                       analytic_bytes=perf.bytes_hbm,
                       analytic_ici=perf.bytes_ici,
                       model_flops=model_flops_estimate(cfg, shape,
                                                        args.kind))
    for name, (f, b, ici) in sorted(perf.breakdown.items(),
                                    key=lambda kv: -kv[1][1]):
        link = f" {ici / 1e9:10.4f} GB interconnect" if ici else ""
        print(f"  {name:16s} {b / 1e9:10.4f} GB {f / 1e9:12.3f} GFLOP"
              f"{link}")
    print(f"{args.arch} at {cfg.num_layers} layers, {shape.name}: "
          f"{perf.bytes_hbm / 1e9:.4f} GB, {perf.flops / 1e12:.4f} TFLOP; "
          f"t_memory {r.t_memory * 1e3:.4f} ms, t_compute "
          f"{r.t_compute * 1e3:.4f} ms ({r.dominant})")
    print(json.dumps({"arch": args.arch, "layers": cfg.num_layers,
                      "shape": shape.name, **r.to_dict()}))


if __name__ == "__main__":
    main()
