"""Static verification sweep of the port: the ratchet that spends no device
time.

    PYTHONPATH=src python -m repro_torch.analysis.sweep \
        [--quick] [--arch NAME ...] [--cache PATH] \
        [--out results/torch_ANALYSIS_static.json]

Sweeps the full candidate space of ``tuner.gemm_candidates`` /
``batched_candidates`` / ``ragged_candidates`` -- every compiled tile,
grid order, stream slice count and body the Hopper kernels allow, the
grouped product in its "nn" and "nt" layouts -- at
the port's dtype axis (fp32, bf16, bf16 -> fp32, the mixed bf16 x fp32
pairs, the 1-byte quantized pairs where a kernel takes them) for the
paper's 21 irregular shapes and the GEMM shapes of every registry config
(decode at 4 and 128 rows: the projections, the dense, grouped and ragged
SwiGLU pairs, the attention products, the MoE expert products and their
dW, the SSM projections), and checks each candidate against the static
contracts (``analysis.contracts``).  Once per run it also proves:

  * every body of every kernel masks the K remainder of all its operands
    (the CUDA sources);
  * one writer per output row for each ragged winner over adversarial
    group offsets (``contracts.RAGGED_DISTS``);
  * each winner's store coverage over its launch grid (the kernels take
    strided operands: one grid serves nn, tn and nt);
  * every record of ``--cache`` passes ``check_record`` (what the plan
    store would quarantine at load).

Exits 1 on any error-severity violation.  The report (``--out``) also
gives the largest shared-memory footprint admitted for each kernel body.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from typing import Any, Iterable, Sequence

from ..configs.registry import get_config, list_archs
from ..core.gemm import tuner
from ..core.gemm.shapes import PAPER_IRREGULAR_SHAPES
from ..models.ssm import ssm_dims
from . import contracts

DECODE_TOKENS = (4, 128)    # the port's 4-slot decode, the reference's 128
ATTN_KV = 96                # cache rows of the attention products' jobs
# The dtype axis: (A's width, the output's, B's width or None when it is
# A's).  Which families take which pairs: every family the homogeneous
# ones; the mixed bf16 x fp32 pairs the one-panel kernels (``kernel._MIXED``);
# the 1-byte pairs ``ftimm_gemm`` and the ragged forward (``kernel._QUANT``).
_HOMOGENEOUS = ((4, 4, None), (2, 2, None), (2, 4, None))
_MIXED = ((2, 4, 4), (4, 4, 2))
_NARROW = ((1, 4, None), (1, 2, None), (2, 2, 1), (4, 4, 1))
_EPI_OPS = (0, 2)           # identity and bias + activation tails (dense)


def _widths(family: str, panels: int, ragged: str) -> tuple:
    if panels == 2:
        return _HOMOGENEOUS
    if family == "dense" or (family == "ragged" and ragged == "m"):
        return _HOMOGENEOUS + _MIXED + _NARROW
    return _HOMOGENEOUS + _MIXED


def _dense_jobs(shapes: Sequence[tuple[str, int, int, int]]) -> list[tuple]:
    return [(name, "dense", (m, k, n), "m", 1) for name, m, k, n in shapes]


def registry_jobs(archs: Iterable[str] | None = None) -> list[tuple]:
    """(name, family, dims, ragged axis, panels) of the GEMMs every registry
    config dispatches at decode: the attention projections and products,
    the dense SwiGLU pair and its down projection, the unembed, the SSM
    in / out projections, and the MoE experts both ways (ragged forward,
    its pair and dW; the capacity buffers' grouped products and pair)."""
    jobs: list[tuple] = []
    for arch in (archs if archs is not None else list_archs()):
        cfg = get_config(arch)
        d = cfg.d_model
        for t in DECODE_TOKENS:
            tag = f"{arch}@{t}"
            if cfg.num_heads:
                hd = cfg.head_dim_
                n_q, n_kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
                jobs += [(f"{tag}:qkv", "dense", (t, d, n_q + 2 * n_kv), "m",
                          1),
                         (f"{tag}:attn_out", "dense", (t, n_q, d), "m", 1),
                         (f"{tag}:qk", "batched",
                          (t * cfg.num_heads, 1, hd, ATTN_KV), "m", 1),
                         (f"{tag}:pv", "batched",
                          (t * cfg.num_heads, 1, ATTN_KV, hd), "m", 1)]
            if cfg.ssm_state:
                di, hh, n = ssm_dims(d, cfg.ssm_state)
                jobs += [(f"{tag}:ssm_in", "dense",
                          (t, d, 2 * di + 2 * n + hh), "m", 1),
                         (f"{tag}:ssm_out", "dense", (t, di, d), "m", 1)]
            if cfg.d_ff and not cfg.num_experts:
                jobs += [(f"{tag}:mlp_pair", "dense", (t, d, cfg.d_ff), "m",
                          2),
                         (f"{tag}:mlp_down", "dense", (t, cfg.d_ff, d), "m",
                          1)]
            jobs.append((f"{tag}:lm_head", "dense", (t, d, cfg.vocab_padded),
                         "m", 1))
            if cfg.num_experts:
                e, f, tk = cfg.num_experts, cfg.d_ff, max(cfg.top_k, 1)
                rows = t * tk
                jobs += [(f"{tag}:moe_pair", "ragged", (e, rows, d, f), "m",
                          2),
                         (f"{tag}:moe_down", "ragged", (e, rows, f, d), "m",
                          1),
                         (f"{tag}:moe_dw", "ragged", (e, rows, d, f), "k", 1)]
                cap = tuner.plan_moe_dispatch(
                    t, e, tk, d, f, capacity_factor=cfg.capacity_factor
                ).rows // e
                jobs += [(f"{tag}:cap_pair", "batched", (e, cap, d, f), "m",
                          2),
                         (f"{tag}:cap_down", "batched", (e, cap, f, d), "m",
                          1)]
    return jobs


def _layouts(family: str, panels: int) -> tuple[str, ...]:
    """The layouts swept: the grouped product's "nn" and "nt" (the rows
    body cuts each its own way), else "nn"."""
    return ("nn", "nt") if family == "batched" and panels == 1 else ("nn",)


def _candidates(family: str, dims: tuple, ib: int, ob: int, bb, ragged: str,
                panels: int, epi_ops: int, trans: str) -> list:
    if family == "dense":
        return tuner.gemm_candidates(*dims, ib, ob, panels=panels,
                                     b_bytes=bb, epi_ops=epi_ops)
    if family == "batched":
        return tuner.batched_candidates(*dims, ib, ob, panels=panels,
                                        b_bytes=bb, trans=trans)
    return tuner.ragged_candidates(*dims, ib, ob, ragged, panels=panels,
                                   b_bytes=bb)


def run_sweep(shapes: Sequence[tuple[str, int, int, int]] | None = None,
              archs: Iterable[str] | None = None,
              cache_path: str | None = None) -> dict:
    """Run the sweep; returns the report (JSON-serializable):
    ``report["violations"]`` is the fatal list."""
    shapes = PAPER_IRREGULAR_SHAPES if shapes is None else shapes
    jobs = _dense_jobs(shapes) + registry_jobs(archs)
    violations: list[dict] = []
    smem: dict[str, int] = {}
    n_checked = 0
    coverage_seen: set[tuple] = set()
    rows_seen: set[tuple] = set()

    def record(name: str, ctx: str, found: Iterable[contracts.Violation]
               ) -> None:
        violations.extend({"job": name, "context": ctx, "code": v.code,
                           "message": v.message}
                          for v in contracts.errors(found))

    for name, family, dims, ragged, panels in jobs:
        kernel = contracts.plan_kernel(family, panels=panels, ragged=ragged)
        for ib, ob, bb in _widths(family, panels, ragged):
            epis = _EPI_OPS if family == "dense" and panels == 1 else (0,)
            for epi_ops, trans in itertools.product(
                    epis, _layouts(family, panels)):
                ctx = f"ib{ib} ob{ob}" + (f" bb{bb}" if bb else "") \
                    + f" epi{epi_ops}" + (f" {trans}" if trans != "nn"
                                          else "")
                cands = _candidates(family, dims, ib, ob, bb, ragged, panels,
                                    epi_ops, trans)
                if not cands:
                    record(name, ctx, [contracts.Violation(
                        "empty_candidates",
                        "generator returned no candidates")])
                    continue
                for plan in cands:
                    n_checked += 1
                    record(name, f"{ctx} {plan.body} ({plan.bm}, {plan.bn}, "
                                 f"{plan.bk}) {plan.dim_order} "
                                 f"x{plan.kslices}",
                           contracts.check_plan(
                               family, dims, plan, in_bytes=ib, out_bytes=ob,
                               b_bytes=bb, swiglu=panels == 2, ragged=ragged,
                               trans=trans))
                    key = f"{kernel} {plan.body}"
                    smem[key] = max(smem.get(key, 0), contracts.smem_footprint(
                        kernel, plan.body, bm=plan.bm, bn=plan.bn, bk=plan.bk,
                        panels=panels)[0])
                win = tuner.argmin_plan(cands)
                _prove_stores(name, family, dims, ragged, panels, win,
                              coverage_seen, rows_seen, record)

    record("kernels", "masking", contracts.check_contraction_masking())

    cache_report: dict[str, Any] = {"path": cache_path, "entries": 0,
                                    "quarantine_candidates": 0}
    if cache_path:
        try:
            with open(cache_path) as fp:
                blob = json.load(fp)
            entries = blob.get("entries", {}) if isinstance(blob, dict) \
                else {}
        except (OSError, ValueError):
            entries = {}
        cache_report["entries"] = len(entries)
        for key, rec in entries.items():
            found = contracts.errors(contracts.check_record(key, rec))
            if found:
                cache_report["quarantine_candidates"] += 1
                record(key, "plan-cache", found)

    return {
        "jobs": len(jobs),
        "candidates_checked": n_checked,
        "coverage_contracts": len(coverage_seen),
        "ragged_row_proofs": len(rows_seen),
        "masked_operands": {f"{k} {b}": list(n) for (k, b), n in
                            contracts.masked_operands().items()},
        "smem_admitted": dict(sorted(smem.items())),
        "plan_cache": cache_report,
        "violations": violations,
    }


def _prove_stores(name, family, dims, ragged, panels, win, coverage_seen,
                  rows_seen, record) -> None:
    """The winner's stores: its launch grid enumerated (deduped by
    geometry), or for a ragged forward winner one writer per row over each
    adversarial distribution of its groups."""
    if family == "ragged" and ragged == "m":
        g, total = dims[0], dims[1]
        kernel = contracts.plan_kernel(family, panels=panels)
        tile = (win.bm, win.bn, win.bk)
        for label, dist in contracts.RAGGED_DISTS:
            offsets, t = dist(g, total)
            sig = (kernel, win.body, tile, win.kslices, tuple(offsets), t)
            if sig in rows_seen:
                continue
            rows_seen.add(sig)
            record(name, f"rows {label} {win.body} {tile}",
                   contracts.check_ragged_rows(offsets, t, kernel=kernel,
                                               body=win.body, tile=tile,
                                               kslices=win.kslices))
        return
    c = contracts.variant_contract(family, dims, win, swiglu=panels == 2,
                                   ragged=ragged)
    sig = (c.name, c.body, c.grid, c.out_extent, c.slices)
    if sig not in coverage_seen:
        coverage_seen.add(sig)
        record(name, "coverage", contracts.verify_contract(c))


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="static kernel-contract sweep (no device time)")
    ap.add_argument("--out", default="results/torch_ANALYSIS_static.json",
                    help="report path ('' to skip writing)")
    ap.add_argument("--cache", default="",
                    help="a plan-store file to validate ('' to skip)")
    ap.add_argument("--arch", action="append", default=None,
                    help="registry config(s) to sweep (default: all)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep (first 6 paper shapes, 2 archs)")
    args = ap.parse_args(argv)

    shapes = PAPER_IRREGULAR_SHAPES
    archs = args.arch
    if args.quick:
        shapes = PAPER_IRREGULAR_SHAPES[:6]
        archs = archs or list_archs()[:2]
    report = run_sweep(shapes=shapes, archs=archs,
                       cache_path=args.cache or None)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(report, fp, indent=1, sort_keys=True)
    print(f"static sweep: {report['jobs']} shape jobs, "
          f"{report['candidates_checked']} candidate plans, "
          f"{report['coverage_contracts']} store contracts and "
          f"{report['ragged_row_proofs']} ragged row proofs verified, "
          f"{report['plan_cache']['entries']} stored records checked")
    print("largest shared memory admitted a CTA: " + ", ".join(
        f"{k} {v}" for k, v in report["smem_admitted"].items()))
    if report["violations"]:
        for row in report["violations"][:20]:
            print(f"  VIOLATION {row['code']}: {row['job']} "
                  f"({row['context']}): {row['message']}")
        print(f"static sweep: FAIL ({len(report['violations'])} violations)")
        return 1
    print("static sweep: PASS (zero violations)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
