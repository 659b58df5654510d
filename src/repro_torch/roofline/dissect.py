"""Collective dissection of a dry-run step: its largest collectives, for the
perf loop.

    PYTHONPATH=src python -m repro_torch.roofline.dissect --arch qwen3-8b \
        --shape train_4k [--variant baseline] [--top 25]

Runs the cell's step on the abstract production mesh (``launch.dryrun``)
and prints each distinct collective -- its total bytes, op, bytes each,
count and call site -- largest first, then ``TOTAL(top N)``.  Identical
calls (op, bytes, axes, site up to the layer index) are merged with their
count, which stands in for the reference's loop trip count; the call site
(module and function, with the layers a stack loop ran it at, " bwd" for
a backward) is the port's counterpart of the HLO ``op_name``.
"""
from __future__ import annotations

import argparse
import re
from collections import Counter


_LAYER = re.compile(r" \[layer (\d+)\]")


def dissect(entries, top: int = 25) -> list[tuple]:
    """The ``top`` largest merged collectives of ``entries`` (each with
    ``op``, ``bytes``, ``axis`` and ``site``, as
    ``core.gemm.collective.Collective``): (total bytes, op, bytes each,
    count, site), sorted by total bytes, largest first.  Calls that differ
    only in their layer index merge, the site naming the layers' range."""
    merged: Counter = Counter()
    layers: dict = {}
    for e in entries:
        m = _LAYER.search(e.site)
        key = (e.op, e.bytes, e.axis, _LAYER.sub(" [layer *]", e.site))
        merged[key] += 1
        if m:
            layers.setdefault(key, set()).add(int(m.group(1)))
    rows = []
    for key, n in merged.items():
        op, b, _axis, site = key
        if key in layers:
            lo, hi = min(layers[key]), max(layers[key])
            site = site.replace("[layer *]", f"[layer {lo}]" if lo == hi
                                else f"[layers {lo}-{hi}]")
        rows.append((float(b * n), op, b, n, site))
    return sorted(rows, key=lambda r: (-r[0], r[1], r[4]))[:top]


def format_rows(rows, top: int) -> list[str]:
    """The reference's lines, and the ``TOTAL(top N)`` line."""
    out, total = [], 0.0
    for tot, op, byts, n, site in rows:
        total += tot
        out.append(f"{tot / 2**30:9.3f} GiB  {op:19s} x{n:5d} "
                   f"({byts / 2**20:9.2f} MiB each)  {site[:110]}")
    out.append(f"TOTAL(top {top}): {total / 2**30:.2f} GiB")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    from ..launch import dryrun
    entries: list = []
    r = dryrun.run_cell(args.arch, args.shape, variant=args.variant,
                        save=False, entries=entries, count_flops=False)
    if r["status"] != "ok":
        print(f"[{r['status']}] {r['cell']}: {r.get('reason', '')}")
        return
    for line in format_rows(dissect(entries, args.top), args.top):
        print(line)


if __name__ == "__main__":
    main()
