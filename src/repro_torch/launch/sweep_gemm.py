"""Time the bodies of ``ftimm_gemm`` at the main path's shapes on the card:
the stream body at each K slice count, the tensor-core tiles in both grid
orders, the FMA body's planned tile, the planner's own choice, and
``torch.matmul`` as the yardstick.  It is the measurement the planner's
stream and tensor-core constants (``core/gemm/cmr.py``) are checked
against.

    PYTHONPATH=src python -m repro_torch.launch.sweep_gemm [--set decode|prefill|train]

Each variant is timed by ``launch.timing.time_ms`` (CUDA events around
calls enqueued behind a sleep kernel, so the card runs them back to back,
not at the host's pace), operands rotated through more copies than the
50 MB L2 holds.
Prints one line per (shape, variant), then the card's name and power
limit, then one JSON object with every time.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from ..core.gemm import plan_gemm
from ..kernels.ftimm import kernel as K
from .timing import sleep_ms_per_mcycle, time_ms

BF16, F32 = torch.bfloat16, torch.float32
L2_BYTES = 50e6
# (label, m, k, n, trans, out dtype)
SETS = {
    "decode": [("qwen q/o", 4, 2048, 2048, "nn", BF16),
               ("qwen k/v", 4, 2048, 1024, "nn", BF16),
               ("qwen down", 4, 6144, 2048, "nn", BF16),
               ("qwen unembed", 4, 2048, 151936, "nt", F32),
               ("mixtral q/o", 4, 4096, 4096, "nn", BF16),
               ("llama4 q/o", 4, 5120, 5120, "nn", BF16),
               ("llama4 router", 4, 5120, 16, "nn", F32)],
    # The bucket prefills' projections (4 slots x 32 or 64 rows): small
    # grids, where the model's TC_SM_BW_SHARES decides tensor cores or FMA.
    "prefill": [("qwen q/o", 128, 2048, 2048, "nn", BF16),
                ("qwen k/v", 128, 2048, 1024, "nn", BF16),
                ("qwen down", 128, 6144, 2048, "nn", BF16),
                ("qwen down", 256, 6144, 2048, "nn", BF16),
                ("mixtral k/v", 128, 4096, 1024, "nn", BF16),
                ("llama4 k/v", 128, 5120, 1024, "nn", BF16)],
    "train": [("qwen fwd q/o", 1024, 2048, 2048, "nn", BF16),
              ("qwen fwd down", 1024, 6144, 2048, "nn", BF16),
              ("qwen dW tn", 2048, 1024, 6144, "tn", BF16),
              ("qwen dX nt", 1024, 6144, 2048, "nt", BF16),
              ("qwen unembed", 1024, 2048, 151936, "nt", F32)],
}


def variants(m, k, n, trans, out):
    """(name, fn(a, b)) for every body that can take the shape."""
    out_bytes = torch.tensor([], dtype=out).element_size()
    planned = plan_gemm(m, k, n, 2, out_bytes)
    fma = plan_gemm(m, k, n, 2, out_bytes, a_ok=False, b_ok=False)
    vs = [(f"planned {planned.body} {planned.bm}x{planned.bn}x{planned.bk}"
           f" ks={planned.kslices}", dict(planned.kernel_kwargs())),
          (f"fma {fma.bm}x{fma.bn}x{fma.bk}", dict(fma.kernel_kwargs()))]
    for bm, bn, bk in K.TC_TILES:
        for order in ("mn", "nm"):
            vs.append((f"tc {bm}x{bn} {order}", dict(
                bm=bm, bn=bn, bk=bk, dim_order=order, body="tc")))
    if m <= K.STREAM_ROWS[-1]:
        rows = K.stream_rows(m)
        for want in (1, 2, 4, 8, 16, 32, 64):
            sl, slices = K.stream_slice(k, want)
            if rows * sl * 2 <= K.STREAM_SMEM and want == slices:
                vs.append((f"stream ks={slices}", dict(
                    bm=rows, bn=K.STREAM_STRIP, bk=sl, body="stream",
                    kslices=slices)))
    for name, kw in vs:
        kw.pop("nsplit", None)
        yield name, (lambda a, b, kw=kw: K.ftimm_gemm(
            a, b, trans=trans, out_dtype=out, **kw))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", choices=sorted(SETS), nargs="+",
                    default=sorted(SETS))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_gemm needs a CUDA card")
    dev = torch.device("cuda", 0)
    K.build(["ftimm_gemm"])
    sleep_ms = sleep_ms_per_mcycle()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for set_name in args.set:
        for label, m, k, n, trans, out in SETS[set_name]:
            sa = (k, m) if trans == "tn" else (m, k)
            sb = (n, k) if trans == "nt" else (k, n)
            nbytes = 2 * (m * k + k * n) + m * n * out.itemsize
            copies = min(max(math.ceil(3 * L2_BYTES / nbytes), 1), 64)
            inputs = [(torch.randn(sa, generator=gen, device=dev).to(BF16),
                       torch.randn(sb, generator=gen, device=dev).to(BF16))
                      for _ in range(copies)]
            reps = max(args.reps, copies)
            ref = None
            for name, fn in [*variants(m, k, n, trans, out),
                             ("torch.matmul", lambda a, b: torch.matmul(
                                 a.t() if trans == "tn" else a,
                                 b.t() if trans == "nt" else b))]:
                got = fn(*inputs[0]).float()
                ref = got if ref is None else ref
                err = ((got - ref).abs().max() / ref.abs().max()).item()
                ms = time_ms(fn, inputs, reps, sleep_ms)
                rows.append({"set": set_name, "shape": label, "m": m, "k": k,
                             "n": n, "trans": trans, "variant": name,
                             "us": ms * 1e3, "normwise_vs_first": err})
                print(f"{label:14s} {m}x{k}x{n} {trans}  {name:32s} "
                      f"{ms * 1e3:9.1f} us  (vs first {err:.1e})",
                      flush=True)
            del inputs
            torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "rows": rows}))


if __name__ == "__main__":
    main()
