"""Time the bodies of ``ftimm_gemm`` at the main path's shapes on the card:
the stream body at each K slice count, the tensor-core tiles in both grid
orders, the FMA body's planned tile, the planner's own choice, and
``torch.matmul`` as the yardstick.  The same sets time qwen3-1.7b's dense
gate/up pair (``ftimm_gemm_swiglu``: the group stream at each slice count,
the pair tile in both grid orders, the FMA body) beside two ``matmul`` and
the elementwise silu(g) * u, and the ``train`` set split-K at qwen's dW
shapes (``ftimm_gemm_splitk``'s tensor-core and FMA bodies at nsplit 1-8;
nsplit 1 is ``ftimm_gemm``) beside ``matmul``.  The ``moe`` set does the
same for
``ftimm_gemm_grouped`` and ``ftimm_gemm_ragged`` at the MoE expert-down
shapes of decode, prefill and training (mixtral's capacity buffers,
llama4's routed rows): the FMA body, the tensor-core tile, the weight
stream at each slice count, ``ftimm_gemm``'s register stream launched
once per reached group, beside ``torch.bmm`` /
``torch._grouped_mm``; and for their SwiGLU pairs at the gate/up shapes
every body and slice count beside two such library calls (one per panel)
and the elementwise silu(g) * u.  The ``attention`` set times
``ftimm_gemm_grouped``'s fp32 decode attention products (QK^T "nt" and PV
"nn" of qwen3-1.7b, zamba2-7b, whisper-base's self and cross attention,
llava-next-34b and gemma3-4b at 4 slots): the planned rows body, the rows
body at other cuts (cache-row strips for "nt", column-strip widths and K
slice counts for "nn"),
the FMA body's planned tile, beside ``torch.bmm``.  It is the measurement
the planner's stream and tensor-core constants (``core/gemm/cmr.py``) and
the rows body's cut (``kernel.rows_tile``) are checked against.

    PYTHONPATH=src python -m repro_torch.launch.sweep_gemm [--set decode|prefill|train|moe|attention]

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
import subprocess
from dataclasses import replace

import torch

import numpy as np

from ..core.gemm import plan_batched_gemm, plan_gemm, plan_ragged_gemm
from ..kernels.ftimm import kernel as K
from ..kernels.ftimm import ops
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


# qwen3-1.7b's dense gate/up pair, x (m, 2048) against two (2048, 6144)
# panels: (label, m, k, n, out dtype), and the split-K products of its
# training dW, tn (k = 1024 tokens): (label, m, k, n).
PAIRS = {"decode": [("qwen gate/up", 4, 2048, 6144, BF16)],
         "prefill": [("qwen gate/up", 128, 2048, 6144, BF16),
                     ("qwen gate/up", 256, 2048, 6144, BF16)],
         "train": [("qwen gate/up", 1024, 2048, 6144, BF16)]}
SPLITK = {"train": [("qwen dW q/o", 2048, 1024, 2048),
                    ("qwen dW gate/up", 2048, 1024, 6144)]}


def pair_dense_variants(m, k, n, out):
    """(name, fn(x, wg, wu)) of the dense pair: the planned body, the FMA
    tile, the pair tile in both grid orders, the stream at each slice
    count, and two ``matmul`` plus silu(g) * u."""
    ob = out.itemsize
    planned = plan_gemm(m, k, n, 2, ob, panels=2)
    fma = plan_gemm(m, k, n, 2, ob, panels=2, a_ok=False)
    allowed = K.gemm_bodies(2, 2, m, True, True, panels=2)
    vs = [(f"planned {planned.body} {planned.bm}x{planned.bn}x{planned.bk}"
           f" {planned.dim_order} ks={planned.kslices}", planned),
          (f"fma {fma.bm}x{fma.bn}x{fma.bk}", fma)]
    if "tc" in allowed:
        bm, bn, bk = K.GROUP_TC_TILE
        for order in ("mn", "nm"):
            vs.append((f"tc {bm}x{bn} {order}", dict(
                bm=bm, bn=bn, bk=bk, body="tc", dim_order=order)))
    if "stream" in allowed:
        for want in (1, 2, 4, 8, 16):
            sl, slices = K.stream_slice(k, want)
            if want == slices:
                vs.append((f"stream ks={slices}",
                           dict(bm=K.GSTREAM_ROWS, bn=K.STREAM_STRIP, bk=sl,
                                body="stream", kslices=slices)))
    for name, kw in vs:
        if not isinstance(kw, dict):
            kw = dict(bm=kw.bm, bn=kw.bn, bk=kw.bk, body=kw.body,
                      kslices=kw.kslices, dim_order=kw.dim_order)
        yield name, (lambda x, wg, wu, kw=kw: K.ftimm_gemm_swiglu(
            x, wg, wu, out_dtype=out, **kw))
    yield "torch.matmul x2 + silu(g) * u", lambda x, wg, wu: (
        torch.nn.functional.silu(torch.matmul(x, wg).float())
        * torch.matmul(x, wu).float()).to(out)


def splitk_variants(m, k, n):
    """(name, fn(a, b)) of split-K at a tn dW shape: the tensor-core (128 x
    128 tile) and FMA bodies at nsplit 1, 2, 4, 8 through ``ops.gemm``
    (nsplit 1 runs ``ftimm_gemm``), and ``torch.matmul``."""
    fma = ops.clamp_tile(m, n, 128, 128)
    for body, tile in (("tc", K.TC_TILES[0]), ("fma", fma)):
        for ns in (1, 2, 4, 8):
            bm, bn, bk = tile
            yield (f"{body} {bm}x{bn}x{bk} nsplit {ns}",
                   lambda a, b, body=body, ns=ns, bm=bm, bn=bn, bk=bk:
                   ops.gemm(a, b, bm=bm, bn=bn, bk=bk, trans="tn", nsplit=ns,
                            body=body))
    yield "torch.matmul", lambda a, b: torch.matmul(a.t(), b)


def time_variants(set_name, label, meta, make, variants, reps, gen,
                  sleep_ms) -> list[dict]:
    """Time each (name, fn) of ``variants`` on operands from ``make(gen)``,
    rotated through more copies than the L2 holds; one row each, with its
    normwise distance from the first variant's output."""
    inputs = [make(gen)]
    nbytes = sum(t.numel() * t.element_size() for t in inputs[0])
    while len(inputs) * nbytes < 3 * L2_BYTES and len(inputs) < 64:
        inputs.append(make(gen))
    reps = max(reps, len(inputs))
    rows, ref = [], None
    for name, fn in variants:
        got = fn(*inputs[0]).float()
        ref = got if ref is None else ref
        err = ((got - ref).abs().max() / ref.abs().max()).item()
        ms = time_ms(fn, inputs, reps, sleep_ms)
        rows.append({"set": set_name, "shape": label, **meta,
                     "variant": name, "us": ms * 1e3,
                     "normwise_vs_first": err})
        dims = "x".join(str(meta[d]) for d in ("m", "k", "n"))
        print(f"{label:16s} {dims} {meta.get('trans', ''):2s}  {name:34s} "
              f"{ms * 1e3:9.1f} us  (vs first {err:.1e})", flush=True)
    del inputs
    torch.cuda.empty_cache()
    return rows


# The MoE expert-down products: (label, kind, groups or routed sizes, rows
# a group, k, n, trans).  mixtral: 8 experts, capacity 16 at decode (4
# slots), 48 / 80 at the bucket prefills of 32 / 64 tokens a slot, 320 in
# training (8 x 128 tokens, top-2); training also runs the dX ("nt") and dW
# ("tn").  llama4: 16 experts, top-1, 4 decode rows to 4 experts, 256
# prefill rows and 1024 training rows routed at random (seed 5 / 7); its
# training runs the forward, the fp32 remat of the gate / up pair and the
# dX ("nt").
_L4 = 16


def _routed(total, seed):
    return np.random.default_rng(seed).multinomial(
        total, [1.0 / _L4] * _L4).tolist()


MOE = [("mixtral decode down", "grouped", 8, 16, 14336, 4096, "nn", BF16),
       ("mixtral bucket32 down", "grouped", 8, 48, 14336, 4096, "nn", BF16),
       ("mixtral bucket64 down", "grouped", 8, 80, 14336, 4096, "nn", BF16),
       ("mixtral train down", "grouped", 8, 320, 14336, 4096, "nn", BF16),
       ("mixtral train down dX", "grouped", 8, 320, 4096, 14336, "nt", BF16),
       ("mixtral train down dW", "grouped", 8, 14336, 320, 4096, "tn", BF16),
       ("llama4 decode down", "ragged", [1, 0, 0, 0] * 4, 0, 8192, 5120,
        "nn", BF16),
       ("llama4 bucket64 down", "ragged", _routed(256, 5), 0, 8192, 5120,
        "nn", BF16),
       ("llama4 train down", "ragged", _routed(1024, 7), 0, 8192, 5120, "nn",
        BF16),
       ("llama4 train gate remat", "ragged", _routed(1024, 7), 0, 5120, 8192,
        "nn", F32),
       ("llama4 train down dX", "ragged", _routed(1024, 7), 0, 5120, 8192,
        "nt", BF16),
       # The gate/up pairs: x (rows, 4096 / 5120) against two panels.
       ("mixtral decode gate/up", "grouped_swiglu", 8, 16, 4096, 14336, "nn",
        BF16),
       ("mixtral bucket32 gate/up", "grouped_swiglu", 8, 48, 4096, 14336,
        "nn", BF16),
       ("mixtral bucket64 gate/up", "grouped_swiglu", 8, 80, 4096, 14336,
        "nn", BF16),
       ("mixtral train gate/up", "grouped_swiglu", 8, 320, 4096, 14336, "nn",
        BF16),
       ("llama4 decode gate/up", "ragged_swiglu", [1, 0, 0, 0] * 4, 0, 5120,
        8192, "nn", BF16),
       ("llama4 bucket64 gate/up", "ragged_swiglu", _routed(256, 5), 0, 5120,
        8192, "nn", BF16),
       ("llama4 train gate/up", "ragged_swiglu", _routed(1024, 7), 0, 5120,
        8192, "nn", BF16)]


def moe_inputs(kind, groups, m, k, n, trans, gen, dev):
    """One set of operands: grouped (a, b); ragged (x, w, offsets); the
    pairs (x, w_gate, w_up[, offsets])."""
    if kind.endswith("swiglu"):
        g = groups if kind == "grouped_swiglu" else len(groups)
        rows = (g, m) if kind == "grouped_swiglu" else (sum(groups),)
        x = torch.randn((*rows, k), generator=gen, device=dev).to(BF16)
        wg, wu = ((torch.randn((g, k, n), generator=gen, device=dev)
                   * k ** -0.5).to(BF16) for _ in range(2))
        if kind == "grouped_swiglu":
            return x, wg, wu
        return x, wg, wu, torch.tensor([0, *np.cumsum(groups).tolist()],
                                       dtype=torch.int32, device=dev)
    if kind == "grouped":
        sa = (groups, k, m) if trans == "tn" else (groups, m, k)
        sb = (groups, n, k) if trans == "nt" else (groups, k, n)
        return (torch.randn(sa, generator=gen, device=dev).to(BF16),
                (torch.randn(sb, generator=gen, device=dev)
                 * k ** -0.5).to(BF16))
    t = sum(groups)
    w_shape = (len(groups), k, n) if trans == "nn" else (len(groups), n, k)
    offs = torch.tensor([0, *np.cumsum(groups).tolist()], dtype=torch.int32,
                        device=dev)
    return (torch.randn((t, k), generator=gen, device=dev).to(BF16),
            (torch.randn(w_shape, generator=gen, device=dev)
             * k ** -0.5).to(BF16), offs)


def pair_variants(kind, groups, m, k, n, out):
    """(name, fn(*inputs)) of a SwiGLU pair: every body and slice count
    that can take the shape, and two library calls plus silu(g) * u."""
    ob = out.itemsize
    if kind == "grouped_swiglu":
        g, rows = groups, m
        planned = plan_batched_gemm(g, m, k, n, 2, ob, "none", panels=2)
        fma = plan_batched_gemm(g, m, k, n, 2, ob, "none", panels=2,
                                a_major=None)
        allowed = K.grouped_bodies(2, 2, m, "k", True)
        kern = K.ftimm_gemm_grouped_swiglu
    else:
        g, rows = len(groups), sum(groups)
        planned = plan_ragged_gemm(g, rows, k, n, 2, ob, panels=2)
        fma = plan_ragged_gemm(g, rows, k, n, 2, ob, panels=2, a_ok=False)
        allowed = K.ragged_bodies(2, 2, rows, True, True)
        kern = K.ftimm_gemm_ragged_swiglu
    vs = [(f"planned {planned.body} {planned.bm}x{planned.bn}x{planned.bk}"
           f" ks={planned.kslices}", planned),
          (f"fma {fma.bm}x{fma.bn}x{fma.bk}", fma)]
    if "tc" in allowed:
        bm, bn, bk = K.GROUP_TC_TILE
        vs.append((f"tc {bm}x{bn}", dict(bm=bm, bn=bn, bk=bk, body="tc")))
    if "stream" in allowed:
        for want in (1, 2, 4, 8, 16):
            sl, slices = K.stream_slice(k, want)
            if want == slices:
                vs.append((f"stream ks={slices}",
                           dict(bm=K.GSTREAM_ROWS, bn=K.STREAM_STRIP, bk=sl,
                                body="stream", kslices=slices)))
    for name, kw in vs:
        if not isinstance(kw, dict):
            kw = dict(bm=kw.bm, bn=kw.bn, bk=kw.bk, body=kw.body,
                      kslices=kw.kslices)
        yield name, (lambda *ins, kw=kw: kern(*ins, out_dtype=out, **kw))

    def silu_mul(gv, uv):
        return (torch.nn.functional.silu(gv.float()) * uv.float()).to(out)
    if kind == "grouped_swiglu":
        yield "torch.bmm x2 + silu(g) * u", lambda x, wg, wu: silu_mul(
            torch.bmm(x, wg), torch.bmm(x, wu))
    else:
        yield ("torch._grouped_mm x2 + silu(g) * u",
               lambda x, wg, wu, offs: silu_mul(
                   torch._grouped_mm(x, wg, offs=offs[1:]),
                   torch._grouped_mm(x, wu, offs=offs[1:])))


def moe_variants(kind, groups, m, k, n, trans, out):
    """(name, fn(*inputs)) for every body and slice count that can take
    the shape, ftimm_gemm's register stream once per reached group, and the
    library call."""
    if kind.endswith("swiglu"):
        yield from pair_variants(kind, groups, m, k, n, out)
        return
    ob = out.itemsize
    if kind == "grouped":
        g, rows = groups, m
        major = "mn" if trans == "tn" else "k"
        planned = plan_batched_gemm(g, m, k, n, 2, ob, "none", b_bytes=2,
                                    a_major=major)
        fma = plan_batched_gemm(g, m, k, n, 2, ob, "none", a_major=None)
        allowed = K.grouped_bodies(2, 2, m, major, True)
        kern = K.ftimm_gemm_grouped
    else:
        g, rows = len(groups), sum(groups)
        planned = plan_ragged_gemm(g, rows, k, n, 2, ob)
        fma = plan_ragged_gemm(g, rows, k, n, 2, ob, a_ok=False)
        allowed = K.ragged_bodies(2, 2, rows, True, True)
        kern = K.ftimm_gemm_ragged
    vs = [(f"planned {planned.body} {planned.bm}x{planned.bn}x{planned.bk}"
           f" ks={planned.kslices}", dict(planned.kernel_kwargs())),
          (f"fma {fma.bm}x{fma.bn}x{fma.bk}", dict(fma.kernel_kwargs()))]
    if "tc" in allowed:
        bm, bn, bk = K.GROUP_TC_TILE
        for order in (("mn", "nm") if kind == "grouped" else ("mn",)):
            vs.append((f"tc {bm}x{bn} {order}", dict(
                bm=bm, bn=bn, bk=bk, dim_order=order, body="tc")))
    if "stream" in allowed:
        for want in (1, 2, 4, 8, 16):
            sl, slices = K.stream_slice(k, want)
            if want != slices:
                continue
            vs.append((f"stream ks={slices}",
                       dict(bm=K.GSTREAM_ROWS, bn=K.STREAM_STRIP, bk=sl,
                            body="stream", kslices=slices)))
    for name, kw in vs:
        kw.pop("nsplit", None)
        if kind == "ragged":
            kw.pop("dim_order", None)
        yield name, (lambda *ins, kw=kw: kern(*ins, trans=trans,
                                               out_dtype=out, **kw))
    if "stream" in allowed:
        # ftimm_gemm's register stream body, one launch per reached group.
        plan = plan_gemm(rows if kind == "grouped" else 1, k, n, 2, ob)
        kw = dict(bm=plan.bm, bn=plan.bn, bk=plan.bk, body="stream",
                  kslices=plan.kslices, trans=trans, out_dtype=out)
        if kind == "grouped":
            yield (f"ftimm_gemm stream x{g} ks={plan.kslices}",
                   lambda a, b: torch.stack([K.ftimm_gemm(a[i], b[i], **kw)
                                             for i in range(g)]))
        else:
            bounds = np.cumsum([0, *groups]).tolist()
            reached = [i for i in range(g) if groups[i]]

            def per_group(x, w, offs):
                y = torch.zeros((rows, n), dtype=out, device=x.device)
                for i in reached:
                    lo, hi = bounds[i], bounds[i + 1]
                    y[lo:hi] = K.ftimm_gemm(x[lo:hi], w[i], **kw)
                return y
            yield f"ftimm_gemm stream x{len(reached)} ks={plan.kslices}", \
                per_group
    if kind == "grouped":
        yield "torch.bmm", lambda a, b: torch.bmm(
            a.transpose(1, 2) if trans == "tn" else a,
            b.transpose(1, 2) if trans == "nt" else b).to(out)
    elif trans == "nn":
        yield "torch._grouped_mm", lambda x, w, offs: torch._grouped_mm(
            x, w, offs=offs[1:]).to(out)


def moe_rows(args, gen, dev, sleep_ms) -> list[dict]:
    rows = []
    for label, kind, groups, m, k, n, trans, out in MOE:
        inputs = [moe_inputs(kind, groups, m, k, n, trans, gen, dev)]
        nbytes = sum(t.numel() * t.element_size() for t in inputs[0])
        while len(inputs) * nbytes < 3 * L2_BYTES and len(inputs) < 64:
            inputs.append(moe_inputs(kind, groups, m, k, n, trans, gen, dev))
        reps = max(args.reps, len(inputs))
        ref = None
        for name, fn in moe_variants(kind, groups, m, k, n, trans, out):
            try:
                got = fn(*inputs[0]).float()
            except (RuntimeError, TypeError, ValueError) as e:
                print(f"{label:24s} {name:32s} skipped: "
                      f"{str(e).splitlines()[0][:100]}", flush=True)
                continue
            ref = got if ref is None else ref
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            ms = time_ms(fn, inputs, reps, sleep_ms)
            rows.append({"set": "moe", "shape": label, "kind": kind,
                         "groups": groups, "m": m, "k": k, "n": n,
                         "trans": trans, "variant": name, "us": ms * 1e3,
                         "normwise_vs_first": err})
            print(f"{label:24s} {kind} {m}x{k}x{n} {trans}  {name:34s} "
                  f"{ms * 1e3:9.1f} us  (vs first {err:.1e})", flush=True)
        del inputs
        torch.cuda.empty_cache()
    return rows


# The decode attention products at 4 slots, fp32, one group a (slot, KV
# head): (label, groups, query rows a group, head_dim, cache rows); gemma
# also over a short history (``profile_serve``'s 48-row view).
ATTENTION = [("qwen3-1.7b", 32, 2, 128, 96),
             ("zamba2-7b shared", 128, 1, 112, 320),
             ("whisper-base self", 32, 1, 64, 320),
             ("whisper-base cross", 32, 1, 64, 1024),
             ("llava-next-34b", 32, 7, 128, 896),
             ("gemma3-4b", 16, 2, 256, 1120),
             ("gemma3-4b short", 16, 2, 256, 48)]


def attention_variants(g, m, k, n, trans):
    """(name, fn(a, b)): the planned body, the rows body at other cuts,
    the FMA body's planned tile, ``torch.bmm``."""
    planned = plan_batched_gemm(g, m, k, n, 4, 4, "none", trans=trans)
    fma = plan_batched_gemm(g, m, k, n, 4, 4, "none", trans=trans,
                            b_rows=False)
    if trans == "nt":
        width = K.rows_width(k)
        cuts = [(f"rows strip {s}", (K.ROWS_MAX, s, width))
                for s in (16, 32, 64, 128) if s < n]
    else:
        cuts = [(f"rows {w}-wide, {sl} slices", (K.ROWS_MAX, w, -(-k // sl)))
                for w in K.ROWS_WIDTHS if w <= K.rows_width(n)
                for sl in (1, 2, 4, 8, 16) if -(-k // sl) >= 16]
    plans = [(f"planned {planned.body} {planned.bm}x{planned.bn}x"
              f"{planned.bk}", planned)]
    plans += [(name, replace(planned, body="rows", bm=t[0], bn=t[1], bk=t[2]))
              for name, t in cuts]
    plans.append((f"fma {fma.bm}x{fma.bn}x{fma.bk} {fma.dim_order}", fma))
    for name, plan in plans:
        kw = plan.kernel_kwargs()
        kw.pop("nsplit")
        yield name, (lambda a, b, kw=kw: ops.batched_gemm(
            a, b, trans=trans, out_dtype=F32, **kw))
    yield "torch.bmm", lambda a, b: torch.bmm(
        a, b.transpose(1, 2) if trans == "nt" else b)


def attention_rows(args, gen, dev, sleep_ms) -> list[dict]:
    rows = []
    for label, g, m, hd, s in ATTENTION:
        for trans, k, n in (("nt", hd, s), ("nn", s, hd)):
            sb = (g, n, k) if trans == "nt" else (g, k, n)

            def make(gen, sb=sb, k=k):
                return (torch.randn(g, m, k, generator=gen, device=dev),
                        torch.randn(sb, generator=gen, device=dev))
            rows += time_variants(
                "attention", label, dict(m=m, k=k, n=n, trans=trans,
                                         groups=g), make,
                attention_variants(g, m, k, n, trans), args.reps, gen,
                sleep_ms)
    return rows


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
    ap.add_argument("--set", choices=sorted([*SETS, "moe", "attention"]),
                    nargs="+", default=sorted([*SETS, "moe", "attention"]))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_gemm needs a CUDA card")
    dev = torch.device("cuda", 0)
    K.build()
    sleep_ms = sleep_ms_per_mcycle()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for set_name in args.set:
        if set_name == "moe":
            rows += moe_rows(args, gen, dev, sleep_ms)
            continue
        if set_name == "attention":
            rows += attention_rows(args, gen, dev, sleep_ms)
            continue
        for label, m, k, n, trans, out in SETS[set_name]:
            sa = (k, m) if trans == "tn" else (m, k)
            sb = (n, k) if trans == "nt" else (k, n)

            def make(g, sa=sa, sb=sb):
                return (torch.randn(sa, generator=g, device=dev).to(BF16),
                        torch.randn(sb, generator=g, device=dev).to(BF16))
            rows += time_variants(
                set_name, label, dict(m=m, k=k, n=n, trans=trans), make,
                [*variants(m, k, n, trans, out),
                 ("torch.matmul", lambda a, b, trans=trans: torch.matmul(
                     a.t() if trans == "tn" else a,
                     b.t() if trans == "nt" else b))],
                args.reps, gen, sleep_ms)
        for label, m, k, n, out in PAIRS.get(set_name, ()):
            def make(g, m=m, k=k, n=n):
                return (torch.randn(m, k, generator=g, device=dev).to(BF16),
                        *((torch.randn(k, n, generator=g, device=dev)
                           * k ** -0.5).to(BF16) for _ in range(2)))
            rows += time_variants(set_name, label,
                                  dict(m=m, k=k, n=n, kind="swiglu"), make,
                                  pair_dense_variants(m, k, n, out),
                                  args.reps, gen, sleep_ms)
        for label, m, k, n in SPLITK.get(set_name, ()):
            def make(g, m=m, k=k, n=n):
                return (torch.randn(k, m, generator=g, device=dev).to(BF16),
                        (torch.randn(k, n, generator=g, device=dev)
                         * k ** -0.5).to(BF16))
            rows += time_variants(set_name, label,
                                  dict(m=m, k=k, n=n, trans="tn",
                                       kind="splitk"), make,
                                  splitk_variants(m, k, n), args.reps, gen,
                                  sleep_ms)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "rows": rows}))


if __name__ == "__main__":
    main()
