#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the ftIMM serving stack on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, nvcc (PATH or
/usr/local/cuda/bin) and no network.  Phases, in order:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the three ftIMM kernels from src/repro_torch/kernels/ftimm/csrc;
3. hold each kernel against its plain PyTorch version on the card: the
   shapes serving qwen3-1.7b gives it (decode at 4 slots, and a 64-token
   bucket prefill), unaligned shapes, every trans, the residual epilogue and
   the shared 2-D operand.  Normwise tolerance max|kernel - plain| /
   max|plain|: 2e-2 for a bf16 output (2^-8 is one bf16 ulp), 1e-4 for
   fp32 (the same fp32 products summed in another order);
4. a small-input reference: qwen3-1.7b-smoke in fp32, its weights on the card
   and on the CPU (where every GEMM takes the plain version): prefill logits
   within 1e-4 normwise and the same greedy tokens from ServeEngine;
5. serve qwen3-1.7b at full width and depth (28 layers, random weights from
   seed 0, bf16) through ServeEngine: 6 greedy requests over 4 slots,
   prompts in two length buckets, 16 new tokens each.  The kernels' launch
   counts are zeroed just before the run and read just after; every kernel
   must have launched.  Then one prompt's full-width prefill logits are held
   against the plain versions on the CPU (5e-2 normwise: 28 bf16 layers,
   each of whose activations may round one bf16 ulp apart);
6. time each kernel at the decode-step shapes (CUDA events around calls
   enqueued behind a sleep kernel, so the card runs them back to back;
   operands rotated through more copies than the 50 MB L2 holds) beside its plain
   version, one PyTorch library call where one computes the same function,
   and its bound: the larger of bytes / 3.35 TB/s and operations / peak
   (989 TFLOP/s bf16, 67 TFLOP/s fp32; NVIDIA's H100 SXM data sheet).

It prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` as
the last line.  Any failure raises and exits non-zero before that line.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gemm import batched_matmul, matmul, matmul_swiglu  # noqa: E402
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

BF16, FP32 = torch.bfloat16, torch.float32
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {BF16: 989e12, FP32: 67e12}
TOL = {BF16: 2e-2, FP32: 1e-4}
REPLACES = {"ftimm_gemm": "src/repro/kernels/ftimm/kernel.py:202",
            "ftimm_gemm_swiglu": "src/repro/kernels/ftimm/kernel.py:872",
            "ftimm_gemm_grouped": "src/repro/kernels/ftimm/kernel.py:322"}
ARCH = "qwen3-1.7b"
SLOTS, NEW_TOKENS, PAGE, MAX_LEN = 4, 16, 16, 96
PROMPT_LENS = (24, 24, 24, 50, 50, 50)     # buckets 32 and 64
L2_BYTES = 50e6


def log(*args) -> None:
    print(*args, flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(normwise relative error, max abs error); raises on non-finite."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"bad output {tuple(got.shape)} vs "
                             f"{tuple(want.shape)} or non-finite")
    err = (got - want).abs().max().item()
    return err / max(want.abs().max().item(), 1e-30), err


# ---------------------------------------------------------------------------
# Kernel cases: inputs, the kernel path, the plain version, a library call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Case:
    kernel: str
    label: str
    make: object            # gen -> tuple of input tensors
    run: object             # inputs -> output, through core.gemm
    plain: object           # inputs -> output, the plain version
    library: object | None  # inputs -> output, one PyTorch call
    nbytes: int             # each input read once, each output written once
    flops: float
    dtype: torch.dtype      # the operands' type (picks the peak)
    out_dtype: torch.dtype
    per_step: int = 0       # launches in one decode step (0: check only)


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def dense_case(label, m, k, n, *, trans="nn", dtype=BF16, out=None,
               residual=False, per_step=0) -> Case:
    out = out or dtype
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    epi = Epilogue(residual=True) if residual else None

    def make(gen):
        res = _randn(gen, (m, n), dtype) if residual else None
        return (_randn(gen, sa, dtype), _randn(gen, sb, dtype, k ** -0.5),
                res)

    def ops(a, b):
        return (a.t() if trans == "tn" else a, b.t() if trans == "nt" else b)

    def library(a, b, res):
        a, b = ops(a, b)
        return torch.matmul(a, b) if res is None else torch.addmm(res, a, b)

    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = ((m * k + k * n + (m * n if residual else 0)) * size
              + m * n * torch.tensor([], dtype=out).element_size())
    return Case(
        "ftimm_gemm", label, make,
        lambda a, b, r: matmul(a, b, trans=trans, out_dtype=out,
                               epilogue=epi, residual=r),
        lambda a, b, r: K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out,
                                           epilogue=epi or K.IDENTITY,
                                           residual=r),
        library, nbytes, 2.0 * m * n * k, dtype, out, per_step)


def swiglu_case(label, m, k, n, *, dtype=BF16, per_step=0) -> Case:
    def make(gen):
        return (_randn(gen, (m, k), dtype),
                _randn(gen, (k, n), dtype, k ** -0.5),
                _randn(gen, (k, n), dtype, k ** -0.5))

    size = torch.tensor([], dtype=dtype).element_size()
    return Case("ftimm_gemm_swiglu", label, make,
                lambda x, g, u: matmul_swiglu(x, g, u),
                lambda x, g, u: K.ftimm_gemm_swiglu_plain(x, g, u),
                None, (m * k + 2 * k * n + m * n) * size,
                4.0 * m * n * k, dtype, dtype, per_step)


def grouped_case(label, g, m, k, n, *, trans="nn", shared="none",
                 per_step=0) -> Case:
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]

    def make(gen):
        a = _randn(gen, sa if shared == "a" else (g,) + sa, FP32)
        b = _randn(gen, sb if shared == "b" else (g,) + sb, FP32)
        return a, b

    def library(a, b):
        a = a.transpose(-1, -2) if trans == "tn" else a
        b = b.transpose(-1, -2) if trans == "nt" else b
        return torch.matmul(a, b)

    ga, gb = (1 if shared == "a" else g), (1 if shared == "b" else g)
    return Case("ftimm_gemm_grouped", label, make,
                lambda a, b: batched_matmul(a, b, trans=trans,
                                            out_dtype=FP32),
                lambda a, b: K.ftimm_gemm_grouped_plain(a, b, trans=trans,
                                                        out_dtype=FP32),
                library, 4 * (ga * m * k + gb * k * n + g * m * n),
                2.0 * g * m * n * k, FP32, FP32, per_step)


def main_path_cases(cfg, view_len: int, bucket: int) -> list[Case]:
    """Every GEMM shape of one decode step at SLOTS slots (with its launch
    count), and of one bucket prefill."""
    d, f, v, n_layers = cfg.d_model, cfg.d_ff, cfg.vocab_padded, cfg.num_layers
    hq, hkv = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    hd, groups = cfg.head_dim_, SLOTS * cfg.num_kv_heads
    qpg = cfg.num_heads // cfg.num_kv_heads        # query rows per kv head
    rows = SLOTS * bucket
    return [
        dense_case("decode q", SLOTS, d, hq, per_step=n_layers),
        dense_case("decode k/v", SLOTS, d, hkv, per_step=2 * n_layers),
        dense_case("decode o+res", SLOTS, hq, d, residual=True,
                   per_step=n_layers),
        dense_case("decode down+res", SLOTS, f, d, residual=True,
                   per_step=n_layers),
        dense_case("decode unembed", SLOTS, d, v, trans="nt", out=FP32,
                   per_step=1),
        swiglu_case("decode gate/up", SLOTS, d, f, per_step=n_layers),
        grouped_case("decode qk^T", groups, qpg, hd, view_len, trans="nt",
                     per_step=n_layers),
        grouped_case("decode pv", groups, qpg, view_len, hd,
                     per_step=n_layers),
        dense_case("prefill q", rows, d, hq),
        dense_case("prefill k/v", rows, d, hkv),
        dense_case("prefill o+res", rows, hq, d, residual=True),
        dense_case("prefill down+res", rows, f, d, residual=True),
        swiglu_case("prefill gate/up", rows, d, f),
        grouped_case("prefill qk^T", groups, bucket * qpg, hd, bucket,
                     trans="nt"),
        grouped_case("prefill pv", groups, bucket * qpg, bucket, hd),
    ]


def edge_cases() -> list[Case]:
    """Unaligned shapes, every trans, the residual epilogue, shared operand."""
    cases = []
    for trans in ("nn", "tn", "nt"):
        for dtype in (BF16, FP32):
            cases.append(dense_case(f"33x257x65 {trans} {dtype}", 33, 257,
                                    65, trans=trans, dtype=dtype))
        cases.append(grouped_case(f"5x33x129x65 {trans} shared a", 5, 33,
                                  129, 65, trans=trans, shared="a"))
        cases.append(grouped_case(f"5x33x129x65 {trans} shared b", 5, 33,
                                  129, 65, trans=trans, shared="b"))
    cases.append(dense_case("33x257x65 residual", 33, 257, 65,
                            residual=True))
    cases.append(dense_case("33x257x65 bf16->fp32", 33, 257, 65, out=FP32))
    cases.append(swiglu_case("33x257x65", 33, 257, 65))
    cases.append(swiglu_case("33x257x65 fp32", 33, 257, 65, dtype=FP32))
    return cases


def check(cases: list[Case], dev) -> dict[str, float]:
    """Every case's kernel against its plain version; max abs error per
    kernel.  Raises on a mismatch."""
    worst: dict[str, float] = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for c in cases:
        inputs = c.make(gen)
        got = c.run(*inputs)
        want = c.plain(*inputs)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        if got.dtype != c.out_dtype or rel > TOL[c.out_dtype]:
            raise AssertionError(f"{c.kernel} {c.label}: normwise error "
                                 f"{rel:.3g} > {TOL[c.out_dtype]} "
                                 f"({got.dtype})")
        worst[c.kernel] = max(worst.get(c.kernel, 0.0), err)
        log(f"  ok  {c.kernel:19s} {c.label:28s} normwise {rel:.2e}")
    return worst


def _sleep_ms_per_mcycle() -> float:
    """Device milliseconds of ``torch.cuda._sleep(10**6)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 ** 6)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10


def time_ms(fn, inputs: list[tuple], reps: int,
            sleep_ms_per_mcycle: float) -> float:
    """Mean device milliseconds of one call, cycling through ``inputs``.

    A small GEMM takes less time on the card than its Python call takes on
    the host, so timing a loop of calls would time the host.  The stream is
    first held by a sleep kernel long enough for the host to enqueue every
    call; the events then bracket the calls running back to back."""
    t0 = time.perf_counter()
    for i in range(min(len(inputs), 3)):
        fn(*inputs[i])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / min(len(inputs), 3)
    hold_ms = 2.0 * reps * host_ms + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_ms / sleep_ms_per_mcycle * 10 ** 6))
    t0 = time.perf_counter()
    start.record()
    for i in range(reps):
        fn(*inputs[i % len(inputs)])
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if enqueue_ms > hold_ms:
        raise AssertionError(f"enqueue took {enqueue_ms:.1f} ms, longer "
                             f"than the {hold_ms:.1f} ms hold")
    return start.elapsed_time(end) / reps


def timings(cases: list[Case], dev) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(2)
    sleep_ms = _sleep_ms_per_mcycle()
    rows = []
    for c in cases:
        if not c.per_step:
            continue
        copies = min(max(math.ceil(3 * L2_BYTES / c.nbytes), 1), 64)
        inputs = [c.make(gen) for _ in range(copies)]
        reps = max(20, copies)
        t_bytes = c.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = c.flops / PEAK_FLOPS[c.dtype] * 1e3
        rows.append({
            "kernel": c.kernel, "label": c.label, "per_step": c.per_step,
            "ms": time_ms(c.run, inputs, reps, sleep_ms),
            "plain_ms": time_ms(c.plain, inputs, reps, sleep_ms),
            "library_ms": (None if c.library is None
                           else time_ms(c.library, inputs, reps, sleep_ms)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops})
        del inputs
    return rows


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def small_reference(dev) -> None:
    """qwen3-1.7b-smoke in fp32: the kernels on the card against the plain
    versions on the CPU, same weights."""
    cfg = dataclasses.replace(get_config(ARCH + "-smoke"),
                              compute_dtype="float32")
    cpu_model = M.init_params(cfg, 0, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 12))
    out = {}
    for name, model, device in (("cpu", cpu_model, torch.device("cpu")),
                                ("gpu", gpu_model, dev)):
        batch = {"tokens": torch.as_tensor(toks).to(device)}
        logits, _ = M.prefill(model, cfg, batch,
                              M.make_cache(cfg, 2, 12, device=device))
        prompts = [np.asarray(p, np.int32) for p in toks] + [toks[0, :5]]
        reqs = ServeEngine(cfg, model, batch_slots=2, max_len=32,
                           device=device).run(
            [Request(rid=i, prompt=p, max_new_tokens=6)
             for i, p in enumerate(prompts)])
        out[name] = (logits.cpu(), [r.out_tokens for r in reqs])
    rel, _ = rel_err(out["gpu"][0], out["cpu"][0])
    if rel > 1e-4:
        raise AssertionError(f"smoke prefill logits: normwise {rel:.3g}")
    if out["gpu"][1] != out["cpu"][1]:
        raise AssertionError(f"smoke tokens differ: {out['gpu'][1]} vs "
                             f"{out['cpu'][1]}")
    log(f"  smoke fp32 reference: logits normwise {rel:.2e}, "
        f"{sum(map(len, out['gpu'][1]))} tokens identical")


def serve_full_width(dev) -> tuple[dict, ServeEngine, dict]:
    cfg = get_config(ARCH)
    t0 = time.monotonic()
    model = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    log(f"  {ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim_}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; init "
        f"{time.monotonic() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    engine = ServeEngine(cfg, model, batch_slots=SLOTS, max_len=MAX_LEN,
                         page_size=PAGE, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]

    K.reset_launch_counts()
    t0 = time.monotonic()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = K.launch_counts()

    for r in reqs:
        if not r.done or r.timed_out or len(r.out_tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.rid} did not finish: "
                                 f"{len(r.out_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"request {r.rid}: token out of range")
    if any(engine.faults.values()):
        raise AssertionError(f"engine faults: {engine.faults}")
    if not all(launches[k] > 0 for k in K.KERNELS):
        raise AssertionError(f"a kernel never launched: {launches}")
    engine.alloc.check()

    decode = engine.walls["decode"]
    prefill = {}
    for bkt, s in engine.walls["prefill"]:
        prefill.setdefault(bkt, []).append(s)
    tokens = sum(len(r.out_tokens) for r in reqs)
    stats = {"requests": len(reqs), "tokens": tokens, "wall_s": wall,
             "tokens_per_s": tokens / wall, "decode_steps": len(decode),
             "decode_step_median_ms": statistics.median(decode[1:]) * 1e3,
             "prefill_ms": {str(b): [s * 1e3 for s in v]
                            for b, v in sorted(prefill.items())},
             "buckets": list(engine.buckets),
             "view_len": engine.kv.table.shape[1] * PAGE}
    log(f"  served {len(reqs)} requests, {tokens} tokens in {wall:.2f} s: "
        f"{stats['tokens_per_s']:.1f} tokens/s; {len(decode)} decode steps,"
        f" median {stats['decode_step_median_ms']:.2f} ms (first "
        f"{decode[0] * 1e3:.1f} ms); bucket prefill ms "
        + ", ".join(f"{b}: {[round(x, 1) for x in v]}"
                    for b, v in stats["prefill_ms"].items()))
    log(f"  launches in the serving run: {launches}")
    for r in reqs[:2]:
        log(f"  req {r.rid} ({len(r.prompt)} prompt tokens): {r.out_tokens}")
    return stats, engine, launches


def full_width_reference(engine: ServeEngine, dev) -> float:
    """One prompt's full-width prefill logits: kernels on the card against
    the plain versions on the CPU, same weights."""
    cfg, model = engine.cfg, engine.params
    toks = np.random.default_rng(4).integers(2, cfg.vocab_size, (1, 24))
    gpu, _ = M.prefill(model, cfg, {"tokens": torch.as_tensor(toks).to(dev)},
                       M.make_cache(cfg, 1, 24, device=dev))
    gpu = gpu.cpu()
    model.to("cpu")
    t0 = time.monotonic()
    cpu, _ = M.prefill(model, cfg, {"tokens": torch.as_tensor(toks)},
                       M.make_cache(cfg, 1, 24, device=torch.device("cpu")))
    rel, _ = rel_err(gpu, cpu)
    log(f"  full-width prefill logits, card vs plain on the CPU "
        f"({time.monotonic() - t0:.1f} s): normwise {rel:.2e}, argmax "
        f"{int(gpu.argmax())} vs {int(cpu.argmax())}")
    if rel > 5e-2:
        raise AssertionError(f"full-width logits: normwise {rel:.3g}")
    return rel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 is fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    K.build()
    log(f"[build] {len(K.KERNELS)} kernels in {time.monotonic() - t0:.1f} s")

    cfg = get_config(ARCH)
    view_len = math.ceil(MAX_LEN / PAGE) * PAGE
    cases = main_path_cases(cfg, view_len, bucket=64)
    log("[check] kernels against their plain versions")
    worst = check(cases + edge_cases(), dev)

    log("[reference] small input")
    small_reference(dev)

    log("[serve] full width")
    stats, engine, launches = serve_full_width(dev)
    if stats["view_len"] != view_len:
        raise AssertionError(f"decode attends {stats['view_len']} rows, "
                             f"timed at {view_len}")
    full_width_reference(engine, dev)
    del engine
    torch.cuda.empty_cache()

    log("[time] decode-step shapes")
    rows = timings(cases, dev)
    log("kernels:")
    entries = []
    for name in K.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        total = {key: sum(r["per_step"] * r[key] for r in mine)
                 for key in ("ms", "plain_ms", "bound_ms")}
        lib = (None if any(r["library_ms"] is None for r in mine) else
               sum(r["per_step"] * r["library_ms"] for r in mine))
        t_bytes = sum(r["per_step"] * r["bytes_ms"] for r in mine)
        t_ops = sum(r["per_step"] * r["ops_ms"] for r in mine)
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/ftimm/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": worst[name], "ms": total["ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib,
            "per": f"one decode step of {ARCH} at {SLOTS} slots",
            "shapes": [{k: r[k] for k in ("label", "per_step", "ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}
                       for r in mine]})
        for r in mine:
            lib_s = ("-" if r["library_ms"] is None
                     else f"{r['library_ms'] * 1e3:.1f}")
            log(f"  {name:19s} {r['label']:16s} x{r['per_step']:<3d} "
                f"kernel {r['ms'] * 1e3:9.1f} us  plain "
                f"{r['plain_ms'] * 1e3:9.1f} us  library {lib_s:>9s} us  "
                f"bound {r['bound_ms'] * 1e3:7.1f} us ({r['bound_by']})")
    log(json.dumps({"serve": stats}))
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
