"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA GPU and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Elsewhere every test here skips with a reason (a CUDA kernel has no
interpret mode).  Tolerances are normwise, max|kernel - plain| / max|plain|:
2e-2 for a bf16 output (one bf16 ulp is 2^-8 relative) and 1e-4 for fp32
(the two sum the same fp32 products in different orders).
"""
import functools
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.kernels.ftimm import ops  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    tol = 2e-2 if got.dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    assert torch.isfinite(got).all()
    assert err <= tol * scale, (err, scale)


def _operands(trans, m, k, n, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    a = torch.randn(sa, generator=g, device=dev).to(dtype)
    b = torch.randn(sb, generator=g, device=dev).to(dtype)
    return a, b


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("m,k,n", [(33, 257, 65), (4, 2048, 2048),
                                   (128, 512, 96)])
@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float32, torch.float32)])
def test_dense_kernel(dev, tile, trans, m, k, n, types):
    a, b = _operands(trans, m, k, n, types[0], dev)
    bm, bn, bk = tile
    got = K.ftimm_gemm(a, b, bm=bm, bn=bn, bk=bk, trans=trans,
                       out_dtype=types[1])
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=types[1]))


@pytest.mark.parametrize("epi", [
    Epilogue(residual=True), Epilogue(bias=True, activation="silu"),
    Epilogue(bias=True, activation="gelu", scale=0.5, residual=True),
    Epilogue(scale_vec=True)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_epilogue(dev, epi, dtype):
    m, k, n = 33, 257, 65
    a, b = _operands("nn", m, k, n, dtype, dev, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    bias = torch.randn(n, generator=g, device=dev).to(dtype)
    res = torch.randn(m, n, generator=g, device=dev).to(dtype)
    scale = torch.rand(n, generator=g, device=dev)
    kw = dict(epilogue=epi, bias=bias if epi.bias else None,
              residual=res if epi.residual else None,
              scale=scale if epi.scale_vec else None)
    got = ops.gemm(a, b, **kw)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(a, b, **kw))


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("m,k,n", [(33, 257, 65), (4, 2048, 6144)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swiglu_kernel(dev, tile, m, k, n, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    wg = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype)
    wu = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(dtype)
    bm, bn, bk = tile
    got = K.ftimm_gemm_swiglu(x, wg, wu, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_swiglu_plain(x, wg, wu))


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("shared", ["none", "a", "b"])
def test_grouped_kernel(dev, tile, trans, shared):
    gsz, m, k, n = 5, 33, 129, 65
    a, b = _operands(trans, m, k, n, torch.float32, dev, seed=4)
    gen = torch.Generator(device=dev).manual_seed(5)
    if shared != "a":
        a = torch.randn((gsz,) + tuple(a.shape), generator=gen, device=dev)
    if shared != "b":
        b = torch.randn((gsz,) + tuple(b.shape), generator=gen, device=dev)
    bm, bn, bk = tile
    got = K.ftimm_gemm_grouped(a, b, bm=bm, bn=bn, bk=bk, trans=trans)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_grouped_plain(a, b, trans=trans))


@pytest.mark.parametrize("per_group", [False, True])
def test_grouped_epilogue(dev, per_group):
    gsz, m, k, n = 3, 17, 70, 40
    gen = torch.Generator(device=dev).manual_seed(6)
    a = torch.randn(gsz, m, k, generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn(gsz, k, n, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn((gsz, n) if per_group else (n,), generator=gen,
                       device=dev).to(torch.bfloat16)
    res = torch.randn(gsz, m, n, generator=gen, device=dev).to(torch.bfloat16)
    epi = Epilogue(bias=True, residual=True)
    got = ops.batched_gemm(a, b, epilogue=epi, bias=bias, residual=res)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_grouped_plain(a, b, epilogue=epi, bias=bias,
                                           residual=res))


def test_launch_counts_and_types(dev):
    a, b = _operands("nn", 8, 16, 8, torch.bfloat16, dev)
    K.reset_launch_counts()
    ops.gemm(a, b)
    assert K.launch_counts()["ftimm_gemm"] == 1
    with pytest.raises(NotImplementedError):
        ops.gemm(a.to(torch.float16), b.to(torch.float16))
    assert K.launch_counts()["ftimm_gemm"] == 1


def _offsets(sizes, dev):
    import numpy as np
    return torch.tensor([0, *np.cumsum(sizes).tolist()], dtype=torch.int32,
                        device=dev)


# 4 rows to 4 distinct groups, all rows to one group, empty groups, one
# group over several tiles, T not a multiple of 16.
RAGGED_DISTS = [[1, 0, 0, 1, 0, 1, 1, 0], [0, 37, 0], [5, 0, 17, 3, 0],
                [3, 150, 2]]


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("sizes", RAGGED_DISTS)
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_kernel(dev, tile, sizes, trans, dtype):
    g, t, k, n = len(sizes), sum(sizes), 257, 96
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(t, k, generator=gen, device=dev).to(dtype)
    w = torch.randn((g, k, n) if trans == "nn" else (g, n, k), generator=gen,
                    device=dev).to(dtype)
    offs = _offsets(sizes, dev)
    bm, bn, bk = tile
    got = K.ftimm_gemm_ragged(x, w, offs, bm=bm, bn=bn, bk=bk, trans=trans)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_ragged_plain(x, w, offs, trans=trans))


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("sizes", RAGGED_DISTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ragged_swiglu_kernel(dev, tile, sizes, dtype):
    g, t, k, n = len(sizes), sum(sizes), 257, 96
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(t, k, generator=gen, device=dev).to(dtype)
    wg = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    wu = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    offs = _offsets(sizes, dev)
    bm, bn, bk = tile
    got = K.ftimm_gemm_ragged_swiglu(x, wg, wu, offs, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_ragged_swiglu_plain(x, wg, wu, offs))


@pytest.mark.parametrize("epi", [Epilogue(bias=True),
                                 Epilogue(scale_vec=True, scale=0.5,
                                          activation="silu"),
                                 Epilogue(bias=True, activation="gelu")])
@pytest.mark.parametrize("per_group", [False, True])
def test_ragged_epilogue_and_unowned_rows(dev, epi, per_group):
    """(N,) or (G, N) vectors; the 4 trailing rows belong to no group and
    come out as zeros."""
    sizes, tail = [5, 0, 17, 3], 4
    g, t, k, n = len(sizes), sum(sizes) + tail, 129, 65
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(t, k, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn(g, k, n, generator=gen, device=dev).to(torch.bfloat16)
    vec = torch.randn((g, n) if per_group else (n,), generator=gen,
                      device=dev)
    kw = dict(epilogue=epi, bias=vec if epi.bias else None,
              scale=vec if epi.scale_vec else None)
    offs = _offsets(sizes, dev)
    got = ops.ragged_gemm(x, w, offs, **kw)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_ragged_plain(x, w, offs, **kw))
    assert (got[-tail:] == 0).all()


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_swiglu_kernel(dev, tile, shared, dtype):
    g, m, k, n = 5, 33, 129, 65
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((m, k) if shared else (g, m, k), generator=gen,
                    device=dev).to(dtype)
    wg = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    wu = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dtype)
    bm, bn, bk = tile
    got = K.ftimm_gemm_grouped_swiglu(x, wg, wu, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_grouped_swiglu_plain(x, wg, wu))


def test_moe_kernels_launch_and_count(dev):
    """The MoE layer on the card goes through the new kernels, and only a
    launch moves a count."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    for arch, kernels in (("mixtral-8x7b-smoke", ("ftimm_gemm_grouped_swiglu",
                                                  "ftimm_gemm_grouped")),
                          ("llama4-scout-17b-a16e-smoke",
                           ("ftimm_gemm_ragged_swiglu", "ftimm_gemm_ragged"))):
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(11)
        p = moe.init_moe_params(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                                dtype=torch.float32, device=dev)
        x = torch.randn(37, cfg.d_model, generator=gen, device=dev)
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k,
                  compute_dtype=torch.float32, dispatch=cfg.moe_dispatch)
        K.reset_launch_counts()
        y, _ = moe.moe_mlp(x, p, **kw)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        assert all(counts[k] == 1 for k in kernels), counts
        want, _ = moe.moe_mlp(x.cpu(), p.to("cpu"), **kw)
        _close(y.cpu(), want)


# 4 rows to 4 distinct groups, all rows to one group, empty groups, one
# group over several tiles, T = 0; and (below) rows outside every group.
DW_DISTS = RAGGED_DISTS + [[16, 16, 16, 16], [0, 0, 0]]


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("sizes", DW_DISTS)
@pytest.mark.parametrize("tail", [0, 4])
@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float32, torch.float32)])
def test_ragged_dw_kernel(dev, tile, sizes, tail, types):
    """dW[g] = x[rows_g]^T dy[rows_g]; empty groups give zero panels and the
    ``tail`` rows past offsets[G] enter no panel."""
    g, t, d, f = len(sizes), sum(sizes) + tail, 257, 96
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(t, d, generator=gen, device=dev).to(types[0])
    dy = torch.randn(t, f, generator=gen, device=dev).to(types[0])
    offs = _offsets(sizes, dev)
    bm, bn, bk = tile
    got = K.ftimm_gemm_ragged_dw(x, dy, offs, bm=bm, bn=bn, bk=bk,
                                 out_dtype=types[1])
    torch.cuda.synchronize()
    want = K.ftimm_gemm_ragged_dw_plain(x, dy, offs, out_dtype=types[1])
    if t - tail:
        _close(got, want)
    for i, n in enumerate(sizes):
        if n == 0:
            assert (got[i] == 0).all()


def test_ragged_dw_is_deterministic(dev):
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(300, 130, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(300, 70, generator=gen, device=dev).to(torch.bfloat16)
    offs = _offsets([0, 250, 50], dev)
    runs = [ops.ragged_gemm_dw(x, dy, offs) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("nsplit", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(33, 257, 65), (64, 1024, 96)])
@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16),
                                   (torch.bfloat16, torch.float32),
                                   (torch.float32, torch.float32)])
def test_splitk_kernel(dev, tile, trans, nsplit, m, k, n, types):
    a, b = _operands(trans, m, k, n, types[0], dev, seed=14)
    bm, bn, bk = tile
    got = K.ftimm_gemm_splitk(a, b, bm=bm, bn=bn, bk=bk, nsplit=nsplit,
                              trans=trans, out_dtype=types[1])
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_splitk_plain(a, b, bk=bk, nsplit=nsplit,
                                          trans=trans, out_dtype=types[1]))
    again = K.ftimm_gemm_splitk(a, b, bm=bm, bn=bn, bk=bk, nsplit=nsplit,
                                trans=trans, out_dtype=types[1])
    assert torch.equal(got, again)      # no atomics: replays are identical


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_splitk_epilogue_after_the_sum(dev, dtype):
    m, k, n = 33, 300, 65
    a, b = _operands("nn", m, k, n, dtype, dev, seed=15)
    gen = torch.Generator(device=dev).manual_seed(16)
    bias = torch.randn(n, generator=gen, device=dev).to(dtype)
    res = torch.randn(m, n, generator=gen, device=dev).to(dtype)
    epi = Epilogue(bias=True, activation="silu", residual=True)
    K.reset_launch_counts()
    got = ops.gemm(a, b, nsplit=4, epilogue=epi, bias=bias, residual=res)
    torch.cuda.synchronize()
    assert K.launch_counts()["ftimm_gemm_splitk"] == 1
    _close(got, K.ftimm_gemm_plain(a, b, epilogue=epi, bias=bias,
                                   residual=res))


def _grads_match(fn, inputs, dev):
    """fn's output and every float input's gradient for one cotangent, on
    the card (the kernels) against the CPU (the plain versions)."""
    outs = {}
    for device in (dev, torch.device("cpu")):
        xs = [x.to(device).requires_grad_(x.is_floating_point())
              for x in inputs]
        y = fn(*xs)
        ct = torch.linspace(-1, 1, y.numel(), device=device).reshape(y.shape)
        grads = torch.autograd.grad(
            y, [x for x in xs if x.requires_grad], ct)
        outs[device.type] = [y.detach().cpu()] + [g.cpu() for g in grads]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        _close(got, want)


def _randn_cpu():
    gen = torch.Generator().manual_seed(17)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    return r


def test_matmul_autograd_on_the_card(dev):
    from repro_torch.core.gemm import dispatch as d
    r = _randn_cpu()
    epi = Epilogue(bias=True, activation="gelu", residual=True)
    for trans, sa, sb in (("nn", (33, 40), (40, 24)), ("tn", (40, 33), (40, 24)),
                          ("nt", (33, 40), (24, 40))):
        _grads_match(lambda a, b, bias, res: d.matmul(
            a, b, trans=trans, epilogue=epi, bias=bias, residual=res),
            [r(*sa), r(*sb), r(24), r(33, 24)], dev)
        _grads_match(lambda a, b: d.matmul(a, b, trans=trans),
                     [r(*sa), r(*sb)], dev)


def test_batched_and_swiglu_autograd_on_the_card(dev):
    from repro_torch.core.gemm import dispatch as d
    r = _randn_cpu()
    _grads_match(lambda a, b: d.batched_matmul(a, b, trans="nt"),
                 [r(3, 7, 20), r(3, 12, 20)], dev)
    _grads_match(lambda a, b, bias: d.batched_matmul(a, b, bias=bias),
                 [r(3, 7, 20), r(20, 12), r(3, 12)], dev)
    _grads_match(d.matmul_swiglu, [r(9, 32), r(32, 24), r(32, 24)], dev)
    _grads_match(d.grouped_swiglu, [r(4, 8, 32), r(4, 32, 24),
                                    r(4, 32, 24)], dev)


def test_ragged_autograd_on_the_card(dev):
    from repro_torch.core.gemm import dispatch as d
    r = _randn_cpu()
    offs = _offsets([5, 0, 17, 3, 0], "cpu")
    _grads_match(lambda x, w, o, b: d.ragged_matmul(x, w, o, bias=b),
                 [r(25, 24), r(5, 24, 20), offs, r(5, 20)], dev)
    _grads_match(d.ragged_swiglu, [r(25, 24), r(5, 24, 20), r(5, 24, 20),
                                   offs], dev)
    K.reset_launch_counts()
    x = r(25, 24).to(dev).requires_grad_()
    w = r(5, 24, 20).to(dev).requires_grad_()
    d.ragged_matmul(x, w, offs.to(dev)).sum().backward()
    assert K.launch_counts()["ftimm_gemm_ragged_dw"] == 1


MIXED_TYPES = [(torch.bfloat16, torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32, torch.float32),
               (torch.float32, torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("tile", K.TILES)
@pytest.mark.parametrize("types", MIXED_TYPES,
                         ids=["bf16xf32-bf16", "bf16xf32-f32",
                              "f32xbf16-bf16", "f32xbf16-f32"])
def test_mixed_operand_kernels(dev, tile, types):
    """bf16 x fp32 operands in either order (an fp32 cotangent against
    bf16 weights in the backward), on every kernel that takes them."""
    ta, tb, out = types
    bm, bn, bk = tile
    for trans in ("nn", "tn", "nt"):
        a, b = _operands(trans, 33, 257, 65, torch.float32, dev, seed=21)
        a, b = a.to(ta), b.to(tb)
        got = K.ftimm_gemm(a, b, bm=bm, bn=bn, bk=bk, trans=trans,
                           out_dtype=out)
        _close(got, K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out))
        got = K.ftimm_gemm_splitk(a, b, bm=bm, bn=bn, bk=bk, nsplit=3,
                                  trans=trans, out_dtype=out)
        _close(got, K.ftimm_gemm_splitk_plain(a, b, bk=bk, nsplit=3,
                                              trans=trans, out_dtype=out))
        ga = torch.stack([a, a.flip(0)])
        got = K.ftimm_gemm_grouped(ga, b, bm=bm, bn=bn, bk=bk, trans=trans,
                                   out_dtype=out)
        _close(got, K.ftimm_gemm_grouped_plain(ga, b, trans=trans,
                                               out_dtype=out))
    gen = torch.Generator(device=dev).manual_seed(22)
    offs = _offsets([5, 0, 17, 3, 0], dev)
    x = torch.randn(29, 257, generator=gen, device=dev).to(ta)
    for trans in ("nn", "nt"):
        shape = (5, 257, 96) if trans == "nn" else (5, 96, 257)
        w = torch.randn(shape, generator=gen, device=dev).to(tb)
        got = K.ftimm_gemm_ragged(x, w, offs, bm=bm, bn=bn, bk=bk,
                                  trans=trans, out_dtype=out)
        _close(got, K.ftimm_gemm_ragged_plain(x, w, offs, trans=trans,
                                              out_dtype=out))
    dy = torch.randn(29, 96, generator=gen, device=dev).to(tb)
    got = K.ftimm_gemm_ragged_dw(x, dy, offs, bm=bm, bn=bn, bk=bk,
                                 out_dtype=out)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_ragged_dw_plain(x, dy, offs, out_dtype=out))


def test_single_type_kernels_refuse_mixed_operands(dev):
    x = torch.randn(8, 16, device=dev, dtype=torch.bfloat16)
    w = torch.randn(16, 8, device=dev)
    with pytest.raises(NotImplementedError):
        K.ftimm_gemm_swiglu(x, w, w, bm=16, bn=32, bk=64)


def test_fp32_out_autograd_on_the_card(dev):
    """bf16 operands with fp32 output (the unembed, the router): the fp32
    cotangent reaches the mixed kernels unrounded, on the card as on the
    CPU."""
    from repro_torch.core.gemm import dispatch as d
    r = _randn_cpu()
    for trans, sa, sb in (("nn", (33, 40), (40, 24)), ("tn", (40, 33), (40, 24)),
                          ("nt", (33, 40), (24, 40))):
        _grads_match(lambda a, b: d.matmul(a, b, trans=trans,
                                           out_dtype=torch.float32),
                     [r(*sa).bfloat16(), r(*sb).bfloat16()], dev)


# ---------------------------------------------------------------------------
# The tensor-core and weight-stream bodies of ftimm_gemm, and the
# tensor-core ragged dW.  The shapes are not tile multiples but keep every
# stride a multiple of 16 bytes, so TMA and the 16-byte loads take them.
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
TC_SHAPES = [(40, 264, 72), (24, 136, 520), (64, 512, 96), (200, 1024, 264)]


@pytest.mark.parametrize("tile", K.TC_TILES)
@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("m,k,n", TC_SHAPES)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_tc_body(dev, tile, trans, m, k, n, out):
    a, b = _operands(trans, m, k, n, BF16, dev, seed=31)
    bm, bn, bk = tile
    K.reset_launch_counts()
    for order in ("mn", "nm"):
        got = K.ftimm_gemm(a, b, bm=bm, bn=bn, bk=bk, trans=trans,
                           dim_order=order, out_dtype=out, body="tc")
        torch.cuda.synchronize()
        _close(got, K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out))
    assert K.body_counts()["ftimm_gemm"] == {"fma": 0, "tc": 2, "stream": 0}


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("kslices", [1, 3, 8])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_stream_body(dev, trans, m, kslices, out):
    # a short last slice (or one slice that is not a multiple of 64), a
    # partial last strip; one slice of 16 staged rows fits at K = 520
    k, n = (1032 if kslices > 1 else 520), 520
    a, b = _operands(trans, m, k, n, BF16, dev, seed=32)
    K.reset_launch_counts()
    got = K.ftimm_gemm(a, b, bm=16, bn=32, bk=64, trans=trans, out_dtype=out,
                       body="stream", kslices=kslices)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out))
    assert K.body_counts()["ftimm_gemm"]["stream"] == 1


EPILOGUES = [Epilogue(residual=True), Epilogue(bias=True, activation="silu"),
             Epilogue(bias=True, activation="gelu", scale=0.5, residual=True),
             Epilogue(scale_vec=True), Epilogue(scale=0.25)]


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("body,m,kslices", [("tc", 200, 1), ("stream", 4, 1),
                                            ("stream", 4, 5)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_new_bodies_epilogue(dev, epi, body, m, kslices, out):
    k, n = 520, 264
    a, b = _operands("nn", m, k, n, BF16, dev, seed=33)
    g = torch.Generator(device=dev).manual_seed(34)
    bias = torch.randn(n, generator=g, device=dev).to(BF16)
    res = torch.randn(m, n, generator=g, device=dev).to(BF16)
    scale = torch.rand(n, generator=g, device=dev)
    kw = dict(epilogue=epi, bias=bias if epi.bias else None,
              residual=res if epi.residual else None,
              scale=scale if epi.scale_vec else None, out_dtype=out)
    got = K.ftimm_gemm(a, b, bm=128, bn=128, bk=64, body=body,
                       kslices=kslices, **kw)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(a, b, **kw))


def test_stream_reruns_are_bit_identical(dev):
    """The slices' partials are summed in slice order by the last CTA of a
    strip: no atomics on the output, so a rerun gives the same bits."""
    a, b = _operands("nn", 4, 6144, 2048, BF16, dev, seed=35)
    runs = [K.ftimm_gemm(a, b, bm=4, bn=32, bk=768, body="stream",
                         kslices=8, out_dtype=torch.float32)
            for _ in range(5)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    _close(runs[0], K.ftimm_gemm_plain(a, b, out_dtype=torch.float32))


def test_stream_body_on_two_cuda_streams(dev):
    """Stream-body GEMMs running at once on two CUDA streams keep their own
    arrival counters: each gives the bits it gives alone."""
    ops_ = [_operands("nn", 4, 6144, 2048, BF16, dev, seed=37),
            _operands("nn", 4, 2048, 2048, BF16, dev, seed=38)]

    def run(a, b):
        return K.ftimm_gemm(a, b, bm=4, bn=K.STREAM_STRIP, bk=256,
                            body="stream", kslices=8,
                            out_dtype=torch.float32)

    alone = [run(a, b) for a, b in ops_]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(dev) for _ in ops_]
    outs = [[] for _ in ops_]
    for s, (a, b), out in zip(streams, ops_, outs):
        with torch.cuda.stream(s):
            torch.cuda._sleep(10 ** 6)
            out += [run(a, b) for _ in range(8)]
    torch.cuda.synchronize()
    for want, out in zip(alone, outs):
        for got in out:
            assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 200])
@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
def test_planned_body_through_dispatch(dev, m, trans):
    """core.gemm.matmul plans the body: the stream at M <= 16, the tensor
    cores at qwen's widths from M = 64 on; the answer holds either way."""
    from repro_torch.core.gemm import matmul, plan_gemm
    k, n = 2048, 2048
    a, b = _operands(trans, m, k, n, BF16, dev, seed=36)
    K.reset_launch_counts()
    got = matmul(a, b, trans=trans)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(a, b, trans=trans))
    body = plan_gemm(m, k, n, 2, 2).body
    assert K.body_counts()["ftimm_gemm"][body] == 1
    if m <= 16:
        assert body == "stream"
    if m >= 64:
        assert body == "tc"


def test_misaligned_operand_takes_the_fma_body(dev):
    """A view whose base is not 16-byte aligned (or whose row stride is not
    a multiple of 16 bytes) cannot be read by TMA: the planner sends it to
    the FMA body, and the tensor-core body refuses it outright."""
    from repro_torch.core.gemm import matmul
    a_full, b = _operands("nn", 200, 1025, 512, BF16, dev, seed=37)
    a, b = a_full[:, 1:], b[1:]            # A: base + 2 bytes, stride 1025
    K.reset_launch_counts()
    got = matmul(a, b)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(a, b))
    assert K.body_counts()["ftimm_gemm"] == {"fma": 1, "tc": 0, "stream": 0}
    with pytest.raises(ValueError):
        K.ftimm_gemm(a, b, bm=128, bn=128, bk=64, body="tc")
    with pytest.raises(ValueError):     # fp32 has only the FMA body
        K.ftimm_gemm(a.float(), b.float(), bm=4, bn=32, bk=64, body="stream")


TC_DW_DISTS = [[16, 16, 16, 16], [0, 37, 0], [5, 0, 17, 3, 0], [3, 150, 2],
               [1], [0, 0, 0], [0, 200, 1, 0, 0, 0, 0, 55]]


@pytest.mark.parametrize("tile", K.TC_TILES)
@pytest.mark.parametrize("sizes", TC_DW_DISTS)
@pytest.mark.parametrize("tail", [0, 5])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_ragged_dw_tc_body(dev, tile, sizes, tail, out):
    """Empty, skewed, singleton and all-empty distributions, rows outside
    every group; deterministic across runs (the tensor cores' sum order
    differs from the plain version's, so the comparison is normwise)."""
    g, t, d, f = len(sizes), sum(sizes) + tail, 264, 520
    gen = torch.Generator(device=dev).manual_seed(38)
    x = torch.randn(t, d, generator=gen, device=dev).to(BF16)
    dy = torch.randn(t, f, generator=gen, device=dev).to(BF16)
    offs = _offsets(sizes, dev)
    bm, bn, bk = tile
    if t == 0:      # TMA has nothing to read: the wrapper of ops answers
        with pytest.raises(ValueError):
            K.ftimm_gemm_ragged_dw(x, dy, offs, bm=bm, bn=bn, bk=bk,
                                   out_dtype=out, body="tc")
        assert not ops.ragged_gemm_dw(x, dy, offs, out_dtype=out).any()
        return
    K.reset_launch_counts()
    runs = [K.ftimm_gemm_ragged_dw(x, dy, offs, bm=bm, bn=bn, bk=bk,
                                   out_dtype=out, body="tc")
            for _ in range(3)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    _close(runs[0], K.ftimm_gemm_ragged_dw_plain(x, dy, offs, out_dtype=out))
    assert K.body_counts()["ftimm_gemm_ragged_dw"]["tc"] == 3


def test_ragged_dw_t0_and_planned_body(dev):
    """T = 0 gives zero panels without a launch; a row-major bf16 pair plans
    the tensor-core body, a transposed x the FMA body."""
    from repro_torch.core.gemm import dispatch as d
    offs = _offsets([0, 0, 0], dev)
    x = torch.zeros(0, 264, device=dev, dtype=BF16)
    dy = torch.zeros(0, 520, device=dev, dtype=BF16)
    out = ops.ragged_gemm_dw(x, dy, offs)
    assert out.shape == (3, 264, 520) and not out.any()
    gen = torch.Generator(device=dev).manual_seed(39)
    offs = _offsets([40, 0, 88], dev)
    x = torch.randn(128, 264, generator=gen, device=dev).to(BF16)
    dy = torch.randn(128, 520, generator=gen, device=dev).to(BF16)
    K.reset_launch_counts()
    got = d._run_ragged_dw(x, dy, offs, BF16)
    xt = x.t().contiguous().t()                       # D unit-stride no more
    got_t = d._run_ragged_dw(xt, dy, offs, BF16)
    torch.cuda.synchronize()
    want = K.ftimm_gemm_ragged_dw_plain(x, dy, offs)
    _close(got, want)
    _close(got_t, want)
    assert K.body_counts()["ftimm_gemm_ragged_dw"] == {"fma": 1, "tc": 1}


# ---------------------------------------------------------------------------
# The tensor-core and weight-stream bodies of the grouped and ragged
# kernels.  K = 1032 is not a multiple of the 64-deep box, N = 264 not one
# of the 128-column tile or strip: every group's K edge is a box tail (the
# 3-D maps zero-fill it).  Two runs of each call must give the same bits.
# ---------------------------------------------------------------------------

GK, GN = 1032, 264


def _grouped_operands(trans, g, m, shared, dev, seed):
    a, b = _operands(trans, m, GK, GN, BF16, dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if shared != "a":
        a = torch.randn((g,) + tuple(a.shape), generator=gen,
                        device=dev).to(BF16)
    if shared != "b":
        b = (torch.randn((g,) + tuple(b.shape), generator=gen, device=dev)
             * GK ** -0.5).to(BF16)
    return a, b


def _twice(fn):
    runs = [fn(), fn()]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    return runs[0]


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("m", [16, 200])
@pytest.mark.parametrize("shared", ["none", "a", "b"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_grouped_tc_body(dev, trans, m, shared, out):
    a, b = _grouped_operands(trans, 5, m, shared, dev, seed=40)
    K.reset_launch_counts()
    for order in ("mn", "nm"):
        got = _twice(lambda: K.ftimm_gemm_grouped(
            a, b, bm=128, bn=128, bk=64, trans=trans, dim_order=order,
            out_dtype=out, body="tc"))
        _close(got, K.ftimm_gemm_grouped_plain(a, b, trans=trans,
                                               out_dtype=out))
    assert K.body_counts()["ftimm_gemm_grouped"] == {"fma": 0, "tc": 4,
                                                     "stream": 0, "rows": 0}


@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("kslices", [1, 3])
@pytest.mark.parametrize("shared", ["none", "a", "b"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_grouped_stream_body(dev, trans, m, kslices, shared, out):
    a, b = _grouped_operands(trans, 5, m, shared, dev, seed=42)
    K.reset_launch_counts()
    got = _twice(lambda: K.ftimm_gemm_grouped(
        a, b, bm=16, bn=128, bk=64, trans=trans, out_dtype=out,
        body="stream", kslices=kslices))
    _close(got, K.ftimm_gemm_grouped_plain(a, b, trans=trans, out_dtype=out))
    assert K.body_counts()["ftimm_gemm_grouped"]["stream"] == 2


@pytest.mark.parametrize("body,m,kslices", [("tc", 200, 1), ("stream", 16, 1),
                                            ("stream", 4, 3)])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_grouped_new_bodies_epilogue(dev, body, m, kslices, per_group, out):
    """(G, N) or (N,) bias and scale vectors, the scalar scale, the
    activations and the (G, M, N) residual at the flush."""
    g = 3
    a, b = _grouped_operands("nn", g, m, "none", dev, seed=46)
    gen = torch.Generator(device=dev).manual_seed(47)
    vshape = (g, GN) if per_group else (GN,)
    bias = torch.randn(vshape, generator=gen, device=dev)
    scale = torch.rand(vshape, generator=gen, device=dev)
    res = torch.randn(g, m, GN, generator=gen, device=dev).to(BF16)
    for epi in (Epilogue(bias=True, activation="silu", residual=True),
                Epilogue(scale_vec=True, scale=0.5, activation="gelu")):
        kw = dict(epilogue=epi, bias=bias if epi.bias else None,
                  residual=res if epi.residual else None,
                  scale=scale if epi.scale_vec else None, out_dtype=out)
        got = _twice(lambda: K.ftimm_gemm_grouped(
            a, b, bm=128 if body == "tc" else 16, bn=128, bk=64, body=body,
            kslices=kslices, **kw))
        _close(got, K.ftimm_gemm_grouped_plain(a, b, **kw))


def _rows_operands(trans, g, m, k, n, shared, dev, seed):
    """fp32 A (G, M, K) and B's cache rows ("nt": (G, N, K); "nn": (G, K,
    N)), either 2-D when shared."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sb = (n, k) if trans == "nt" else (k, n)
    a = torch.randn(((m, k) if shared == "a" else (g, m, k)), generator=gen,
                    device=dev)
    b = torch.randn((sb if shared == "b" else (g,) + sb), generator=gen,
                    device=dev) * k ** -0.5
    return a, b


def _rows(a, b, trans, tile=None, **kw):
    g = a.shape[0] if a.ndim == 3 else b.shape[0]
    _, k, n = K.mkn(trans, a.shape[-2:], b.shape[-2:])
    bm, bn, bk = tile or K.rows_tile(g, k, n, trans)
    return K.ftimm_gemm_grouped(a, b, bm=bm, bn=bn, bk=bk, trans=trans,
                                body="rows", **kw)


@pytest.mark.parametrize("trans", ["nt", "nn"])
@pytest.mark.parametrize("m", [1, 2, 7, 8])
@pytest.mark.parametrize("k,n", [(128, 96), (300, 260), (64, 1024)])
@pytest.mark.parametrize("shared", ["none", "a", "b"])
def test_grouped_rows_body(dev, trans, m, k, n, shared):
    """The few-rows fp32 stream at 1-8 rows a group, K slices ("nt": 300
    past its 256-float row width; "nn": its cache-row slices), strips and
    a shared 2-D operand; reruns bit-identical."""
    a, b = _rows_operands(trans, 5, m, k, n, shared, dev, seed=60)
    K.reset_launch_counts()
    got = _twice(lambda: _rows(a, b, trans))
    _close(got, K.ftimm_gemm_grouped_plain(a, b, trans=trans))
    assert K.body_counts()["ftimm_gemm_grouped"]["rows"] == 2


@pytest.mark.parametrize("trans", ["nt", "nn"])
@pytest.mark.parametrize("per_group", [False, True])
def test_grouped_rows_body_epilogue(dev, trans, per_group):
    """Each epilogue field at the flush, with one K slice and several."""
    g, m, k, n = 3, 3, 300, 200
    a, b = _rows_operands(trans, g, m, k, n, "none", dev, seed=61)
    gen = torch.Generator(device=dev).manual_seed(62)
    vshape = (g, n) if per_group else (n,)
    bias = torch.randn(vshape, generator=gen, device=dev)
    scale = torch.rand(vshape, generator=gen, device=dev)
    res = torch.randn(g, m, n, generator=gen, device=dev)
    one = (K.ROWS_MAX, 200, 256) if trans == "nt" else (K.ROWS_MAX, 256, 300)
    for epi in (Epilogue(bias=True, activation="silu", residual=True),
                Epilogue(scale_vec=True, scale=0.5, activation="gelu")):
        kw = dict(epilogue=epi, bias=bias if epi.bias else None,
                  residual=res if epi.residual else None,
                  scale=scale if epi.scale_vec else None)
        want = K.ftimm_gemm_grouped_plain(a, b, trans=trans, **kw)
        for tile in (None, one):
            _close(_twice(lambda: _rows(a, b, trans, tile, **kw)), want)


@pytest.mark.parametrize("trans", ["nt", "nn"])
@pytest.mark.parametrize("side", ["a", "b"])
def test_grouped_rows_body_nan_past_k(dev, trans, side):
    """NaN past K in either operand stays out (0 x NaN = NaN: both are
    masked), at the cut and at narrow K slices."""
    g, m, k, n = 4, 3, 300, 200
    a, b = _rows_operands(trans, g, m, k, n, "none", dev, seed=63)
    nan = float("nan")
    if side == "a":
        pad = torch.full((g, m, k + 8), nan, device=dev)
        pad[..., :k] = a
        a = pad[..., :k]
    elif trans == "nt":
        pad = torch.full((g, n, k + 8), nan, device=dev)
        pad[..., :k] = b
        b = pad[..., :k]
    else:
        pad = torch.full((g, k + 5, n), nan, device=dev)
        pad[:, :k] = b
        b = pad[:, :k]
    want = K.ftimm_gemm_grouped_plain(a, b, trans=trans)
    narrow = (K.ROWS_MAX, 64, 64) if trans == "nt" else (K.ROWS_MAX, 128, 70)
    for tile in (None, narrow):
        _close(_rows(a, b, trans, tile), want)


def test_grouped_rows_planned_for_decode_attention(dev):
    """fp32 decode QK^T / PV through the dispatch layer, the cache laid
    out as the attention lays it out: the rows body; 9 rows a group, and
    a cache 8 bytes off its 16-byte alignment, the FMA body."""
    from repro_torch.core.gemm import batched_matmul
    gen = torch.Generator(device=dev).manual_seed(64)
    cache = torch.randn(4, 96, 8, 128, generator=gen, device=dev).to(BF16)
    kf = cache.float().permute(0, 2, 1, 3).reshape(32, 96, 128)
    off = torch.empty(kf.numel() + 2, device=dev)[2:].view(32, 96, 128)
    off.copy_(kf)
    for m, bb, body in ((2, kf, "rows"), (7, kf, "rows"), (9, kf, "fma"),
                        (2, off, "fma")):
        for trans in ("nt", "nn"):
            a = torch.randn((32, m, 128 if trans == "nt" else 96),
                            generator=gen, device=dev)
            K.reset_launch_counts()
            got = batched_matmul(a, bb, trans=trans, out_dtype=torch.float32)
            _close(got, K.ftimm_gemm_grouped_plain(a, bb, trans=trans))
            counts = K.body_counts()["ftimm_gemm_grouped"]
            assert counts[body] == 1 and sum(counts.values()) == 1, (m, trans)


def test_grouped_rows_body_refuses_what_it_cannot_take(dev):
    a, b = _rows_operands("nt", 3, 9, 128, 96, "none", dev, seed=65)
    with pytest.raises(ValueError):       # 9 rows a group
        _rows(a, b, "nt", (K.ROWS_MAX, 16, 128))
    a, b = _rows_operands("nt", 3, 2, 128, 96, "none", dev, seed=66)
    with pytest.raises(ValueError):       # bf16: the rows body is fp32
        _rows(a.to(BF16), b.to(BF16), "nt")
    with pytest.raises(ValueError):       # B's rows not unit-stride
        _rows(a, b.transpose(1, 2).contiguous().transpose(1, 2), "nt")
    with pytest.raises(ValueError):       # "tn": A read K-major only
        K.ftimm_gemm_grouped(a.transpose(1, 2).contiguous(), b.transpose(
            1, 2).contiguous(), bm=K.ROWS_MAX, bn=128, bk=128, trans="tn",
            body="rows")


def test_grouped_bodies_refuse_what_they_cannot_take(dev):
    a, b = _grouped_operands("nn", 3, 17, "none", dev, seed=48)
    with pytest.raises(ValueError):       # 17 rows: not the stream
        K.ftimm_gemm_grouped(a, b, bm=16, bn=128, bk=64, body="stream")
    with pytest.raises(ValueError):       # fp32: FMA only
        K.ftimm_gemm_grouped(a.float(), b.float(), bm=128, bn=128, bk=64,
                             body="tc")
    a, b = _grouped_operands("nn", 3, 16, "none", dev, seed=49)
    at = a.transpose(1, 2).contiguous().transpose(1, 2)   # A MN-major
    with pytest.raises(ValueError):       # the stream reads A K-major
        K.ftimm_gemm_grouped(at, b, bm=16, bn=128, bk=64, body="stream")
    got = _twice(lambda: K.ftimm_gemm_grouped(at, b, bm=128, bn=128, bk=64,
                                              body="tc"))
    _close(got, K.ftimm_gemm_grouped_plain(at, b))


# Ragged distributions.  The stream (T <= 16): 4 rows to 4 groups, a group
# of exactly 16 rows, empty groups, rows outside every group.  The tensor
# cores: one group over several chunks, skewed, empty groups, a tail.
STREAM_DISTS = [([1, 0, 0, 1, 0, 1, 1, 0], 0), ([0, 16, 0], 0),
                ([5, 0, 7, 3, 0], 0), ([2, 0, 3], 4), ([1], 0)]
RAGGED_TC_DISTS = [([3, 150, 2], 0), ([0, 200, 1, 0, 0, 0, 0, 55], 0),
                   ([5, 0, 17, 3, 0], 0), ([40, 0, 88], 7), ([0, 16, 0], 0)]


def _ragged_operands(sizes, tail, trans, dev, seed):
    g, t = len(sizes), sum(sizes) + tail
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t, GK, generator=gen, device=dev).to(BF16)
    w_shape = (g, GK, GN) if trans == "nn" else (g, GN, GK)
    w = (torch.randn(w_shape, generator=gen, device=dev)
         * GK ** -0.5).to(BF16)
    return x, w, _offsets(sizes, dev)


@pytest.mark.parametrize("body,dist", [("stream", d) for d in STREAM_DISTS]
                         + [("tc", d) for d in RAGGED_TC_DISTS])
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_ragged_new_bodies(dev, body, dist, trans, out):
    sizes, tail = dist
    x, w, offs = _ragged_operands(sizes, tail, trans, dev, seed=50)
    K.reset_launch_counts()
    for kslices in ((1, 3) if body == "stream" else (1,)):
        got = _twice(lambda: K.ftimm_gemm_ragged(
            x, w, offs, bm=128 if body == "tc" else 16, bn=128, bk=64,
            trans=trans, out_dtype=out, body=body, kslices=kslices))
        want = K.ftimm_gemm_ragged_plain(x, w, offs, trans=trans,
                                         out_dtype=out)
        _close(got, want)
        if tail:
            assert not got[sum(sizes):].any()
    assert K.body_counts()["ftimm_gemm_ragged"][body] == (
        4 if body == "stream" else 2)


@pytest.mark.parametrize("body,dist", [("stream", ([5, 0, 7, 3, 0], 0)),
                                       ("tc", ([3, 150, 2, 0], 5))])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_ragged_new_bodies_epilogue(dev, body, dist, per_group, out):
    sizes, tail = dist
    g = len(sizes)
    x, w, offs = _ragged_operands(sizes, tail, "nn", dev, seed=52)
    gen = torch.Generator(device=dev).manual_seed(53)
    vshape = (g, GN) if per_group else (GN,)
    bias = torch.randn(vshape, generator=gen, device=dev)
    scale = torch.rand(vshape, generator=gen, device=dev)
    for epi in (Epilogue(bias=True, activation="silu"),
                Epilogue(scale_vec=True, scale=0.5, activation="gelu")):
        kw = dict(epilogue=epi, bias=bias if epi.bias else None,
                  scale=scale if epi.scale_vec else None, out_dtype=out)
        got = _twice(lambda: K.ftimm_gemm_ragged(
            x, w, offs, bm=128 if body == "tc" else 16, bn=128, bk=64,
            body=body, kslices=2, **kw))
        _close(got, K.ftimm_gemm_ragged_plain(x, w, offs, **kw))


def test_ragged_bodies_refuse_what_they_cannot_take(dev):
    x, w, offs = _ragged_operands([5, 0, 12], 0, "nn", dev, seed=54)
    with pytest.raises(ValueError):       # 17 rows: not the stream
        K.ftimm_gemm_ragged(x, w, offs, bm=16, bn=128, bk=64, body="stream")
    with pytest.raises(ValueError):       # an fp32 cotangent: FMA only
        K.ftimm_gemm_ragged(x.float(), w, offs, bm=128, bn=128, bk=64,
                            body="tc")
    xt = x.t().contiguous().t()           # x not K-major
    with pytest.raises(ValueError):
        K.ftimm_gemm_ragged(xt, w, offs, bm=128, bn=128, bk=64, body="tc")


@pytest.mark.parametrize("rows,body", [(16, "stream"), (320, "tc")])
def test_grouped_planned_body_through_dispatch(dev, rows, body):
    """grouped_matmul plans the body: the stream at 16 rows a group, the
    tensor cores at mixtral's training capacity; fp32 stays FMA."""
    from repro_torch.core.gemm import batched_matmul, grouped_matmul
    a, b = _grouped_operands("nn", 4, rows, "none", dev, seed=56)
    K.reset_launch_counts()
    got = grouped_matmul(a, b)
    s = batched_matmul(a.float(), b.float(), out_dtype=torch.float32)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_grouped_plain(a, b))
    _close(s, K.ftimm_gemm_grouped_plain(a.float(), b.float()))
    counts = K.body_counts()["ftimm_gemm_grouped"]
    assert counts[body] == 1 and counts["fma"] == 1


@pytest.mark.parametrize("sizes,body", [([1, 0, 2, 1], "stream"),
                                        ([300, 0, 500, 224], "tc")])
def test_ragged_planned_body_through_dispatch(dev, sizes, body):
    from repro_torch.core.gemm import ragged_matmul
    x, w, offs = _ragged_operands(sizes, 0, "nn", dev, seed=58)
    K.reset_launch_counts()
    got = ragged_matmul(x, w, offs)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_ragged_plain(x, w, offs))
    assert K.body_counts()["ftimm_gemm_ragged"][body] == 1


# ---------------------------------------------------------------------------
# The SwiGLU pairs' weight-stream and tensor-core bodies: the shapes,
# slices and ragged distributions of the one-panel bodies above, against the
# plain pairs; two runs of each call must give the same bits.
# ---------------------------------------------------------------------------

def _pair_panels(g, dev, seed, trans="nn"):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (g, GK, GN) if trans == "nn" else (g, GN, GK)
    wg, wu = ((torch.randn(shape, generator=gen, device=dev)
               * GK ** -0.5).to(BF16) for _ in range(2))
    if trans == "nt":       # (G, K, N) views whose K has unit stride
        wg, wu = wg.transpose(1, 2), wu.transpose(1, 2)
    return wg, wu


@pytest.mark.parametrize("body,m,kslices", [("stream", m, ks)
                                            for m in (1, 4, 16)
                                            for ks in (1, 3)]
                         + [("tc", 16, 1), ("tc", 200, 1)])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_grouped_swiglu_new_bodies(dev, body, m, kslices, shared, trans,
                                   out):
    g = 5
    gen = torch.Generator(device=dev).manual_seed(60)
    x = torch.randn((m, GK) if shared else (g, m, GK), generator=gen,
                    device=dev).to(BF16)
    wg, wu = _pair_panels(g, dev, 61, trans)
    K.reset_launch_counts()
    got = _twice(lambda: K.ftimm_gemm_grouped_swiglu(
        x, wg, wu, bm=128, bn=128, bk=64, out_dtype=out, body=body,
        kslices=kslices))
    _close(got, K.ftimm_gemm_grouped_swiglu_plain(x, wg, wu, out_dtype=out))
    assert K.body_counts()["ftimm_gemm_grouped_swiglu"][body] == 2


@pytest.mark.parametrize("body,dist,kslices", [("stream", d, ks)
                                               for d in STREAM_DISTS
                                               for ks in (1, 3)]
                         + [("tc", d, 1) for d in RAGGED_TC_DISTS])
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_ragged_swiglu_new_bodies(dev, body, dist, kslices, trans, out):
    sizes, tail = dist
    x, _, offs = _ragged_operands(sizes, tail, "nn", dev, seed=62)
    wg, wu = _pair_panels(len(sizes), dev, 63, trans)
    K.reset_launch_counts()
    got = _twice(lambda: K.ftimm_gemm_ragged_swiglu(
        x, wg, wu, offs, bm=128, bn=128, bk=64, out_dtype=out, body=body,
        kslices=kslices))
    _close(got, K.ftimm_gemm_ragged_swiglu_plain(x, wg, wu, offs,
                                                 out_dtype=out))
    if tail:
        assert not got[sum(sizes):].any()
    assert K.body_counts()["ftimm_gemm_ragged_swiglu"][body] == 2


def test_swiglu_pair_bodies_refuse_what_they_cannot_take(dev):
    """A body the operands do not allow raises before any launch: no
    fallback to the FMA body or the plain version."""
    g = 3
    gen = torch.Generator(device=dev).manual_seed(64)
    wg, wu = _pair_panels(g, dev, 65)
    x17 = torch.randn(g, 17, GK, generator=gen, device=dev).to(BF16)
    x16 = x17[:, :16].contiguous()
    xt = x16.transpose(1, 2).contiguous().transpose(1, 2)   # x MN-major
    big = torch.randn(g, GK, GN + 8, generator=gen, device=dev).to(BF16)
    wu_odd = big[:, :, 1:GN + 1]              # base 2 bytes off 16
    wg_odd = big[:, :, :GN]
    offs = _offsets([5, 0, 12], dev)
    K.reset_launch_counts()
    for call in (
            lambda: K.ftimm_gemm_grouped_swiglu(x17, wg, wu, bm=16, bn=128,
                                                bk=64, body="stream"),
            lambda: K.ftimm_gemm_grouped_swiglu(xt, wg, wu, bm=16, bn=128,
                                                bk=64, body="stream"),
            lambda: K.ftimm_gemm_grouped_swiglu(
                x16.float(), wg.float(), wu.float(), bm=128, bn=128, bk=64,
                body="tc"),
            lambda: K.ftimm_gemm_grouped_swiglu(x16, wg_odd, wu_odd, bm=128,
                                                bn=128, bk=64, body="tc"),
            lambda: K.ftimm_gemm_ragged_swiglu(x17[0], wg, wu, offs, bm=16,
                                               bn=128, bk=64, body="stream"),
            lambda: K.ftimm_gemm_ragged_swiglu(
                x17[0].t().contiguous().t(), wg, wu, offs, bm=128, bn=128,
                bk=64, body="tc"),
            lambda: K.ftimm_gemm_ragged_swiglu(x17[0], wg_odd, wu_odd, offs,
                                               bm=128, bn=128, bk=64,
                                               body="tc")):
        with pytest.raises(ValueError):
            call()
    for kernel in ("ftimm_gemm_grouped_swiglu", "ftimm_gemm_ragged_swiglu"):
        assert K.launch_counts()[kernel] == 0
    got = _twice(lambda: K.ftimm_gemm_grouped_swiglu(xt, wg, wu, bm=128,
                                                     bn=128, bk=64,
                                                     body="tc"))
    _close(got, K.ftimm_gemm_grouped_swiglu_plain(xt, wg, wu))


@pytest.mark.parametrize("rows,body", [(16, "stream"), (320, "tc")])
def test_grouped_swiglu_planned_body_through_dispatch(dev, rows, body):
    """grouped_swiglu plans the pair's body: the stream at 16 rows a group,
    the tensor cores at mixtral's training capacity; fp32 stays FMA."""
    from repro_torch.core.gemm import grouped_swiglu
    gen = torch.Generator(device=dev).manual_seed(66)
    x = torch.randn(4, rows, GK, generator=gen, device=dev).to(BF16)
    wg, wu = _pair_panels(4, dev, 67)
    K.reset_launch_counts()
    got = grouped_swiglu(x, wg, wu)
    s = grouped_swiglu(x.float(), wg.float(), wu.float())
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_grouped_swiglu_plain(x, wg, wu))
    _close(s, K.ftimm_gemm_grouped_swiglu_plain(x.float(), wg.float(),
                                                wu.float()))
    counts = K.body_counts()["ftimm_gemm_grouped_swiglu"]
    assert counts[body] == 1 and counts["fma"] == 1


@pytest.mark.parametrize("sizes,body", [([1, 0, 2, 1], "stream"),
                                        ([300, 0, 500, 224], "tc")])
def test_ragged_swiglu_planned_body_through_dispatch(dev, sizes, body):
    from repro_torch.core.gemm import ragged_swiglu
    x, _, offs = _ragged_operands(sizes, 0, "nn", dev, seed=68)
    wg, wu = _pair_panels(len(sizes), dev, 69)
    K.reset_launch_counts()
    got = ragged_swiglu(x, wg, wu, offs)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_ragged_swiglu_plain(x, wg, wu, offs))
    assert K.body_counts()["ftimm_gemm_ragged_swiglu"][body] == 1


# ---------------------------------------------------------------------------
# The dense SwiGLU pair's stream and tensor-core bodies: K = 1032 and N =
# 264 not multiples of the 64-deep box or the 128-column strip, both panel
# layouts (nn: N-contiguous, nt: K-contiguous views), both outputs; two runs
# of each call must give the same bits.
# ---------------------------------------------------------------------------

def _dense_pair(m, trans, dev, seed, k=GK, n=GN):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=dev).to(BF16)
    shape = (k, n) if trans == "nn" else (n, k)
    wg, wu = ((torch.randn(shape, generator=gen, device=dev)
               * k ** -0.5).to(BF16) for _ in range(2))
    if trans == "nt":       # (K, N) views whose K has unit stride
        wg, wu = wg.t(), wu.t()
    return x, wg, wu


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("kslices", [1, 3, 8])
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_dense_swiglu_stream_body(dev, m, kslices, trans, out):
    x, wg, wu = _dense_pair(m, trans, dev, seed=70)
    K.reset_launch_counts()
    got = _twice(lambda: K.ftimm_gemm_swiglu(
        x, wg, wu, bm=16, bn=128, bk=64, out_dtype=out, body="stream",
        kslices=kslices))
    _close(got, K.ftimm_gemm_swiglu_plain(x, wg, wu, out_dtype=out))
    assert K.body_counts()["ftimm_gemm_swiglu"]["stream"] == 2


@pytest.mark.parametrize("m", [17, 128, 1024])
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("order", ["mn", "nm"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_dense_swiglu_tc_body(dev, m, trans, order, out):
    x, wg, wu = _dense_pair(m, trans, dev, seed=71)
    K.reset_launch_counts()
    got = _twice(lambda: K.ftimm_gemm_swiglu(
        x, wg, wu, bm=128, bn=128, bk=64, out_dtype=out, body="tc",
        dim_order=order))
    _close(got, K.ftimm_gemm_swiglu_plain(x, wg, wu, out_dtype=out))
    assert K.body_counts()["ftimm_gemm_swiglu"]["tc"] == 2


def test_dense_swiglu_bodies_refuse_what_they_cannot_take(dev):
    """A body the operands do not allow raises before any launch: more
    than 16 rows on the stream, an x that is not K-major, fp32, a panel
    TMA cannot read, panels in two layouts.  No fallback."""
    x17, wg, wu = _dense_pair(17, "nn", dev, seed=72)
    x16 = x17[:16].contiguous()
    xt = x16.t().contiguous().t()                 # x MN-major
    big = torch.randn(2, GK, GN + 8, device=dev).to(BF16)
    wg_odd, wu_odd = big[0, :, 1:GN + 1], big[1, :, 1:GN + 1]   # base + 2 B
    K.reset_launch_counts()
    for call in (
            lambda: K.ftimm_gemm_swiglu(x17, wg, wu, bm=16, bn=128, bk=64,
                                        body="stream"),
            lambda: K.ftimm_gemm_swiglu(xt, wg, wu, bm=16, bn=128, bk=64,
                                        body="stream"),
            lambda: K.ftimm_gemm_swiglu(xt, wg, wu, bm=128, bn=128, bk=64,
                                        body="tc"),
            lambda: K.ftimm_gemm_swiglu(x16.float(), wg.float(), wu.float(),
                                        bm=128, bn=128, bk=64, body="tc"),
            lambda: K.ftimm_gemm_swiglu(x16, wg_odd, wu_odd, bm=128, bn=128,
                                        bk=64, body="tc"),
            lambda: K.ftimm_gemm_swiglu(x16, wg, wu.t().contiguous().t(),
                                        bm=128, bn=128, bk=64, body="tc")):
        with pytest.raises(ValueError):
            call()
    assert K.launch_counts()["ftimm_gemm_swiglu"] == 0


@pytest.mark.parametrize("rows,body", [(4, "stream"), (128, "tc"),
                                       (1024, "tc")])
def test_dense_swiglu_planned_body_through_dispatch(dev, rows, body):
    """matmul_swiglu plans the pair's body at qwen's widths: the stream at
    the 4 decode rows, the tensor cores at a bucket prefill's 128 rows and
    the 1024 training rows; fp32 stays on the FMA body.  With gradients the
    forward takes the same body and the backward the planned ftimm_gemm
    products, the gradients holding against the CPU."""
    from repro_torch.core.gemm import matmul_swiglu
    x, wg, wu = _dense_pair(rows, "nn", dev, seed=73, k=2048, n=6144)
    K.reset_launch_counts()
    got = matmul_swiglu(x, wg, wu)
    s = matmul_swiglu(x.float(), wg.float(), wu.float())
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_swiglu_plain(x, wg, wu))
    _close(s, K.ftimm_gemm_swiglu_plain(x.float(), wg.float(), wu.float()))
    counts = K.body_counts()["ftimm_gemm_swiglu"]
    assert counts[body] == 1 and counts["fma"] == 1
    K.reset_launch_counts()
    _grads_match(matmul_swiglu, [t.cpu() for t in (x, wg, wu)], dev)
    assert K.body_counts()["ftimm_gemm_swiglu"] == {
        "fma": 0, "tc": int(body == "tc"), "stream": int(body == "stream")}


# ---------------------------------------------------------------------------
# Split-K on the tensor cores: the partials summed in split order inside
# the kernel, the epilogue after the sum; every trans, K tails, split
# counts above the K steps (those splits contribute zeros).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", K.TC_TILES)
@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("nsplit", [1, 2, 4, 8, 40])
@pytest.mark.parametrize("m,k,n", [(200, 1032, 264), (40, 264, 520)])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_splitk_tc_body(dev, tile, trans, nsplit, m, k, n, out):
    a, b = _operands(trans, m, k, n, BF16, dev, seed=74)
    bm, bn, bk = tile
    K.reset_launch_counts()
    got = _twice(lambda: K.ftimm_gemm_splitk(
        a, b, bm=bm, bn=bn, bk=bk, nsplit=nsplit, trans=trans,
        out_dtype=out, body="tc"))
    _close(got, K.ftimm_gemm_splitk_plain(a, b, bk=64, nsplit=nsplit,
                                          trans=trans, out_dtype=out))
    assert K.body_counts()["ftimm_gemm_splitk"]["tc"] == 2


@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
def test_splitk_tc_epilogue_after_the_sum(dev, epi, out):
    m, k, n = 200, 1032, 264
    a, b = _operands("tn", m, k, n, BF16, dev, seed=75)
    g = torch.Generator(device=dev).manual_seed(76)
    bias = torch.randn(n, generator=g, device=dev).to(BF16)
    res = torch.randn(m, n, generator=g, device=dev).to(BF16)
    scale = torch.rand(n, generator=g, device=dev)
    kw = dict(epilogue=epi, bias=bias if epi.bias else None,
              residual=res if epi.residual else None,
              scale=scale if epi.scale_vec else None, out_dtype=out)
    K.reset_launch_counts()
    got = ops.gemm(a, b, bm=128, bn=128, bk=64, trans="tn", nsplit=4,
                   body="tc", **kw)
    torch.cuda.synchronize()
    assert K.body_counts()["ftimm_gemm_splitk"] == {"fma": 0, "tc": 1}
    _close(got, K.ftimm_gemm_plain(a, b, trans="tn", **kw))


def test_splitk_tc_body_refuses_what_it_cannot_take(dev):
    """fp32 and mixed pairs, operands TMA cannot read and tiles off the
    tensor-core menu raise before any launch; ops.gemm's stream body has no
    split-K."""
    a, b = _operands("tn", 200, 1032, 264, BF16, dev, seed=77)
    odd = torch.randn(1032, 209, device=dev).to(BF16)[:, 1:]   # base + 2 B
    K.reset_launch_counts()
    for call in (
            lambda: K.ftimm_gemm_splitk(a.float(), b.float(), bm=128, bn=128,
                                        bk=64, nsplit=4, trans="tn",
                                        body="tc"),
            lambda: K.ftimm_gemm_splitk(a, b.float(), bm=128, bn=128, bk=64,
                                        nsplit=4, trans="tn", body="tc"),
            lambda: K.ftimm_gemm_splitk(odd, b, bm=128, bn=128, bk=64,
                                        nsplit=4, trans="tn", body="tc"),
            lambda: K.ftimm_gemm_splitk(a, b, bm=128, bn=128, bk=16,
                                        nsplit=4, trans="tn", body="tc"),
            lambda: ops.gemm(a, b, trans="tn", nsplit=4, body="stream")):
        with pytest.raises(ValueError):
            call()
    assert K.launch_counts()["ftimm_gemm_splitk"] == 0


# ---------------------------------------------------------------------------
# The measured tuning loop on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def clean_store(dev):
    from repro_torch.core.gemm import tuner
    tuner.clear_plan_cache()
    yield
    tuner.clear_plan_cache()


@pytest.mark.parametrize("sig", [(4, 2048, 4096, 1), (4, 2048, 2048, 1),
                                 (4, 6144, 2048, 1), (4, 2048, 6144, 2)])
def test_autotune_winner_retimes_within_ten_percent(dev, clean_store, sig):
    """qwen3-1.7b's decode shapes (q/k/v, o, down, the gate/up pair): the
    measured winner, timed again in a second call, is no slower than 1.10x
    the analytic plan timed beside it."""
    from repro_torch.core.gemm import autotune
    m, k, n, panels = sig
    r = autotune.autotune_gemm(m, k, n, 2, 2, top_k=4, panels=panels)
    assert r.measured_dims == r.dims and r.t_measured <= r.t_analytic
    t_win, t_ana = autotune.time_dense_plans(
        m, k, n, [r.plan, r.analytic_plan], in_bytes=2, out_bytes=2,
        panels=panels, seed=1)
    assert t_win <= 1.10 * t_ana, (r.timed, t_win, t_ana)


def test_saved_store_roundtrips_on_the_cards_kind(dev, clean_store,
                                                  tmp_path):
    from repro_torch.core.gemm import autotune, plan_store, tuner
    r = autotune.autotune_gemm(4, 2048, 2048, 2, 2, top_k=2)
    kind = plan_store.device_kind()
    assert kind == torch.cuda.get_device_name().lower().replace(" ", "_")
    path = tmp_path / f"plan_cache_{kind}.json"
    autotune.save_plan_cache(str(path))
    autotune.clear_plan_store()
    assert autotune.load_plan_cache(str(path)) == 1
    assert not plan_store.get_store().quarantined
    p = tuner.plan_gemm(4, 2048, 2048, 2, 2)
    assert p.mode == "cached" and (p.body, p.kslices) == (r.plan.body,
                                                          r.plan.kslices)


def test_cached_split_k_record_launches_split_k(dev, clean_store):
    """A stored nsplit = 4 record at qwen's dW shape sends the dispatch
    layer's "tn" product to ftimm_gemm_splitk, which matches its plain
    version."""
    from repro_torch.core.gemm import matmul, plan_store, tuner
    m, k, n = 2048, 1024, 6144
    a, b = _operands("tn", m, k, n, BF16, dev, seed=41)
    plan_store.get_store().put(
        tuner.dense_key(m, k, n, 2, 2, trans="tn"),
        {"body": "tc", "bm": 128, "bn": 128, "bk": 64, "dim_order": "mn",
         "nsplit": 4})
    tuner.clear_planner_caches()
    K.reset_launch_counts()
    got = matmul(a, b, trans="tn")
    torch.cuda.synchronize()
    assert K.body_counts()["ftimm_gemm_splitk"] == {"fma": 0, "tc": 1}
    assert K.launch_counts()["ftimm_gemm"] == 0
    _close(got, K.ftimm_gemm_splitk_plain(a, b, bk=64, nsplit=4, trans="tn"))


# ---------------------------------------------------------------------------
# The quantized type codes (the FMA bodies of ftimm_gemm and
# ftimm_gemm_ragged): int8 x int8 bitwise (an exact int32 sum, the same
# fp32 flush), the mixed and fp8 pairs at the tolerances above (fp32 sums
# of exact products in another order).
# ---------------------------------------------------------------------------

FP32, I8 = torch.float32, torch.int8
E4, E5 = torch.float8_e4m3fn, torch.float8_e5m2
QUANT_PAIRS = [(BF16, I8), (FP32, I8), (I8, I8), (E4, E4), (E5, E5)]


def _quantized(shape, dtype, gen, dev):
    from repro_torch.core import quant
    x = torch.randn(shape, generator=gen, device=dev)
    if dtype == I8:
        return quant.quantize(x, quant.symmetric_scale(x))
    if dtype in (E4, E5):
        return quant.quantize_fp8(x, "e4m3" if dtype == E4 else "e5m2")[0]
    return x.to(dtype)


def _quant_close(got, want, pair):
    if pair == (I8, I8):
        assert torch.equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("tile", K.QUANT_TILES)
@pytest.mark.parametrize("trans", ["nn", "nt"])
@pytest.mark.parametrize("m,k,n", [(33, 257, 65), (4, 5120, 1024),
                                   (128, 1100, 96)])
@pytest.mark.parametrize("pair", QUANT_PAIRS, ids=str)
@pytest.mark.parametrize("out", [BF16, FP32])
def test_quant_dense_kernel(dev, tile, trans, m, k, n, pair, out):
    gen = torch.Generator(device=dev).manual_seed(m + k)
    a = _quantized((m, k), pair[0], gen, dev)
    b = _quantized((k, n) if trans == "nn" else (n, k), pair[1], gen, dev)
    sv = torch.rand(n, generator=gen, device=dev) + 0.5
    epi = Epilogue(scale_vec=True)
    got = K.ftimm_gemm(a, b, bm=tile[0], bn=tile[1], bk=tile[2], trans=trans,
                       out_dtype=out, epilogue=epi, scale=sv)
    torch.cuda.synchronize()
    _quant_close(got, K.ftimm_gemm_plain(a, b, trans=trans, out_dtype=out,
                                         epilogue=epi, scale=sv), pair)


@pytest.mark.parametrize("b_dtype", [I8, E4, E5])
@pytest.mark.parametrize("a_dtype", [BF16, FP32])
def test_quant_dense_dx_kernel(dev, a_dtype, b_dtype):
    """The straight-through dX: a cotangent against the 1-byte panel."""
    gen = torch.Generator(device=dev).manual_seed(3)
    dz = torch.randn(37, 96, generator=gen, device=dev).to(a_dtype)
    w = _quantized((200, 96), b_dtype, gen, dev)
    got = ops.gemm(dz, w, trans="nt", out_dtype=FP32)
    torch.cuda.synchronize()
    _close(got, K.ftimm_gemm_plain(dz, w, trans="nt", out_dtype=FP32))


@pytest.mark.parametrize("tile", K.QUANT_TILES)
@pytest.mark.parametrize("sizes", RAGGED_DISTS)
@pytest.mark.parametrize("pair", QUANT_PAIRS, ids=str)
@pytest.mark.parametrize("tail", [0, 5])
def test_quant_ragged_kernel(dev, tile, sizes, pair, tail):
    g, k, n = len(sizes), 1100, 96
    t = sum(sizes) + tail
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _quantized((t, k), pair[0], gen, dev)
    w = _quantized((g, k, n), pair[1], gen, dev)
    sv = torch.rand(g, n, generator=gen, device=dev) + 0.5
    offs = _offsets(sizes, dev)
    epi = Epilogue(scale_vec=True)
    for out in (BF16, FP32):
        got = K.ftimm_gemm_ragged(x, w, offs, bm=tile[0], bn=tile[1],
                                  bk=tile[2], out_dtype=out, epilogue=epi,
                                  scale=sv)
        torch.cuda.synchronize()
        _quant_close(got, K.ftimm_gemm_ragged_plain(
            x, w, offs, out_dtype=out, epilogue=epi, scale=sv), pair)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """The repo's chip_smoke.py as a module: its [quant] card checks are
    the one copy of the checks below."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_quant_operands_refused_where_not_built(dev):
    """The tensor-core and stream bodies and the kernels without the
    quantized codes raise on a 1-byte operand; nothing falls back."""
    _chip_smoke().check_quant_refusals(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    a = _quantized((4, 256), I8, gen, dev)
    b = _quantized((256, 256), I8, gen, dev)
    with pytest.raises(ValueError, match="not a compiled tile"):
        K.ftimm_gemm(a, b, bm=128, bn=128, bk=16, out_dtype=FP32)


@pytest.mark.parametrize("mode", ["w8", "w4", "int8", "fp8_e4m3",
                                  "fp8_e5m2"])
def test_quant_matmul_forward_and_backward_on_the_card(dev, mode):
    """matmul(quant=) and ragged_matmul(quant=) with a tail, forward and
    straight-through backward, card against CPU on the same inputs."""
    _chip_smoke().check_quant_backward(dev, modes=(mode,))


# ------------------ the recurrent families (dense-slot rung) ---------------

@pytest.mark.parametrize("m", [2, 3, 4, 40, 300])
@pytest.mark.parametrize("k,n", [(1024, 4384), (2048, 1024), (3584, 14576),
                                 (7168, 3584)])
def test_ssm_projections_through_dispatch(dev, m, k, n):
    """mamba2's and zamba2's in / out projections (N = 4384 and 14576 end
    in a 32- and a 112-column edge tile) at decode, conv-tail and prefill
    rows, through the planner: at most 4 rows on the stream body."""
    from repro_torch.core.gemm import matmul
    a, b = _operands("nn", m, k, n, torch.bfloat16, dev, seed=m)
    K.reset_launch_counts()
    got = matmul(a, b)
    _close(got, K.ftimm_gemm_plain(a, b))
    if m <= 4:
        assert K.body_counts()["ftimm_gemm"]["stream"] == 1


@pytest.mark.parametrize("arch,layers", [("mamba2-370m-smoke", None),
                                         ("zamba2-7b-smoke", 5)])
def test_recurrent_models_on_the_card_match_the_cpu(dev, arch, layers):
    """fp32 smoke SSM and hybrid (2 groups and a remainder), same weights:
    prefill logits and every cache leaf, then 2 decode steps, card against
    CPU within 1e-4; the engine's dense-slot tokens are equal."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cpu_model = M.init_params(cfg, 0, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(dev)}
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (2, 40))
    out = {}
    for name, model in models.items():
        device = torch.device(name) if name == "cpu" else dev
        cache = M.make_cache(cfg, 2, 48, device=device)
        logits, cache = M.prefill(model, cfg, {"tokens": torch.as_tensor(
            toks[:, :37]).to(device)}, cache)
        steps = [logits.cpu()]
        for s in range(2):
            logits, cache = M.decode_step(model, cfg, torch.as_tensor(
                toks[:, 37 + s:38 + s]).to(device), cache, 37 + s)
            steps.append(logits.cpu())
        reqs = ServeEngine(cfg, model, batch_slots=2, max_len=32,
                           device=device).run(
            [Request(rid=i, prompt=toks[i % 2, :3 + 4 * i].astype(np.int32),
                     max_new_tokens=4) for i in range(3)])
        out[name] = (steps, {k: v.cpu() for k, v in cache.items()},
                     [r.out_tokens for r in reqs])
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        _close(got, want)
    for key, want in out["cpu"][1].items():
        _close(out["cuda"][1][key], want)
    assert out["cuda"][2] == out["cpu"][2]


# --------- the stub-frontend families: whisper-base and llava-next-34b -------

def test_family_shapes_against_plain_and_decode_on_the_stream(dev):
    """Every [families] shape of chip_smoke.py (whisper's and llava's decode
    projections, unembeds, pairs and fp32 attention; the encoder, cross K /
    V and patch-projection prefills) against its plain version, and each
    bf16 4-row decode call on the stream body through dispatch."""
    cs = _chip_smoke()
    cases = cs.family_path_cases()
    cs.check(cases, dev)
    cs.check_decode_bodies(cases, dev)


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b"])
def test_family_smoke_models_on_the_card_match_the_cpu(dev, arch):
    """fp32 smoke whisper / llava with seeded frames / patches: prefill
    logits card against CPU within 1e-4 and the engines' greedy tokens
    equal (whisper on the dense-slot rung, llava on the paged one)."""
    _chip_smoke().small_reference(dev, arch)


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-34b",
                                  "mamba2-370m", "zamba2-7b"])
def test_family_smoke_gradients_on_the_card_match_the_cpu(dev, arch):
    """fp32 smoke (zamba2 at 5 layers), one forward / backward: the loss
    and every gradient leaf, card against CPU, within 1e-4."""
    _chip_smoke().train_reference_smoke(arch, dev)


# ----- the last dense archs, the fused -> unfused rung, remat="dots" -------

def test_arch_shapes_against_plain_and_decode_on_the_stream(dev):
    """Every [archs] decode shape of chip_smoke.py (gemma3-4b's head_dim 256
    fp32 attention over the paged view and 262,144-row unembed,
    minitron-4b's 256,000-row unembed, the three models' pairs and
    projections) against its plain version, each bf16 4-row call on the
    stream body through dispatch."""
    cs = _chip_smoke()
    cases = [c for a in cs.NEW_ARCHS for c in cs.arch_path_cases(a)]
    cs.check(cases, dev)
    cs.check_decode_bodies(cases, dev)


@pytest.mark.parametrize("arch", ["gemma3-4b", "minitron-4b", "qwen3-8b"])
def test_arch_smoke_models_on_the_card_match_the_cpu(dev, arch):
    """fp32 smoke configs: prefill logits card against CPU within 1e-4 and
    the engines' greedy tokens equal."""
    _chip_smoke().small_reference(dev, arch)


def _rung_calls(dev):
    from repro_torch.core.gemm import (grouped_swiglu, matmul, matmul_swiglu,
                                       ragged_swiglu)
    g = torch.Generator(device=dev).manual_seed(7)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    x, res = r(4, 512), r(4, 384)
    w, wg, wu = r(512, 384), r(512, 384), r(512, 384)
    xg, gg, gu = r(3, 4, 512), r(3, 512, 384), r(3, 512, 384)
    offs = torch.tensor([0, 1, 1, 4], device=dev, dtype=torch.int32)
    return {
        "dense_epilogue": lambda: matmul(x, w, epilogue=Epilogue(
            residual=True), residual=res),
        "dense_pair": lambda: matmul_swiglu(x, wg, wu),
        "grouped_pair": lambda: grouped_swiglu(xg, gg, gu),
        "ragged_pair": lambda: ragged_swiglu(x, gg, gu, offs)}


@pytest.mark.parametrize("name", ["dense_epilogue", "dense_pair",
                                  "grouped_pair", "ragged_pair"])
def test_fused_to_unfused_rung_on_the_card(dev, name):
    """An injected ``kernel_fused`` failure takes the unfused spelling on
    the kernels (no plain version): counted once, within the bf16
    tolerance of the fused launch."""
    import warnings
    from repro_torch.core.gemm import tuner
    from repro_torch.runtime import chaos
    call = _rung_calls(dev)[name]
    tuner.clear_plan_cache()
    fused = call()
    K.reset_launch_counts()
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("kernel_fused")])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = call()
    torch.cuda.synchronize()
    launched = {k: v for k, v in K.launch_counts().items() if v}
    assert sum(tuner.degraded_stats().values()) == 1
    kernel = {"dense_epilogue": "ftimm_gemm", "dense_pair": "ftimm_gemm",
              "grouped_pair": "ftimm_gemm_grouped",
              "ragged_pair": "ftimm_gemm_ragged"}[name]
    assert launched == {kernel: 1 if name == "dense_epilogue" else 2}
    _close(got, fused)
    tuner.clear_plan_cache()


def test_kernel_site_raises_on_the_card(dev):
    from repro_torch.core.gemm import matmul
    from repro_torch.runtime import chaos
    a, b = _operands("nn", 4, 256, 128, torch.bfloat16, dev)
    K.reset_launch_counts()
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("kernel")])):
        with pytest.raises(chaos.KernelLaunchFailure):
            matmul(a, b)
    assert not any(K.launch_counts().values())


def test_remat_dots_gradients_bitwise_on_the_card(dev):
    """qwen3-1.7b-smoke in bf16 on fp32 masters, one forward / backward
    under remat "full" and "dots": the loss and every gradient bitwise
    equal (PyTorch's ops in their deterministic algorithms), and 5
    ``ftimm_gemm`` and one pair a layer fewer under "dots"."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg0 = get_config("qwen3-1.7b-smoke")
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(2, cfg0.vocab_size, (2, 32), generator=g,
                         device=dev)
    out = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in ("full", "dots"):
            cfg = dataclasses.replace(cfg0, remat=remat)
            model = M.init_params(cfg, 0, device=dev, dtype="float32")
            K.reset_launch_counts()
            loss, _ = M.loss_fn(model, cfg, {"tokens": toks, "labels": toks})
            loss.backward()
            torch.cuda.synchronize()
            out[remat] = (loss.detach(), K.launch_counts(),
                          {n: p.grad for n, p in model.named_parameters()})
    finally:
        torch.use_deterministic_algorithms(was)
    (lf, cf, gf), (ld, cd, gd) = out["full"], out["dots"]
    assert torch.equal(lf, ld)
    for name in gf:
        assert torch.equal(gf[name], gd[name]), name
    layers = cfg0.num_layers
    assert cf["ftimm_gemm"] - cd["ftimm_gemm"] == 5 * layers
    assert cf["ftimm_gemm_swiglu"] - cd["ftimm_gemm_swiglu"] == layers


# ---------------------------------------------------------------------------
# The mesh executors on the card (-k dist).  One H100 cannot test NCCL
# across GPUs (NCCL refuses two ranks on one GPU): two ranks share the card
# over gloo (the host transport), and a one-rank NCCL world runs the device
# transport's calls.
# ---------------------------------------------------------------------------

def _dist_moe_inputs(dev, sizes, d=256, f=512, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    g = len(sizes)
    offs = _offsets(sizes, dev)
    t = int(offs[-1].item())
    return (r(t, d), (r(g, d, f, scale=d ** -0.5), r(g, d, f, scale=d ** -0.5),
                      r(g, f, d, scale=f ** -0.5)), offs)


def test_dist_nccl_world_of_one_is_bitwise(dev, tmp_path):
    """A one-rank NCCL mesh (the device transport): ``ep_ragged_moe`` and
    ``dist_matmul``'s three modes equal the one-device composition of the
    same products bitwise, and launch the kernels."""
    import torch.distributed as tdist
    from repro_torch.core.gemm import distributed as X
    from repro_torch.core.gemm import dispatch as d
    from repro_torch.launch.mesh import make_mesh
    tdist.init_process_group("nccl", init_method=f"file://{tmp_path}/s",
                             rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("x",), device=dev)
        assert (mesh.backend, mesh.transport) == ("nccl", "device")
        x, panels, offs = _dist_moe_inputs(dev, [9, 0, 30, 3])
        want = d.ragged_matmul(d.ragged_swiglu(x, panels[0], panels[1], offs),
                               panels[2], offs)
        K.reset_launch_counts()
        for sched in ("gather", "ring"):
            got = X.ep_ragged_moe(x, *panels, offs, mesh=mesh, axis="x",
                                  schedule=sched)
            assert torch.equal(got, want), sched
        assert K.launch_counts()["ftimm_gemm_ragged_swiglu"] == 2
        a = torch.randn(4, 1536, device=dev).to(torch.bfloat16)
        b = torch.randn(1536, 512, device=dev).to(torch.bfloat16)
        res = torch.randn(4, 512, device=dev).to(torch.bfloat16)
        epi = Epilogue(residual=True)
        kp = epi.apply(d.matmul(a, b, out_dtype=torch.float32),
                       residual=res).to(torch.bfloat16)
        for sched in ("gather", "ring"):
            assert torch.equal(X.dist_matmul(
                a, b, mesh=mesh, axis="x", strategy="k_parallel",
                schedule=sched, epilogue=epi, residual=res), kp), sched
        assert torch.equal(X.dist_matmul(
            a, b, mesh=mesh, axis="x", strategy="m_parallel", epilogue=epi,
            residual=res), d.matmul(a, b, epilogue=epi, residual=res))
    finally:
        tdist.destroy_process_group()


def test_dist_two_ranks_share_the_card_over_gloo(dev, tmp_path):
    """Two ranks on one card, gloo with CUDA tensors (the host transport):
    the identity round trip is bitwise under both schedules and both
    realizations, and ``ep_ragged_moe``'s forward and backward (fp32)
    launch the ragged kernels on every rank, within 1e-4 of the one-device
    call."""
    import numpy as np
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_world import World
    from repro_torch.core.gemm import dispatch as d
    world = World(2, tmp_path, timeout=300)
    try:
        sizes = [9, 0, 30, 3]
        x, panels, offs = _dist_moe_inputs(dev, sizes, d=128, f=256)
        offs_np = offs.cpu().numpy()
        xf = x.float().cpu().numpy()
        eye = np.broadcast_to(np.eye(128, dtype=np.float32),
                              (4, 128, 128)).copy()
        for sched in ("gather", "ring"):
            for a2a in ("dense", "primitive"):
                for r in world.run("ep", "matmul", xf, [eye], offs_np,
                                   schedule=sched, a2a=a2a, device="cuda"):
                    np.testing.assert_array_equal(r["y"], xf)
                    assert r["launches"]["ftimm_gemm_ragged"] >= 1
        p32 = [w.float() for w in panels]
        want = d.ragged_matmul(d.ragged_swiglu(x.float(), p32[0], p32[1],
                                               offs), p32[2], offs).cpu()
        ws = [w.cpu().numpy() for w in p32]
        ct = np.ones((x.shape[0], 128), np.float32)
        for r in world.run("ep", "moe", xf, ws, offs_np, schedule="gather",
                           ct=ct, device="cuda"):
            _close(torch.from_numpy(r["y"]), want)
            assert r["counts"]["staged_bytes"] > 0
            for name in ("ftimm_gemm_ragged", "ftimm_gemm_ragged_swiglu",
                         "ftimm_gemm_ragged_dw"):
                assert r["launches"].get(name), (name, r["launches"])
    finally:
        world.close()


def test_mesh_train_step_two_ranks_share_the_card(dev, tmp_path):
    """A (data 2, model 1) ZeRO-3 step of qwen3-1.7b-smoke in fp32 on two
    ranks sharing the card over gloo: every rank launches ``ftimm_gemm``,
    ``ftimm_gemm_swiglu`` and ``ftimm_gemm_grouped``, and the losses,
    gradient norms and gathered parameters of 2 steps are the one-rank
    step's on the card within 1e-4."""
    import dataclasses

    import numpy as np
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_world import World
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.weights import (from_numpy_params,
                                            to_numpy_params)
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    arch = "qwen3-1.7b-smoke"
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    tree = to_numpy_params(M.init_params(cfg, 0, device="cpu",
                                         dtype="float32"))
    data = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train"))
    batches = [data.host_batch(i) for i in range(2)]
    model = from_numpy_params(tree, cfg, dev, dtype=torch.float32)
    step = make_train_step(cfg, adamw.OptConfig())
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    want = []
    for b in batches:
        model, opt, m = step(model, opt, {k: torch.as_tensor(v).to(dev)
                                          for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    world = World(2, tmp_path, timeout=300)
    try:
        ranks = world.run("mesh_steps", arch, (2, 1), tree, batches,
                          device="cuda")
    finally:
        world.close()
    for r in ranks:
        for name in ("ftimm_gemm", "ftimm_gemm_swiglu",
                     "ftimm_gemm_grouped"):
            assert r["launches"].get(name), (name, r["launches"])
        for got, w in zip(r["metrics"], want):
            for key in ("loss", "grad_norm"):
                assert abs(got[key] - w[key]) <= 1e-4 * abs(w[key]), key
    mine = to_numpy_params(model)
    for name in ("embed", "final_norm"):
        _close(torch.from_numpy(np.asarray(ranks[0]["params"][name])),
               torch.from_numpy(np.asarray(mine[name])))


def test_tp_decode_with_a_cache_two_ranks_share_the_card(dev, tmp_path):
    """Serving qwen3-1.7b-smoke under tensor parallelism with its KV cache
    (every attention panel and the cache's sequence over "model", (1, 2)),
    fp32, on two ranks sharing the card over gloo: each rank launches its
    kernels, and the prefill and 3 decode steps' logits are one rank's
    on the card within 1e-4, the greedy tokens equal."""
    import dataclasses

    import numpy as np
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_world import World
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.weights import (from_numpy_params,
                                            to_numpy_params)
    arch = "qwen3-1.7b-smoke"
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    tree = to_numpy_params(M.init_params(cfg, 0, device="cpu",
                                         dtype="float32"))
    rng = np.random.default_rng(5)
    prompt = rng.integers(2, cfg.vocab_size, (2, 10)).astype(np.int32)
    steps = rng.integers(2, cfg.vocab_size, (2, 3)).astype(np.int32)
    model = from_numpy_params(tree, cfg, dev)
    cache = M.make_cache(cfg, 2, 16, device=dev)
    logits, cache = M.prefill(
        model, cfg, {"tokens": torch.as_tensor(prompt).long().to(dev)}, cache)
    want = [logits]
    for i in range(3):
        logits, cache = M.decode_step(
            model, cfg, torch.as_tensor(steps[:, i:i + 1]).long().to(dev),
            cache, 10 + i)
        want.append(logits)
    world = World(2, tmp_path, timeout=300)
    try:
        ranks = world.run("tp_serve", arch, tree, prompt, steps, 16,
                          device="cuda")
    finally:
        world.close()
    for r in ranks:
        assert r["cache_rows"] == 8
        for name in ("ftimm_gemm", "ftimm_gemm_swiglu",
                     "ftimm_gemm_grouped"):
            assert r["launches"].get(name), (name, r["launches"])
        for got, w in zip(r["logits"], want):
            _close(torch.from_numpy(np.asarray(got)), w.cpu())
            assert (np.asarray(got).argmax(-1)
                    == w.argmax(-1).cpu().numpy()).all()


@pytest.mark.parametrize("arch,shape,kw,kernels", [
    ("mixtral-8x7b-smoke", (2, 1), {}, ("ftimm_gemm_grouped_swiglu",
                                        "ftimm_gemm_grouped")),
    ("mixtral-8x7b-smoke", (2, 1), {"moe_ep": True},
     ("ftimm_gemm_grouped_swiglu", "ftimm_gemm_grouped")),
    ("whisper-base-smoke", (1, 2), {}, ("ftimm_gemm", "ftimm_gemm_swiglu")),
    ("qwen3-1.7b-smoke", (2, 1), {"zero1": True},
     ("ftimm_gemm", "ftimm_gemm_swiglu"))],
    ids=["mixtral-capacity", "mixtral-capacity-ep", "whisper-tp",
         "qwen-zero1"])
def test_mesh_configs_two_ranks_share_the_card(dev, tmp_path, arch, shape,
                                               kw, kernels):
    """The mesh configurations of capacity MoE with the rows cut, whisper
    under TP and ZeRO-1, in fp32 on two ranks sharing the card over gloo:
    each rank launches the kernels of its path, and the loss and gradient
    norm of one step are the one-rank step's on the card within 1e-4."""
    import dataclasses
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_world import World
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models.weights import (from_numpy_params,
                                            to_numpy_params)
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    tree = to_numpy_params(M.init_params(cfg, 0, device="cpu",
                                         dtype="float32"))
    batch = SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train")).host_batch(0)
    model = from_numpy_params(tree, cfg, dev, dtype=torch.float32)
    step = make_train_step(cfg, adamw.OptConfig())
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    _, _, m = step(model, opt, {k: torch.as_tensor(v).to(dev)
                                for k, v in batch.items()})
    want = {k: float(v) for k, v in m.items()}
    world = World(2, tmp_path, timeout=300)
    try:
        ranks = world.run("mesh_steps", arch, shape, tree, [batch],
                          device="cuda", **kw)
    finally:
        world.close()
    for r in ranks:
        for name in kernels:
            assert r["launches"].get(name), (name, r["launches"])
        for key in ("loss", "grad_norm"):
            got = r["metrics"][0][key]
            assert abs(got - want[key]) <= 1e-4 * abs(want[key]), key


def test_placed_search_on_the_card(dev, tmp_path):
    """A placed ``autotune_gemm`` / ``_ragged_gemm`` (num_shards 2) times
    its local GEMMs on the kernels and is served as "cached"; on two ranks
    sharing the card ``calibrate_ici`` fits a finite fraction (host
    staging here) and both end-to-end timings give finite rows."""
    import math
    sys.path.insert(0, str(Path(__file__).parent))
    from torch_world import World
    from repro_torch.core.gemm import autotune, tuner
    tuner.clear_plan_cache()
    try:
        K.reset_launch_counts()
        autotune.autotune_gemm(4, 2048, 6144, 2, 2, num_shards=2, top_k=2,
                               repeats=3, device=dev)
        autotune.autotune_ragged_gemm(16, 4, 5120, 8192, 2, 2,
                                      num_shards=2, top_k=2, repeats=3,
                                      device=dev)
        assert K.launch_counts()["ftimm_gemm"] > 0
        assert K.launch_counts()["ftimm_gemm_ragged"] > 0
        assert tuner.plan_gemm(4, 2048, 6144, 2, 2,
                               num_shards=2).mode == "cached"
        assert tuner.plan_ragged_gemm(16, 4, 5120, 8192, 2, 2,
                                      num_shards=2).mode == "cached"
    finally:
        tuner.clear_plan_cache()
    world = World(2, tmp_path, timeout=300)
    try:
        for kind in ("ici", "ragged", "dense"):
            for r in world.run("placed", kind, device="cuda"):
                rows = [r["cal"]] if kind == "ici" else r
                for row in rows:
                    t = row.get("ici_frac", row.get("t_measured"))
                    assert math.isfinite(t) and t > 0, (kind, row)
    finally:
        world.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(2**16, 32, 32), (32, 2**16, 32),
                                   (2048, 2048, 96)])
def test_paper_adaptive_and_tgemm_plans(m, k, n, dtype, dev):
    """The paper's T1 / T2 / T3 shapes, cut: ``plan_gemm``'s and
    ``tgemm_plan``'s ``kernel_kwargs()`` through ``ops.gemm`` (TGEMM's
    fixed tile unclamped), each launching its body once."""
    from repro_torch.core.gemm import plan_gemm, tgemm_plan
    w = torch.tensor([], dtype=dtype).element_size()
    a, b = _operands("nn", m, k, n, dtype, dev)
    want = K.ftimm_gemm_plain(a, b, out_dtype=dtype)
    for plan, clamp in ((plan_gemm(m, k, n, w, w), True),
                        (tgemm_plan(m, k, n, w, w), False)):
        K.reset_launch_counts()
        got = ops.gemm(a, b, out_dtype=dtype, clamp=clamp,
                       **plan.kernel_kwargs())
        torch.cuda.synchronize()
        assert K.body_counts()["ftimm_gemm"][plan.body] == 1
        _close(got, want)
