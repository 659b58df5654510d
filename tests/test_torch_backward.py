"""The port's backward path against the JAX package, on the CPU.

* The two kernels that training brings, through their wrappers' plain
  versions: ``ops.ragged_gemm_dw`` against the reference's Pallas
  ``ragged_gemm_dw`` in interpret mode over degenerate group distributions,
  and ``ops.gemm(nsplit > 1)`` (the split-K kernel) against the reference's
  split-K ``ops.gemm`` in interpret mode, every trans, K unaligned to
  nsplit x bk, and an epilogue applied after the sum.
* Every GEMM entry point's ``torch.autograd.Function`` against
  ``jax.vjp`` of the reference's entry point (the XLA engine, as the JAX
  package's own tests run it): the output and every input's gradient for
  one random cotangent.

Tolerances, normwise max|port - jax| / max|jax|, fp32 throughout: 1e-5 for
the kernels (one GEMM, the same fp32 products summed in other orders) and
1e-4 for the autograd Functions (up to four GEMMs and an epilogue chained).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.gemm import dispatch as jd  # noqa: E402
from repro.kernels.ftimm import ops as jops  # noqa: E402
from repro.kernels.ftimm import ref as jref  # noqa: E402
from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro_torch.core.gemm import dispatch as td  # noqa: E402
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.kernels.ftimm import ops as tops  # noqa: E402
from repro_torch.kernels.ftimm import ref as tref  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402

KERNEL_TOL, GRAD_TOL = 1e-5, 1e-4


def _err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _offsets(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


# ---------------------------------------------------------------------------
# ragged dW and split-K, against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

DW_DISTS = {
    "balanced": ([16, 16, 16, 16], 0),
    "all rows to one group": ([0, 37, 0, 0], 0),
    "empty groups": ([5, 0, 17, 3, 0], 0),
    "one group over several tiles": ([3, 150, 2], 0),
    "rows outside every group": ([5, 0, 17, 3], 4),
    "T not a multiple of 16": ([7, 11, 3], 0),
    "T = 0": ([0, 0, 0], 0),
}


@pytest.mark.parametrize("dist", list(DW_DISTS))
def test_ragged_gemm_dw_matches_jax(dist):
    sizes, tail = DW_DISTS[dist]
    t, d, f = sum(sizes) + tail, 40, 72
    rng = np.random.default_rng(len(sizes) + t)
    x, dy = _np((t, d), rng), _np((t, f), rng)
    offs = _offsets(sizes)
    want = jops.ragged_gemm_dw(jnp.asarray(x), jnp.asarray(dy),
                               jnp.asarray(offs), interpret=True)
    got = tops.ragged_gemm_dw(torch.as_tensor(x), torch.as_tensor(dy),
                              torch.as_tensor(offs))
    assert got.shape == (len(sizes), d, f) and got.dtype == torch.float32
    if t == 0:
        assert not got.any() and not np.asarray(want).any()
        return
    assert _err(got, want) <= KERNEL_TOL
    for g, n in enumerate(sizes):       # an empty group's panel is zero
        if n == 0:
            assert not got[g].any()


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("nsplit", [2, 4])
@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "epilogue"])
def test_splitk_gemm_matches_jax(trans, nsplit, epilogue):
    m, k, n = 24, 300, 40          # K = 300: unaligned to nsplit x bk
    rng = np.random.default_rng(nsplit * 3 + len(trans))
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    a, b = _np(sa, rng), _np(sb, rng, k ** -0.5)
    bias, res = _np((n,), rng), _np((m, n), rng)
    kw, jkw = {}, {}
    if epilogue:
        kw = dict(epilogue=Epilogue(bias=True, activation="silu",
                                    residual=True),
                  bias=torch.as_tensor(bias), residual=torch.as_tensor(res))
        jkw = dict(epilogue=JEpilogue(bias=True, activation="silu",
                                      residual=True),
                   bias=jnp.asarray(bias), residual=jnp.asarray(res))
    want = jops.gemm(jnp.asarray(a), jnp.asarray(b), trans=trans,
                     nsplit=nsplit, interpret=True, **jkw)
    calls = []
    splitk = K.ftimm_gemm_splitk

    def spy(*args, **kwargs):
        calls.append(kwargs["nsplit"])
        return splitk(*args, **kwargs)

    K.ftimm_gemm_splitk = spy
    try:
        got = tops.gemm(torch.as_tensor(a), torch.as_tensor(b), trans=trans,
                        nsplit=nsplit, **kw)
    finally:
        K.ftimm_gemm_splitk = splitk
    assert calls == [nsplit]            # the split-K kernel's plain version
    assert _err(got, want) <= KERNEL_TOL


def test_splitk_oracle_matches_jax_and_clamps():
    """``ref.matmul_splitk`` against the reference's oracle (which needs K
    divisible by nsplit), and ``ops.gemm`` clamping nsplit to the K blocks
    of the tile (a one-block K runs the M-parallel kernel)."""
    rng = np.random.default_rng(5)
    a, b = _np((8, 256), rng), _np((256, 24), rng)
    want = jref.matmul_splitk(jnp.asarray(a), jnp.asarray(b), 4)
    got = tref.matmul_splitk(torch.as_tensor(a), torch.as_tensor(b), 4, bk=64)
    assert _err(got, want) <= KERNEL_TOL
    short = tref.matmul_splitk(torch.as_tensor(a[:, :10]),
                               torch.as_tensor(b[:10]), 8, bk=16)
    assert _err(short, a[:, :10] @ b[:10]) <= KERNEL_TOL
    called = []
    splitk = K.ftimm_gemm_splitk
    K.ftimm_gemm_splitk = lambda *x, **kw: called.append(1)
    try:
        tops.gemm(torch.as_tensor(a[:, :10]), torch.as_tensor(b[:10]),
                  nsplit=4)
    finally:
        K.ftimm_gemm_splitk = splitk
    assert not called


# ---------------------------------------------------------------------------
# autograd Functions against jax.vjp
# ---------------------------------------------------------------------------

def _vjp_check(t_fn, j_fn, inputs, rng, skip=()):
    """Run ``t_fn`` / ``j_fn`` on the same numpy ``inputs`` (floats get
    gradients unless in ``skip``; ints ride along), then compare the
    outputs and the gradients for one random cotangent."""
    diff = [i for i, x in enumerate(inputs)
            if np.issubdtype(x.dtype, np.floating) and i not in skip]
    t_in = [torch.tensor(x, requires_grad=i in diff)
            for i, x in enumerate(inputs)]
    t_out = t_fn(*t_in)
    ct = _np(tuple(t_out.shape), rng)

    def j_part(*xs):
        full = [jnp.asarray(x) for x in inputs]
        for i, x in zip(diff, xs):
            full[i] = x
        return j_fn(*full)

    j_out, vjp = jax.vjp(j_part, *[jnp.asarray(inputs[i]) for i in diff])
    j_grads = vjp(jnp.asarray(ct))
    t_grads = torch.autograd.grad(t_out, [t_in[i] for i in diff],
                                  torch.as_tensor(ct))
    assert _err(t_out, j_out) <= GRAD_TOL
    for i, tg, jg in zip(diff, t_grads, j_grads):
        assert _err(tg, jg) <= GRAD_TOL, f"input {i}"


EPILOGUES = {
    "identity": (None, ()),
    "bias": (dict(bias=True), ("bias",)),
    "residual": (dict(residual=True), ("residual",)),
    "bias-silu": (dict(bias=True, activation="silu"), ("bias",)),
    "bias-gelu-scale-residual": (dict(bias=True, activation="gelu",
                                      scale=0.5, residual=True),
                                 ("bias", "residual")),
    "scalevec-bias": (dict(scale_vec=True, bias=True), ("bias", "scale")),
}


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("epi", list(EPILOGUES))
def test_matmul_vjp_matches_jax(trans, epi):
    m, k, n = 12, 40, 24
    rng = np.random.default_rng(len(epi) + len(trans))
    spec, names = EPILOGUES[epi]
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    operands = {"bias": _np((n,), rng), "residual": _np((m, n), rng),
                "scale": _np((n,), rng)}
    inputs = [_np(sa, rng), _np(sb, rng)] + [operands[x] for x in names]
    t_epi = None if spec is None else Epilogue(**spec)
    j_epi = None if spec is None else JEpilogue(**spec)

    def t_fn(a, b, *extras):
        return td.matmul(a, b, trans=trans, epilogue=t_epi,
                         **dict(zip(names, extras)))

    def j_fn(a, b, *extras):
        return jd.matmul(a, b, trans=trans, epilogue=j_epi, backend="xla",
                         **dict(zip(names, extras)))

    _vjp_check(t_fn, j_fn, inputs, rng)


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
def test_matmul_vjp_bf16_operands_fp32_out_matches_jax(trans):
    """bf16 operands with fp32 output, as the unembed and the router run
    them in bf16 training: the fp32 cotangent enters the dX / dW products
    unrounded, as in the reference.  Two cotangent columns carry +-512 on
    top of O(1) values against two equal columns of op(B), so those large
    parts cancel in dA and only the O(1) parts remain -- which rounding the
    cotangent to bf16 (spacing 4 at 512) would erase.  Tolerance 1e-2
    normwise: the bf16 rounding of dA and dB (2^-9 relative)."""
    m, k, n, big = 12, 40, 24, 512.0
    rng = np.random.default_rng(11 + len(trans))
    bf16 = lambda x: torch.tensor(x).to(torch.bfloat16)  # noqa: E731
    a = bf16(_np({"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans], rng))
    op_b = _np((k, n), rng)
    op_b[:, 1] = op_b[:, 0]
    b = bf16(op_b.T.copy() if trans == "nt" else op_b)
    ct = _np((m, n), rng)
    ct[:, 0] += big
    ct[:, 1] -= big
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    t_out = td.matmul(ta, tb, trans=trans, out_dtype=torch.float32)
    t_da, t_db = torch.autograd.grad(t_out, [ta, tb], torch.as_tensor(ct))
    ja, jb = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (a, b))
    j_out, vjp = jax.vjp(lambda x, y: jd.matmul(x, y, trans=trans,
                                                out_dtype=jnp.float32,
                                                backend="xla"), ja, jb)
    j_da, j_db = vjp(jnp.asarray(ct))
    assert t_out.dtype == torch.float32 and t_da.dtype == torch.bfloat16
    assert _err(t_out, j_out) <= GRAD_TOL
    assert _err(t_da.float(), j_da) <= 1e-2
    assert _err(t_db.float(), j_db) <= 1e-2


def test_project_vjp_matches_jax():
    rng = np.random.default_rng(2)
    inputs = [_np((2, 5, 32), rng), _np((32, 24), rng), _np((2, 5, 24), rng)]
    epi, jepi = Epilogue(residual=True), JEpilogue(residual=True)
    _vjp_check(lambda x, w, r: td.project(x, w, epilogue=epi, residual=r),
               lambda x, w, r: jd.project(x, w, epilogue=jepi, residual=r,
                                          backend="xla"), inputs, rng)


BATCHED = {  # (a shape, b shape, bias shape or None) for G=3, M=7, K=20, N=12
    "nn": ((3, 7, 20), (3, 20, 12), None),
    "tn": ((3, 20, 7), (3, 20, 12), None),
    "nt": ((3, 7, 20), (3, 12, 20), None),
    "nn shared a": ((7, 20), (3, 20, 12), None),
    "nn shared b": ((3, 7, 20), (20, 12), None),
    "tn shared b": ((3, 20, 7), (20, 12), None),
    "nt shared a": ((7, 20), (3, 12, 20), None),
    "nn per-group bias": ((3, 7, 20), (3, 20, 12), (3, 12)),
    "nn shared bias, shared b": ((3, 7, 20), (20, 12), (12,)),
}


@pytest.mark.parametrize("case", list(BATCHED))
def test_batched_matmul_vjp_matches_jax(case):
    sa, sb, sbias = BATCHED[case]
    trans = case.split()[0]
    rng = np.random.default_rng(len(case))
    inputs = [_np(sa, rng), _np(sb, rng)]
    if sbias is not None:
        inputs.append(_np(sbias, rng))
    _vjp_check(lambda a, b, *bias: td.batched_matmul(a, b, trans=trans,
                                                     bias=(bias or [None])[0]),
               lambda a, b, *bias: jd.batched_matmul(
                   a, b, trans=trans, bias=(bias or [None])[0],
                   backend="xla"), inputs, rng)


def test_grouped_matmul_vjp_matches_jax():
    rng = np.random.default_rng(8)
    inputs = [_np((4, 8, 24), rng), _np((4, 24, 16), rng)]
    _vjp_check(td.grouped_matmul,
               lambda x, w: jd.grouped_matmul(x, w, backend="xla"),
               inputs, rng)


def test_matmul_swiglu_vjp_matches_jax():
    rng = np.random.default_rng(3)
    inputs = [_np((9, 32), rng), _np((32, 24), rng, 0.3),
              _np((32, 24), rng, 0.3)]
    _vjp_check(td.matmul_swiglu,
               lambda x, g, u: jd.matmul_swiglu(x, g, u, backend="xla"),
               inputs, rng)
    inputs[0] = inputs[0].reshape(3, 3, 32)
    _vjp_check(td.project_swiglu,
               lambda x, g, u: jd.project_swiglu(x, g, u, backend="xla"),
               inputs, rng)


def test_grouped_swiglu_vjp_matches_jax():
    rng = np.random.default_rng(4)
    inputs = [_np((4, 8, 32), rng), _np((4, 32, 24), rng, 0.3),
              _np((4, 32, 24), rng, 0.3)]
    _vjp_check(td.grouped_swiglu,
               lambda x, g, u: jd.grouped_swiglu(x, g, u, backend="xla"),
               inputs, rng)


RAGGED = {"balanced": [5, 6, 5, 5], "empty groups": [5, 0, 17, 3, 0],
          "all rows to one group": [0, 21, 0]}


@pytest.mark.parametrize("dist", list(RAGGED))
@pytest.mark.parametrize("bias", [False, True], ids=["", "bias"])
def test_ragged_matmul_vjp_matches_jax(dist, bias):
    sizes = RAGGED[dist]
    g, t, d, f = len(sizes), sum(sizes), 24, 20
    rng = np.random.default_rng(g + t)
    inputs = [_np((t, d), rng), _np((g, d, f), rng), _offsets(sizes)]
    if bias:
        inputs.append(_np((g, f), rng))
    _vjp_check(lambda x, w, o, *b: td.ragged_matmul(x, w, o,
                                                    bias=(b or [None])[0]),
               lambda x, w, o, *b: jd.ragged_matmul(
                   x, w, o, bias=(b or [None])[0], backend="xla"),
               inputs, rng)


@pytest.mark.parametrize("dist", list(RAGGED))
def test_ragged_swiglu_vjp_matches_jax(dist):
    sizes = RAGGED[dist]
    g, t, d, f = len(sizes), sum(sizes), 24, 20
    rng = np.random.default_rng(g * t)
    inputs = [_np((t, d), rng), _np((g, d, f), rng, 0.3),
              _np((g, d, f), rng, 0.3), _offsets(sizes)]
    _vjp_check(td.ragged_swiglu,
               lambda x, wg, wu, o: jd.ragged_swiglu(x, wg, wu, o,
                                                     backend="xla"),
               inputs, rng)


def test_no_grad_runs_the_bare_forward():
    """Serving (no operand requires grad, or under no_grad) records no
    graph: the planned forward runs bare."""
    a = torch.randn(4, 8, requires_grad=True)
    b = torch.randn(8, 6)
    with torch.no_grad():
        assert td.matmul(a, b).grad_fn is None
    assert td.matmul(a.detach(), b).grad_fn is None
    assert td.matmul(a, b).grad_fn is not None
