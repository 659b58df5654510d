"""The port's ftIMM wrappers (their plain versions, on the CPU) against the
JAX package's Pallas kernels run in interpret mode, on the same numpy
inputs: dense (all trans, unaligned shapes, fused epilogues), the fused
SwiGLU pair, the grouped GEMM (shared operand, per-group bias), the grouped
SwiGLU pair, and the ragged GEMM and its SwiGLU pair over degenerate group
distributions.  Plus ``Epilogue.apply`` and the shape taxonomy.

Tolerances: fp32 2e-4 (the same fp32 products summed in other orders),
bf16 2e-2 (one bf16 ulp is 2^-8 relative; both sides round the same fp32
accumulator, but their accumulators differ in the last fp32 bits)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.gemm import shapes as jshapes  # noqa: E402
from repro.kernels.ftimm import ops as jops  # noqa: E402
from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro_torch.core.gemm import shapes as tshapes  # noqa: E402
from repro_torch.kernels.ftimm import ops as tops  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _np(shape, rng, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _pair(x, dtype):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    jd, td = DT[dtype]
    return jnp.asarray(x, jd), torch.as_tensor(x).to(td)


def _close(t_out, j_out, dtype):
    got = t_out.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(j_out, jnp.float32))
    assert got.shape == want.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _operands(trans, m, k, n, rng):
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    return _np(sa, rng), _np(sb, rng)


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("m,k,n", [(33, 257, 65), (4, 128, 96), (64, 64, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_matches_jax(trans, m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + k + n)
    a, b = _operands(trans, m, k, n, rng)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    want = jops.gemm(ja, jb, trans=trans, interpret=True)
    _close(tops.gemm(ta, tb, trans=trans), want, dtype)


@pytest.mark.parametrize("epi", [
    Epilogue(residual=True),
    Epilogue(bias=True, activation="silu"),
    Epilogue(bias=True, activation="gelu", scale=0.5, residual=True),
    Epilogue(scale_vec=True, bias=True)],
    ids=["residual", "bias-silu", "bias-gelu-scale-residual", "scalevec"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_epilogue_matches_jax(epi, dtype):
    m, k, n = 33, 257, 65
    rng = np.random.default_rng(11)
    a, b = _operands("nn", m, k, n, rng)
    bias, res, scale = _np((n,), rng), _np((m, n), rng), _np((n,), rng)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    jbias, tbias = _pair(bias, dtype)
    jres, tres = _pair(res, dtype)
    jepi = JEpilogue(bias=epi.bias, activation=epi.activation,
                     residual=epi.residual, scale=epi.scale,
                     scale_vec=epi.scale_vec)
    pick = lambda flag, x: x if flag else None  # noqa: E731
    want = jops.gemm(ja, jb, interpret=True, epilogue=jepi,
                     bias=pick(epi.bias, jbias),
                     residual=pick(epi.residual, jres),
                     scale=pick(epi.scale_vec, jnp.asarray(scale)))
    got = tops.gemm(ta, tb, epilogue=epi, bias=pick(epi.bias, tbias),
                    residual=pick(epi.residual, tres),
                    scale=pick(epi.scale_vec, torch.as_tensor(scale)))
    _close(got, want, dtype)


@pytest.mark.parametrize("m,k,n", [(33, 257, 65), (4, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_swiglu_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m + n)
    x = _np((m, k), rng)
    wg, wu = _np((k, n), rng, k ** -0.5), _np((k, n), rng, k ** -0.5)
    (jx, tx), (jg, tg), (ju, tu) = (_pair(v, dtype) for v in (x, wg, wu))
    want = jops.gemm_swiglu(jx, jg, ju, interpret=True)
    _close(tops.gemm_swiglu(tx, tg, tu), want, dtype)


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("shared", ["none", "a", "b"])
def test_batched_gemm_matches_jax(trans, shared):
    g, m, k, n = 3, 17, 70, 40
    rng = np.random.default_rng(5)
    a, b = _operands(trans, m, k, n, rng)
    if shared != "a":
        a = _np((g,) + a.shape, rng)
    if shared != "b":
        b = _np((g,) + b.shape, rng)
    ja, ta = _pair(a, "float32")
    jb, tb = _pair(b, "float32")
    want = jops.batched_gemm(ja, jb, trans=trans, interpret=True)
    _close(tops.batched_gemm(ta, tb, trans=trans), want, "float32")


@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_gemm_bias_residual_matches_jax(per_group, dtype):
    g, m, k, n = 3, 17, 70, 40
    rng = np.random.default_rng(6)
    a, b = _np((g, m, k), rng), _np((g, k, n), rng)
    bias = _np((g, n) if per_group else (n,), rng)
    res = _np((g, m, n), rng)
    (ja, ta), (jb, tb), (jbias, tbias), (jres, tres) = (
        _pair(v, dtype) for v in (a, b, bias, res))
    want = jops.batched_gemm(ja, jb, interpret=True,
                             epilogue=JEpilogue(bias=True, residual=True),
                             bias=jbias, residual=jres)
    got = tops.batched_gemm(ta, tb, epilogue=Epilogue(bias=True,
                                                      residual=True),
                            bias=tbias, residual=tres)
    _close(got, want, dtype)


@pytest.mark.parametrize("epi", [
    Epilogue(), Epilogue(bias=True), Epilogue(activation="silu"),
    Epilogue(activation="gelu"), Epilogue(scale=0.25, residual=True),
    Epilogue(scale_vec=True, bias=True, activation="gelu", residual=True)],
    ids=["identity", "bias", "silu", "gelu", "scale-residual", "all"])
def test_epilogue_apply_matches_jax(epi):
    rng = np.random.default_rng(9)
    acc = _np((6, 10), rng, 3.0)
    bias, res, scale = _np((10,), rng), _np((6, 10), rng), _np((10,), rng)
    jepi = JEpilogue(bias=epi.bias, activation=epi.activation,
                     residual=epi.residual, scale=epi.scale,
                     scale_vec=epi.scale_vec)
    want = jepi.apply(jnp.asarray(acc), bias=jnp.asarray(bias),
                      residual=jnp.asarray(res), scale=jnp.asarray(scale))
    got = epi.apply(torch.as_tensor(acc), bias=torch.as_tensor(bias),
                    residual=torch.as_tensor(res),
                    scale=torch.as_tensor(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# The paper's irregular shapes (T1/T2/T3, from the JAX package's canonical
# list), regular ones, the decode and prefill shapes of qwen3-1.7b, and the
# boundary cases of the taxonomy.
CLASSIFY_SHAPES = [s[1:] for s in jshapes.PAPER_IRREGULAR_SHAPES] + [
    (1024, 32, 32), (32, 2048, 32), (512, 512, 32), (256, 256, 256),
    (100, 60, 96), (8, 128, 8), (33, 257, 65), (20480, 32, 96),
    (96, 20480, 96), (4096, 4096, 96), (4, 2048, 2048), (4, 2048, 6144),
    (4, 2048, 151936), (128, 2048, 6144), (4, 128, 1024), (1024, 129, 128),
    (128, 1024, 128), (512, 513, 129)]


@pytest.mark.parametrize("m,k,n", CLASSIFY_SHAPES)
def test_classify_matches_jax(m, k, n):
    assert (tshapes.classify(m, k, n).value
            == jshapes.classify(m, k, n).value)
    assert tshapes.is_irregular(m, k, n) == jshapes.is_irregular(m, k, n)


def test_paper_shape_list_matches_jax():
    assert tshapes.PAPER_IRREGULAR_SHAPES == jshapes.PAPER_IRREGULAR_SHAPES


def test_cuda_tensor_never_takes_the_plain_version():
    """The tensor's device picks the engine: only a CPU or ``meta`` tensor
    (the dry run's shapes) takes the plain version -- on ``meta`` it
    computes the kernel's result shape and dtype, and launches nothing;
    any other tensor goes to the kernel's operand check, which raises
    unless it lies on the card."""
    from repro_torch.kernels.ftimm import kernel as K
    assert K.PLAIN_DEVICES == ("cpu", "meta")
    meta = torch.empty((8, 8), device="meta")
    offs = torch.zeros(2, dtype=torch.int32, device="meta")
    K.reset_launch_counts()
    for call, shape in ((lambda: tops.gemm(meta, meta), (8, 8)),
                        (lambda: tops.gemm_swiglu(meta, meta, meta), (8, 8)),
                        (lambda: tops.batched_gemm(meta[None], meta),
                         (1, 8, 8)),
                        (lambda: tops.batched_gemm_swiglu(meta, meta[None],
                                                          meta[None]),
                         (1, 8, 8)),
                        (lambda: tops.ragged_gemm(meta, meta[None], offs),
                         (8, 8)),
                        (lambda: tops.ragged_gemm_swiglu(meta, meta[None],
                                                         meta[None], offs),
                         (8, 8))):
        out = call()
        assert out.device.type == "meta" and tuple(out.shape) == shape
    assert not any(K.launch_counts().values())
    with pytest.raises(ValueError, match="no kernel"):
        K._cuda_operands("ftimm_gemm", meta, meta, torch.float32)


# Ragged group-size distributions: 4 rows to 4 distinct groups (decode),
# all rows to one group, empty groups, a group spanning several 16-row
# tiles, and totals that are not a multiple of 16.
RAGGED_DISTS = [[1, 0, 1, 0, 1, 1], [0, 20, 0], [5, 0, 17, 3],
                [3, 40, 2], [1, 1, 1, 1, 1, 1, 1]]


def _offsets(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def _ragged_inputs(sizes, k, n, rng, trans="nn"):
    g, t = len(sizes), int(sum(sizes))
    w_shape = (g, k, n) if trans == "nn" else (g, n, k)
    return _np((t, k), rng), _np(w_shape, rng, k ** -0.5), _offsets(sizes)


@pytest.mark.parametrize("sizes", RAGGED_DISTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_gemm_matches_jax(sizes, dtype):
    rng = np.random.default_rng(sum(sizes))
    x, w, offs = _ragged_inputs(sizes, 40, 24, rng)
    (jx, tx), (jw, tw) = (_pair(v, dtype) for v in (x, w))
    want = jops.ragged_gemm(jx, jw, jnp.asarray(offs), bm=16, interpret=True)
    _close(tops.ragged_gemm(tx, tw, torch.as_tensor(offs)), want, dtype)


@pytest.mark.parametrize("sizes", RAGGED_DISTS[2:4])
def test_ragged_gemm_nt_matches_jax(sizes):
    rng = np.random.default_rng(7)
    x, w, offs = _ragged_inputs(sizes, 40, 24, rng, trans="nt")
    (jx, tx), (jw, tw) = (_pair(v, "float32") for v in (x, w))
    want = jops.ragged_gemm(jx, jw, jnp.asarray(offs), bm=16, trans="nt",
                            interpret=True)
    _close(tops.ragged_gemm(tx, tw, torch.as_tensor(offs), trans="nt"), want,
           "float32")


@pytest.mark.parametrize("epi", [Epilogue(bias=True),
                                 Epilogue(scale_vec=True, activation="silu"),
                                 Epilogue(bias=True, scale=0.5,
                                          activation="gelu")],
                         ids=["bias", "scalevec-silu", "bias-scale-gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_gemm_epilogue_matches_jax(epi, dtype):
    sizes = [5, 0, 17, 3]
    rng = np.random.default_rng(8)
    x, w, offs = _ragged_inputs(sizes, 40, 24, rng)
    vec = _np((len(sizes), 24), rng)
    (jx, tx), (jw, tw), (jv, tv) = (_pair(v, dtype) for v in (x, w, vec))
    jepi = JEpilogue(bias=epi.bias, activation=epi.activation,
                     scale=epi.scale, scale_vec=epi.scale_vec)
    pick = lambda flag, v: v if flag else None  # noqa: E731
    want = jops.ragged_gemm(jx, jw, jnp.asarray(offs), bm=16, interpret=True,
                            epilogue=jepi, bias=pick(epi.bias, jv),
                            scale=pick(epi.scale_vec, jnp.asarray(vec)))
    got = tops.ragged_gemm(tx, tw, torch.as_tensor(offs), epilogue=epi,
                           bias=pick(epi.bias, tv),
                           scale=pick(epi.scale_vec, torch.as_tensor(vec)))
    _close(got, want, dtype)


def test_ragged_rows_outside_every_group_are_zero():
    """offsets[G] < T: the trailing rows belong to no group and come out
    as zeros, as the reference oracle defines (the epilogue skips them)."""
    from repro.kernels.ftimm import ref as jref
    rng = np.random.default_rng(9)
    x, w, _ = _ragged_inputs([4, 6, 3], 40, 24, rng)
    offs = np.array([0, 4, 7, 9], np.int32)          # rows 9..12 unowned
    (jx, tx), (jw, tw) = (_pair(v, "float32") for v in (x, w))
    want = jref.ragged_matmul_ref(jx, jw, jnp.asarray(offs))
    got = tops.ragged_gemm(tx, tw, torch.as_tensor(offs))
    _close(got, want, "float32")
    bias = torch.as_tensor(_np((3, 24), rng))
    got = tops.ragged_gemm(tx, tw, torch.as_tensor(offs),
                           epilogue=Epilogue(bias=True), bias=bias)
    assert (got[9:] == 0).all() and (got[:9] != 0).any()


@pytest.mark.parametrize("sizes", RAGGED_DISTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_gemm_swiglu_matches_jax(sizes, dtype):
    rng = np.random.default_rng(sum(sizes) + 1)
    x, wg, offs = _ragged_inputs(sizes, 40, 24, rng)
    wu = _np(wg.shape, rng, 40 ** -0.5)
    (jx, tx), (jg, tg), (ju, tu) = (_pair(v, dtype) for v in (x, wg, wu))
    want = jops.ragged_gemm_swiglu(jx, jg, ju, jnp.asarray(offs), bm=16,
                                   interpret=True)
    _close(tops.ragged_gemm_swiglu(tx, tg, tu, torch.as_tensor(offs)), want,
           dtype)


def test_ragged_zero_rows():
    offs = torch.zeros(4, dtype=torch.int32)
    w = torch.randn(3, 8, 5)
    assert tops.ragged_gemm(torch.empty(0, 8), w, offs).shape == (0, 5)
    assert tops.ragged_gemm_swiglu(torch.empty(0, 8), w, w,
                                   offs).shape == (0, 5)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("g,m,k,n", [(4, 16, 64, 96), (3, 17, 70, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_gemm_swiglu_matches_jax(shared, g, m, k, n, dtype):
    rng = np.random.default_rng(g * m + n)
    x = _np((m, k) if shared else (g, m, k), rng)
    wg, wu = _np((g, k, n), rng, k ** -0.5), _np((g, k, n), rng, k ** -0.5)
    (jx, tx), (jg, tg), (ju, tu) = (_pair(v, dtype) for v in (x, wg, wu))
    want = jops.batched_gemm_swiglu(jx, jg, ju, interpret=True)
    _close(tops.batched_gemm_swiglu(tx, tg, tu), want, dtype)
