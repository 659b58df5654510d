"""The port's quantization against the JAX package, on the CPU.

The same numpy inputs go through ``repro.core.quant`` / the reference's
quantized GEMMs and their ports (``repro_torch.core.quant``, ``matmul`` /
``ragged_matmul`` with ``quant=``, ``moe_mlp(quant=)``, the quantized
``llama4-scout-17b-a16e`` smoke decoders and their engines), plus the dtype
axis of the plan store.

Tolerances: the quantizer is bitwise (the same fp32 divide, round half to
even, clip).  int8 x int8 is an exact integer sum on both sides (the
reference's Pallas kernel in int32, its XLA rung in fp32 while K * 127^2 <
2^24, the port's plain version in float64), then the same fp32 flush:
bitwise.  Mixed and fp8 products are fp32 sums of exact products in other
orders: 1e-5 of the output's max.  Models: 1e-4 in fp32, as the port's
other model tests."""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.gemm import matmul as jmatmul  # noqa: E402
from repro.core.gemm import ragged_matmul as jragged_matmul  # noqa: E402
from repro.kernels.ftimm import ops as jops  # noqa: E402
from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.gemm import (autotune, matmul, plan_store,  # noqa: E402
                                   ragged_matmul, tuner)
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.kernels.ftimm import ops as tops  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.weights import from_numpy_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

CPU = torch.device("cpu")
QUANT_MODES = ["w8", "w4", "int8", "fp8_e4m3", "fp8_e5m2"]
# The reference's three archetypes (tests/test_quant.py).
ARCHETYPES = [("t1", 2048, 64, 32), ("t2", 32, 2048, 32),
              ("t3", 512, 512, 64)]
FP_TOL = 1e-5


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol=FP_TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def _equal(got, want):
    np.testing.assert_array_equal(_f32(got), _f32(want))


# ---------------------------------------------------------------------------
# core.quant: bitwise the reference's
# ---------------------------------------------------------------------------

def test_quant_config_validation():
    with pytest.raises(ValueError, match="unknown quant mode"):
        quant.QuantConfig(mode="int3")
    assert quant.resolve(None).is_noop
    cfg = quant.resolve("w8")
    assert cfg.weight_only and cfg.weight_bytes == 1
    assert quant.resolve("w4").levels == quant.INT4_LEVELS
    assert not quant.resolve("int8").weight_only
    assert quant.resolve(cfg) is cfg
    assert quant.MODES == jquant.MODES


@pytest.mark.parametrize("mode", ["w8", "w4", "int8", "fp8_e4m3",
                                  "fp8_e5m2"])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("shape", [(24, 16), (3, 24, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weights_bitwise(mode, per_channel, shape, dtype):
    w = _np(shape, 4, 0.3)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.as_tensor(w).to(getattr(torch, dtype))
    jq, js = jquant.quantize_weights(jw, jquant.QuantConfig(mode, per_channel))
    tq, ts = quant.quantize_weights(tw, quant.QuantConfig(mode, per_channel))
    assert tq.dtype == {"fp8_e4m3": torch.float8_e4m3fn,
                        "fp8_e5m2": torch.float8_e5m2}.get(mode, torch.int8)
    assert tuple(ts.shape) == (*shape[:-2], shape[-1])
    _equal(tq, jq)
    _equal(ts, js)


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bitwise(mode, dtype):
    x = _np((32, 16), 6, 3.0)
    jq, js = jquant.quantize_activations(jnp.asarray(x, getattr(jnp, dtype)),
                                         jquant.QuantConfig(mode))
    tq, ts = quant.quantize_activations(
        torch.as_tensor(x).to(getattr(torch, dtype)), quant.QuantConfig(mode))
    _equal(tq, jq)
    _equal(ts, js)


def test_scale_quantize_dequantize_residual_bitwise():
    x = _np((40, 12), 7)
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    for levels in (quant.INT8_LEVELS, quant.INT4_LEVELS):
        js = jquant.symmetric_scale(jx, levels, axis=0)
        ts = quant.symmetric_scale(tx, levels, dim=0)
        _equal(ts, js)
        jq, tq = jquant.quantize(jx, js, levels), quant.quantize(tx, ts, levels)
        _equal(tq, jq)
        _equal(quant.dequantize(tq, ts), jquant.dequantize(jq, js))
        _equal(quant.error_residual(tx, tq, ts),
               jquant.error_residual(jx, jq, js))
    _equal(quant.scale_from_absmax(torch.tensor(0.0)),
           jquant.scale_from_absmax(jnp.float32(0.0)))


def test_pack_int4_bitwise_and_roundtrip():
    q = np.random.default_rng(3).integers(-7, 8, (5, 16)).astype(np.int8)
    packed = quant.pack_int4(torch.as_tensor(q))
    assert tuple(packed.shape) == (5, 8) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jquant.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4(torch.as_tensor(q[:, :15]))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_cast_bitwise_and_within_step(fmt):
    x = _np((32, 16), 6, 3.0)
    tq, ts = quant.quantize_fp8(torch.as_tensor(x), fmt)
    jq, js = jquant.quantize_fp8(jnp.asarray(x), fmt)
    _equal(tq, jq)
    _equal(ts, js)
    amax = float(np.abs(x).max())
    err = np.abs(_f32(tq) * float(ts) - x).max()
    assert err <= quant.fp8_step(amax, fmt)
    # At the tensor's own amax the scaled value is the format's finite max
    # on both sides (in range, where the two casts agree).
    fmax = quant.FP8_FORMATS[fmt][1]
    i = np.unravel_index(np.abs(x).argmax(), x.shape)
    assert abs(_f32(tq)[i]) == fmax == abs(_f32(jq)[i])


def test_fp8_out_of_range_cast_differs_and_is_never_made():
    """torch saturates an out-of-range e4m3 cast to 448, ml_dtypes gives
    NaN; quantize_fp8 scales into range, so its values never meet it."""
    vals = np.array([470.0, 480.0, -500.0, 1e6], np.float32)
    t = torch.as_tensor(vals).to(torch.float8_e4m3fn).float().numpy()
    j = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)
                   .astype(jnp.float32))
    assert np.all(np.abs(t) == 448.0) and np.all(np.isnan(j))
    inside = np.linspace(-448, 448, 1001).astype(np.float32)
    _equal(torch.as_tensor(inside).to(torch.float8_e4m3fn),
           jnp.asarray(inside).astype(jnp.float8_e4m3fn))
    tq, _ = quant.quantize_fp8(torch.as_tensor(vals), "e4m3")
    assert np.isfinite(_f32(tq)).all() and np.abs(_f32(tq)).max() == 448.0


def test_dot_error_bound_and_fp8_step_match():
    for args in ((128, 1.0, 1.0, 0.0, 0.01), (256, 1.0, 2.0, 0.1, 0.1)):
        assert quant.dot_error_bound(*args) == jquant.dot_error_bound(*args)
    for fmt in ("e4m3", "e5m2"):
        assert quant.fp8_step(3.0, fmt) == jquant.fp8_step(3.0, fmt)


# ---------------------------------------------------------------------------
# matmul(quant=): the analytic bound, and the reference's engines
# ---------------------------------------------------------------------------

def _bound(mode, a, b) -> float:
    k = a.shape[1]
    amax_a, amax_b = float(np.abs(a).max()), float(np.abs(b).max())
    cfg = quant.QuantConfig(mode)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    if mode in ("w8", "w4"):
        _, s = quant.quantize_weights(tb, cfg)
        return quant.dot_error_bound(k, amax_a, amax_b, 0.0, float(s.max()))
    if mode == "int8":
        _, sw = quant.quantize_weights(tb, cfg)
        return quant.dot_error_bound(k, amax_a, amax_b,
                                     float(quant.symmetric_scale(ta)),
                                     float(sw.max()))
    fmt = mode[4:]
    return quant.dot_error_bound(k, amax_a, amax_b,
                                 quant.fp8_step(amax_a, fmt),
                                 quant.fp8_step(amax_b, fmt))


@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("name,m,k,n", ARCHETYPES)
def test_quantized_matmul_within_bound(name, m, k, n, mode):
    a, b = _np((m, k), 10, 0.5), _np((k, n), 11, 0.3)
    got = matmul(torch.as_tensor(a), torch.as_tensor(b), quant=mode,
                 out_dtype=torch.float32).numpy()
    err = float(np.abs(got - a.astype(np.float64) @ b).max())
    bound = _bound(mode, a, b)
    assert 0.0 < err <= bound, (name, mode, err, bound)


@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("name,m,k,n", [ARCHETYPES[0], ARCHETYPES[2]])
def test_quantized_matmul_matches_jax_xla(name, m, k, n, mode):
    """K <= 1024, where the reference's XLA rung sums int8 exactly."""
    a, b = _np((m, k), 12, 0.5), _np((k, n), 13, 0.3)
    want = jmatmul(jnp.asarray(a), jnp.asarray(b), quant=mode,
                   out_dtype=jnp.float32, backend="xla")
    got = matmul(torch.as_tensor(a), torch.as_tensor(b), quant=mode,
                 out_dtype=torch.float32)
    if mode == "int8":
        _equal(got, want)
    else:
        _close(got, want)


@pytest.mark.parametrize("mode", ["w8", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_matches_jax_interpret(mode, dtype):
    """Against the reference's Pallas kernel in interpret mode; int8 at
    fp32 out bitwise (an exact int32 sum, the same fp32 flush)."""
    a, b = _np((48, 40), 12, 0.5), _np((40, 24), 13, 0.3)
    out = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jmatmul(jnp.asarray(a, getattr(jnp, dtype)),
                   jnp.asarray(b, getattr(jnp, dtype)), quant=mode,
                   out_dtype=out, backend="pallas_interpret")
    got = matmul(torch.as_tensor(a).to(getattr(torch, dtype)),
                 torch.as_tensor(b).to(getattr(torch, dtype)), quant=mode,
                 out_dtype=getattr(torch, dtype))
    if mode == "int8" and dtype == "float32":
        _equal(got, want)
    else:
        _close(got, want, FP_TOL if dtype == "float32" else 2e-2)


def test_quantized_matmul_with_a_tail_matches_jax():
    """The caller's epilogue after the dequant: bias, silu, residual."""
    a, b = _np((20, 48), 14, 0.5), _np((48, 24), 15, 0.3)
    bias, res = _np((24,), 16), _np((20, 24), 17)
    epi = dict(bias=True, activation="silu", residual=True)
    for mode in ("w8", "int8", "fp8_e4m3"):
        want = jmatmul(jnp.asarray(a), jnp.asarray(b), quant=mode,
                       epilogue=JEpilogue(**epi), bias=jnp.asarray(bias),
                       residual=jnp.asarray(res), backend="xla")
        got = matmul(torch.as_tensor(a), torch.as_tensor(b), quant=mode,
                     epilogue=Epilogue(**epi), bias=torch.as_tensor(bias),
                     residual=torch.as_tensor(res))
        _close(got, want)


def test_quant_rejects_bad_spellings():
    a, b = torch.as_tensor(_np((16, 8), 0)), torch.as_tensor(_np((8, 16), 1))
    with pytest.raises(ValueError, match="trans='nn'"):
        matmul(a, b.T, trans="nt", quant="w8")
    with pytest.raises(ValueError, match="dequant scale"):
        matmul(a, b, quant="w8", epilogue=Epilogue(scale_vec=True),
               scale=torch.ones(16))
    x, w, offs = _ragged(rows=(5, 0, 7))
    with pytest.raises(ValueError, match="does not take a bias"):
        ragged_matmul(torch.as_tensor(x), torch.as_tensor(w),
                      torch.as_tensor(offs), quant="w8",
                      bias=torch.ones(w.shape[0], w.shape[2]))


# ---------------------------------------------------------------------------
# The kernel wrappers take the new type codes (plain versions on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [("int8", "int8"), ("float32", "int8"),
                                  ("bfloat16", "int8"),
                                  ("float8_e4m3fn", "float8_e4m3fn"),
                                  ("float8_e5m2", "float8_e5m2")])
def test_gemm_wrapper_quantized_pairs_match_jax_interpret(pair):
    a, b = _np((33, 70), 20, 0.5), _np((70, 40), 21, 0.3)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    cast = {"int8": lambda t: quant.quantize(t, quant.symmetric_scale(t)),
            "float32": lambda t: t, "bfloat16": lambda t: t.bfloat16(),
            "float8_e4m3fn": lambda t: quant.quantize_fp8(t, "e4m3")[0],
            "float8_e5m2": lambda t: quant.quantize_fp8(t, "e5m2")[0]}
    qa, qb = cast[pair[0]](ta), cast[pair[1]](tb)
    sv = torch.as_tensor(_np((40,), 22)).abs()
    jnp_of = {torch.int8: jnp.int8, torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16,
              torch.float8_e4m3fn: jnp.float8_e4m3fn,
              torch.float8_e5m2: jnp.float8_e5m2}
    ja, jb = (jnp.asarray(_f32(t)).astype(jnp_of[t.dtype]) for t in (qa, qb))
    want = jops.gemm(ja, jb, out_dtype=jnp.float32, interpret=True,
                     epilogue=JEpilogue(scale_vec=True),
                     scale=jnp.asarray(sv.numpy()))
    got = tops.gemm(qa, qb, out_dtype=torch.float32,
                    epilogue=Epilogue(scale_vec=True), scale=sv)
    if pair == ("int8", "int8"):
        _equal(got, want)
    else:
        _close(got, want)


def test_quantized_codes_and_bodies():
    """The rules the card follows: 1-byte pairs take the FMA body only and
    the quantized tile menu; the codes of the kernels that do not take
    them are absent."""
    i8, e4 = torch.int8, torch.float8_e4m3fn
    for a_b, b_b in ((1, 1), (2, 1), (4, 1)):
        assert K.gemm_bodies(a_b, b_b, 4, True, True) == ("fma",)
        assert K.ragged_bodies(a_b, b_b, 4, True, True) == ("fma",)
        assert K.fma_tiles(a_b, b_b) == K.QUANT_TILES
    assert K.fma_tiles(2, 2) == K.TILES
    plan = tuner.plan_gemm(4, 5120, 8192, 2, 2, b_bytes=1)
    assert plan.body == "fma" and (plan.bm, plan.bn, plan.bk) in K.QUANT_TILES
    plan = tuner.plan_ragged_gemm(16, 128, 5120, 8192, 1, 4, b_bytes=1)
    assert plan.body == "fma" and (plan.bm, plan.bn, plan.bk) in K.QUANT_TILES
    assert K._TYPE_CODES[(i8, i8, torch.float32)] in K._QUANT["ftimm_gemm"]
    assert (K._TYPE_CODES[(torch.bfloat16, e4, torch.float32)]
            not in K._QUANT["ftimm_gemm_ragged"])
    with pytest.raises(ValueError, match="not a compiled tile"):
        K.tile_id(128, 128, 16, K.QUANT_TILES)


# ---------------------------------------------------------------------------
# Straight-through gradients against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("tail", [False, True])
def test_quant_grads_match_jax(mode, tail):
    a, b = _np((24, 40), 30, 0.5), _np((40, 32), 31, 0.3)
    bias, res, cot = _np((32,), 32), _np((24, 32), 33), _np((24, 32), 34)
    epi = dict(bias=True, activation="silu", residual=True) if tail else {}

    def jloss(a_, b_, bias_, res_):
        y = jmatmul(a_, b_, quant=mode, out_dtype=jnp.float32,
                    backend="xla",
                    **(dict(epilogue=JEpilogue(**epi), bias=bias_,
                            residual=res_) if tail else {}))
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (a, b, bias, res)))
    ts = [torch.as_tensor(v).requires_grad_() for v in (a, b, bias, res)]
    y = matmul(ts[0], ts[1], quant=mode, out_dtype=torch.float32,
               **(dict(epilogue=Epilogue(**epi), bias=ts[2], residual=ts[3])
                  if tail else {}))
    (y * torch.as_tensor(cot)).sum().backward()
    for t, w in zip(ts[:4] if tail else ts[:2], want):
        _close(t.grad, w)


def _ragged(rows=(10, 0, 6, 4), k=32, n=24, tail=0, seed=40):
    offs = np.concatenate([[0], np.cumsum(rows)]).astype(np.int32)
    t = int(offs[-1]) + tail
    return (_np((t, k), seed, 0.5), _np((len(rows), k, n), seed + 1, 0.3),
            offs)


@pytest.mark.parametrize("mode", ["w8", "w4", "int8", "fp8_e4m3"])
def test_ragged_quant_grads_match_jax(mode):
    x, w, offs = _ragged()
    cot = _np((x.shape[0], w.shape[2]), 42)

    def jloss(x_, w_):
        y = jragged_matmul(x_, w_, jnp.asarray(offs), quant=mode,
                           out_dtype=jnp.float32, backend="xla")
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.as_tensor(v).requires_grad_() for v in (x, w))
    y = ragged_matmul(tx, tw, torch.as_tensor(offs), quant=mode,
                      out_dtype=torch.float32)
    (y * torch.as_tensor(cot)).sum().backward()
    _close(tx.grad, want[0])
    _close(tw.grad, want[1])


# ---------------------------------------------------------------------------
# The quantized ragged GEMM against the reference's kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("rows,tail", [((10, 0, 6, 4), 0), ((3, 0, 17), 5),
                                       ((0, 0, 9, 0), 2)])
def test_ragged_quant_matches_jax_interpret(mode, rows, tail):
    """An empty group and rows outside every group (zeros on both sides),
    against the reference's ragged kernel in interpret mode (bm 16) on
    the operands quantized by the reference; int8 bitwise."""
    x, w, offs = _ragged(rows, tail=tail, seed=50 + tail)
    cfg = jquant.QuantConfig(mode)
    jw, js = jquant.quantize_weights(jnp.asarray(w), cfg)
    if mode == "w4":
        jw = jquant.unpack_int4(jquant.pack_int4(jw))
    jx, sv = jnp.asarray(x), js
    if not cfg.weight_only:
        jx, sa = jquant.quantize_activations(jx, cfg)
        sv = js * sa
    want = jops.ragged_gemm(jx, jw, jnp.asarray(offs), bm=16, interpret=True,
                            out_dtype=jnp.float32,
                            epilogue=JEpilogue(scale_vec=True), scale=sv)
    got = ragged_matmul(torch.as_tensor(x), torch.as_tensor(w),
                        torch.as_tensor(offs), quant=mode,
                        out_dtype=torch.float32)
    assert not _f32(got)[int(offs[-1]):].any()
    if mode == "int8":
        _equal(got, want)
    else:
        _close(got, want)


# ---------------------------------------------------------------------------
# moe_mlp(quant=) and the quantized decoders against the reference
# ---------------------------------------------------------------------------

def _moe_params(d, f, e, seed):
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e)
    tp = tmoe.MoEParams(*(torch.as_tensor(np.array(p[n])) for n in (
        "router", "w_gate", "w_up", "w_down")))
    return p, tp


@pytest.mark.parametrize("mode", ["w8", "w4", "int8"])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 1)])
def test_moe_quant_matches_jax_and_keeps_routing(mode, e, k):
    d, f = 32, 64
    p, tp = _moe_params(d, f, e, 3)
    x = _np((24, d), 60, 0.5)
    kw = dict(num_experts=e, top_k=k, dispatch="ragged")
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x), p, compute_dtype=jnp.float32,
                            quant=mode, **kw)
    ty, taux = tmoe.moe_mlp(torch.as_tensor(x), tp,
                            compute_dtype=torch.float32, quant=mode, **kw)
    _, taux0 = tmoe.moe_mlp(torch.as_tensor(x), tp,
                            compute_dtype=torch.float32, **kw)
    # The router is never quantized: the same routing and aux loss as the
    # unquantized layer, bit for bit, and the reference's routing.
    assert float(taux) == float(taux0)
    _, tidx, _ = tmoe._router(torch.as_tensor(x), tp.router, e, k)
    _, jidx, _ = jmoe._router(jnp.asarray(x), p, e, k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert abs(float(taux) - float(jaux)) < 1e-5
    _close(ty, jy, 1e-4)


def _quant_models(arch):
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    assert jcfg.quant == tcfg.quant != "none"
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(1))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, CPU)
    return jcfg, params, tcfg, model


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e-w8-smoke",
                                  "llama4-scout-17b-a16e-w4-smoke",
                                  "llama4-scout-17b-a16e-int8-smoke"])
def test_quantized_llama4_decoder_matches_jax(arch):
    """Prefill and three decode steps past the 16-position chunk: logits
    within 1e-4 and the same greedy ids."""
    jcfg, params, tcfg, model = _quant_models(arch)
    toks = np.random.default_rng(2).integers(2, 512, (2, 14)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, 2, 24))
    tl, tc = tmodel.prefill(model, tcfg,
                            {"tokens": torch.as_tensor(toks, dtype=torch.long)},
                            tmodel.make_cache(tcfg, 2, 24, device=CPU))
    assert _rel(tl, jl) <= 1e-4
    assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()
    jdec = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
    nxt = np.array(jl.argmax(-1), np.int32).reshape(2, 1)
    pos = np.array([14, 14], np.int32)
    for step in range(3):
        jl, jc = jdec(params, tokens=jnp.asarray(nxt), cache=jc,
                      pos=jnp.asarray(pos))
        tl, tc = tmodel.decode_step(model, tcfg,
                                    torch.as_tensor(nxt, dtype=torch.long),
                                    tc, torch.as_tensor(pos,
                                                        dtype=torch.long))
        assert _rel(tl, jl) <= 1e-4, step
        assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()
        nxt = np.array(jl.argmax(-1), np.int32).reshape(2, 1)
        pos = pos + 1


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e-w8-smoke",
                                  "llama4-scout-17b-a16e-w4-smoke",
                                  "llama4-scout-17b-a16e-int8-smoke"])
def test_quantized_llama4_engine_matches_jax(arch):
    """Both engines, 2 slots, 3 requests, 4 new tokens: the same greedy
    tokens and terminal flags (int8's per-tensor activation scale spans
    the idle slots' rows on both sides)."""
    jcfg, params, tcfg, model = _quant_models(arch)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, 512, n).astype(np.int32) for n in (18, 5, 11)]
    jreqs = JServeEngine(jcfg, params, batch_slots=2, max_len=32).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    treqs = ServeEngine(tcfg, model, batch_slots=2, max_len=32,
                        device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens,
                                              j.out_tokens)
        assert (t.done, t.timed_out, t.shed) == (j.done, j.timed_out, j.shed)
        assert t.done and len(t.out_tokens) == 4


def test_dense_family_ignores_quant():
    """As in the reference: qwen3-1.7b-w8 computes what qwen3-1.7b does."""
    base = dataclasses.replace(get_config("qwen3-1.7b-smoke"),
                               compute_dtype="float32")
    w8 = dataclasses.replace(get_config("qwen3-1.7b-w8-smoke"),
                             compute_dtype="float32")
    assert w8.quant == "w8" and dataclasses.replace(w8, quant="none") == base
    model = tmodel.init_params(base, 0, device="cpu")
    toks = {"tokens": torch.as_tensor(
        np.random.default_rng(3).integers(2, 512, (2, 9)), dtype=torch.long)}
    out = [tmodel.prefill(model, cfg, toks,
                          tmodel.make_cache(cfg, 2, 12, device=CPU))[0]
           for cfg in (base, w8)]
    assert torch.equal(out[0], out[1])


def test_registry_quant_suffixes_both_orders():
    for name in ("llama4-scout-17b-a16e-w8-smoke",
                 "llama4-scout-17b-a16e-smoke-w8"):
        cfg = get_config(name)
        assert cfg.quant == "w8" and cfg.moe_dispatch == "ragged"
        assert cfg == dataclasses.replace(
            get_config("llama4-scout-17b-a16e-smoke"), quant="w8")
        assert cfg.quant == jget_config(name).quant
    assert get_config("qwen3-1.7b-int8").quant == "int8"
    assert get_config("qwen3-1.7b").quant == "none"


# ---------------------------------------------------------------------------
# The plan store's dtype axis (the reference's tests/test_quant.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def clean_plans(monkeypatch):
    monkeypatch.delenv(plan_store.ENV_VAR, raising=False)
    tuner.clear_plan_cache()
    yield
    tuner.clear_plan_cache()


def test_dtype_keyed_plan_roundtrip(tmp_path, clean_plans):
    kw = dict(top_k=2, repeats=1, device="cpu", max_elements=1 << 16)
    r = autotune.autotune_gemm(4096, 256, 64, 2, 2, b_bytes=1, **kw)
    assert r.plan.mode == "measured"
    assert r.in_bytes == 2 and r.b_bytes == 1
    served = tuner.plan_gemm(4096, 256, 64, 2, 2, b_bytes=1)
    assert served.mode == "cached"
    # The homogeneous key is another signature: the mixed-width winner
    # does not leak into wide planning.
    assert tuner.plan_gemm(4096, 256, 64, 2, 2).mode == "analytic"
    path = tmp_path / "plans.json"
    autotune.save_plan_cache(str(path))
    blob = json.load(open(path))
    assert any(key.endswith("|bb1") for key in blob["entries"])
    autotune.clear_plan_store()
    assert tuner.plan_gemm(4096, 256, 64, 2, 2, b_bytes=1).mode == "analytic"
    assert autotune.load_plan_cache(str(path)) >= 1
    again = tuner.plan_gemm(4096, 256, 64, 2, 2, b_bytes=1)
    assert again.mode == "cached"
    assert (again.bm, again.bn, again.bk) == (r.plan.bm, r.plan.bn, r.plan.bk)


def test_int8_key_and_calibration_fraction(clean_plans):
    kw = dict(top_k=2, repeats=1, device="cpu", max_elements=1 << 16)
    wide = autotune.autotune_gemm(4096, 256, 64, 4, 4, **kw)
    narrow = autotune.autotune_gemm(4096, 256, 64, 1, 4, **kw)
    assert narrow.in_bytes == 1 and narrow.b_bytes is None
    assert narrow.key.split("|")[2] == "ib1"
    cal = autotune.calibrate([wide, narrow], store=False)
    assert cal.flops_frac_int8 is not None and cal.flops_frac_int8 > 0
    back = plan_store.Calibration.from_json(cal.to_json())
    assert back.flops_frac_int8 == pytest.approx(cal.flops_frac_int8)
    # The narrow fraction scales only the 1-byte rate.
    spec = tuner.H100.calibrated(cal.flops_frac, cal.bw_frac,
                                 cal.flops_frac_int8)
    assert spec.peak_ops_int32 == pytest.approx(
        tuner.H100.peak_ops_int32 * cal.flops_frac_int8)
    only = autotune.calibrate([narrow], store=False)
    assert only.flops_frac_int8 is not None


def test_mixed_dtype_splitk_record_quarantined(tmp_path, clean_plans):
    key = "dense|4096x4096x128|ib2|ob2|bb1"
    good = {"bm": 64, "bn": 64, "bk": 32}
    assert plan_store.record_violations(key, good) == []
    bad = dict(good, nsplit=2)
    assert plan_store.record_violations(key, bad) == ["splitk_mixed_dtype"]
    assert "splitk_mixed_dtype" in plan_store.record_violations(
        "dense|4096x4096x128|ib1|ob4", bad)
    # A 1-byte record names a tile the quantized codes are not built for.
    assert plan_store.record_violations(
        key, {"bm": 128, "bn": 128, "bk": 16}) == ["tile_not_compiled"]
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({
        "schema": plan_store.SCHEMA_VERSION,
        "device_kind": plan_store.device_kind("cpu"),
        "entries": {key: bad}}))
    st = plan_store.PlanStore()
    assert st.load(str(path)) == 0
    assert st.quarantined[key] == ["splitk_mixed_dtype"]


def test_fp8_priced_at_the_fp32_rate_and_keyed_apart(clean_plans):
    """fp8 x fp8 runs the FMA body's fp32 FMAs, int8 x int8 its integer
    multiply-adds: each is priced at its own rate, and a record the tuner
    measured on int8 operands does not plan an fp8 call."""
    from repro_torch.core.gemm import cmr, dispatch
    spec = tuner.H100
    assert spec.kernel_flops("fma", 1) == spec.peak_ops_int32
    assert spec.kernel_flops("fma", 1, fp8=True) == spec.peak_flops_fp32
    assert spec.kernel_flops("fma", 2, fp8=True) == spec.peak_flops_fp32
    tile = dict(bm=64, bn=64, bk=32)
    i8 = cmr.estimate(4096, 4096, 4096, in_bytes=1, **tile)
    f8 = cmr.estimate(4096, 4096, 4096, in_bytes=1, fp8=True, **tile)
    assert i8.t_compute == pytest.approx(2 * f8.t_compute)
    r8 = cmr.estimate_ragged(16, 256, 4096, 4096, in_bytes=1, **tile)
    rf = cmr.estimate_ragged(16, 256, 4096, 4096, in_bytes=1, fp8=True,
                             **tile)
    assert r8.t_compute == pytest.approx(2 * rf.t_compute)
    e4, i8t = torch.zeros(2, 2, dtype=torch.float8_e4m3fn), torch.zeros(
        2, 2, dtype=torch.int8)
    assert dispatch._fp8(e4, e4)
    assert not dispatch._fp8(i8t, i8t)
    assert not dispatch._fp8(e4.to(torch.bfloat16), e4)
    assert tuner.dense_key(4096, 256, 64, 1, 4, fp8=True).endswith("|fp8")
    kw = dict(top_k=2, repeats=1, device="cpu", max_elements=1 << 16)
    autotune.autotune_gemm(4096, 256, 64, 1, 4, **kw)
    assert tuner.plan_gemm(4096, 256, 64, 1, 4).mode == "cached"
    assert tuner.plan_gemm(4096, 256, 64, 1, 4, fp8=True).mode == "analytic"
