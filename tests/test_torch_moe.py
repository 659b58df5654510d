"""The port's MoE layer and MoE decoders against the JAX package, on the CPU.

The same numpy inputs and weights go through ``repro.models.moe`` /
``repro.models.model`` and their ports: the capacity rule, the router, both
dispatch modes of ``moe_mlp`` (routing, drops and outputs), and the
``mixtral-8x7b-smoke`` (capacity, sliding window 16) and
``llama4-scout-17b-a16e-smoke`` (ragged, chunked 16, with a global layer at
4 layers) decoders through ``prefill``, ``prefill_bucket`` and dense and
paged ``decode_step`` past position 16, where the windows bite.

Parity is held in fp32 (1e-4: the same fp32 arithmetic summed in other
orders): in bf16 one rounding can move a near-tied token to another expert,
which is a different routing, not a numerical error."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.weights import from_numpy_params  # noqa: E402
from repro_torch.serve.kv_pages import PagedKV  # noqa: E402

CPU = torch.device("cpu")
MIXTRAL, LLAMA4 = "mixtral-8x7b-smoke", "llama4-scout-17b-a16e-smoke"


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("t", [1, 4, 37, 256])
@pytest.mark.parametrize("e,k", [(8, 2), (16, 1), (4, 2)])
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_jax(t, e, k, factor):
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
                   (jnp.int8, torch.int8)):
        assert (tmoe.capacity(t, e, k, factor, dtype=td)
                == jmoe.capacity(t, e, k, factor, dtype=jd))


def test_capacity_at_the_serving_shapes():
    """mixtral at 4 slots in bf16: decode C = 16, 4 x 64 bucket C = 80."""
    assert tmoe.capacity(4, 8, 2, 1.25, dtype=torch.bfloat16) == 16
    assert tmoe.capacity(256, 8, 2, 1.25, dtype=torch.bfloat16) == 80


def _moe_params(d, f, e, seed):
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e)
    tp = tmoe.MoEParams(*(torch.as_tensor(np.array(p[n])) for n in (
        "router", "w_gate", "w_up", "w_down")))
    return p, tp


@pytest.mark.parametrize("e,k", [(4, 2), (8, 1)])
def test_router_matches_jax(e, k):
    p, tp = _moe_params(32, 48, e, 0)
    x = np.random.default_rng(1).standard_normal((19, 32)).astype(np.float32)
    jw, ji, jaux = jmoe._router(jnp.asarray(x), p, e, k)
    tw, ti, taux = tmoe._router(torch.as_tensor(x), tp.router, e, k)
    assert (ti.numpy() == np.asarray(ji)).all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    assert abs(float(taux) - float(jaux)) < 1e-5


@pytest.mark.parametrize("dispatch,e,k,factor", [
    ("capacity", 4, 2, 1.25), ("capacity", 4, 2, 0.5), ("capacity", 8, 1, 1.0),
    ("ragged", 4, 2, 1.25), ("ragged", 16, 1, 1.25)])
def test_moe_mlp_matches_jax(dispatch, e, k, factor):
    t, d, f = 37, 32, 48
    p, tp = _moe_params(d, f, e, 2)
    x = np.random.default_rng(3).standard_normal((t, d)).astype(np.float32)
    jy, jaux = jmoe.moe_mlp(jnp.asarray(x), p, num_experts=e, top_k=k,
                            capacity_factor=factor,
                            compute_dtype=jnp.float32, dispatch=dispatch)
    ty, taux = tmoe.moe_mlp(torch.as_tensor(x), tp, num_experts=e, top_k=k,
                            capacity_factor=factor,
                            compute_dtype=torch.float32, dispatch=dispatch)
    assert _rel_err(ty.numpy(), jy) <= 1e-4
    assert abs(float(taux) - float(jaux)) < 1e-5
    if dispatch == "capacity" and factor < 1:
        # The tight capacity drops copies, and the outputs agree only if
        # both sides drop the same ones: check that the case has drops.
        _, idx, _ = tmoe._router(torch.as_tensor(x), tp.router, e, k)
        per_expert = np.bincount(idx.numpy().ravel(), minlength=e)
        assert per_expert.max() > tmoe.capacity(t, e, k, factor)


def test_moe_mlp_rejects_quantized_experts():
    # As in the reference: quantized experts run with ragged dispatch only
    # (the ragged path's parity with the reference: test_torch_quant.py).
    _, tp = _moe_params(32, 48, 4, 0)
    with pytest.raises(ValueError, match="ragged"):
        tmoe.moe_mlp(torch.zeros(3, 32), tp, num_experts=4, top_k=2,
                     dispatch="capacity", quant="w8")


def _configs(arch, layers=None):
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(arch, layers=None):
    jcfg, tcfg = _configs(arch, layers)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, CPU)
    return jcfg, params, tcfg, model


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(2, 512, shape).astype(np.int32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


MODELS = [(MIXTRAL, None), (LLAMA4, None), (LLAMA4, 4)]
IDS = ["mixtral", "llama4", "llama4-4l"]


@pytest.mark.parametrize("arch,layers", MODELS, ids=IDS)
def test_moe_prefill_and_decode_match_jax(arch, layers):
    """A 20-token prefill, then three decode steps at per-slot depths past
    the 16-position window, dense and paged, fed the JAX greedy tokens."""
    jcfg, params, tcfg, model = _models(arch, layers)
    assert tcfg.family == "moe" and len(model.layers) == tcfg.num_layers
    toks = _tokens((2, 20), 1)
    jl, jc = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, 2, 24))
    tl, tc = tmodel.prefill(model, tcfg, {"tokens": _t(toks)},
                            tmodel.make_cache(tcfg, 2, 24, device=CPU))
    assert _rel_err(tl.numpy(), jl) <= 1e-4
    assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()

    page = 4
    kv = PagedKV.build(tcfg, slots=2, max_len=24, num_pages=13,
                       page_size=page, device=CPU)
    for slot in range(2):
        kv.insert(slot, list(range(1 + 6 * slot, 7 + 6 * slot)),
                  tc["k"][:, slot, :20], tc["v"][:, slot, :20])
    jdec = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
    nxt = np.asarray(jl.argmax(-1), np.int32)[:, None]
    pos = np.array([20, 20], np.int32)
    for step in range(3):
        jl, jc = jdec(params, tokens=jnp.asarray(nxt), cache=jc,
                      pos=jnp.asarray(pos))
        tpos = torch.as_tensor(pos, dtype=torch.long)
        tl, tc = tmodel.decode_step(model, tcfg, _t(nxt), tc, tpos)
        pl, _ = tmodel.decode_step(model, tcfg, _t(nxt), kv.cache(), tpos,
                                   page_table=kv.device_table())
        assert _rel_err(tl.numpy(), jl) <= 1e-4, step
        assert _rel_err(pl.numpy(), jl) <= 1e-4, step
        want = np.asarray(jl.argmax(-1))
        assert (tl.argmax(-1).numpy() == want).all(), step
        assert (pl.argmax(-1).numpy() == want).all(), step
        nxt = want.astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch,layers", MODELS, ids=IDS)
def test_moe_prefill_bucket_matches_jax(arch, layers):
    """Right-padded prompts in one 24-row bucket: the padding is routed
    and, in capacity mode, takes capacity -- on both sides alike."""
    jcfg, params, tcfg, model = _models(arch, layers)
    lens = np.array([22, 7, 17], np.int32)
    toks = np.zeros((3, 24), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _tokens((n,), 10 + i)
    jl, _ = jax.jit(functools.partial(jmodel.prefill_bucket, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, 3, 24), lens=jnp.asarray(lens))
    tl, _ = tmodel.prefill_bucket(model, tcfg, {"tokens": _t(toks)},
                                  tmodel.make_cache(tcfg, 3, 24, device=CPU),
                                  torch.as_tensor(lens))
    assert _rel_err(tl.numpy(), jl) <= 1e-4
    assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()


def test_moe_init_params_shapes():
    cfg = get_config(MIXTRAL)
    model = tmodel.init_params(cfg, 0, device="cpu")
    moe = model.layers[0].moe
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert model.layers[0].mlp is None
    assert moe.router.shape == (d, e) and moe.w_down.shape == (e, f, d)
    assert moe.w_gate.shape == moe.w_up.shape == (e, d, f)
    assert moe.w_gate.dtype == torch.bfloat16
    assert abs(moe.w_gate.float().std().item() - (2.0 / d) ** 0.5) < 0.01


def test_quantized_variants_still_raise():
    # The quantized variants resolve now, as in the reference; the capacity
    # model's still raises, in its forward pass (as the reference's does).
    for name, mode in (("mixtral-8x7b-w8", "w8"),
                       ("llama4-scout-17b-a16e-w8-smoke", "w8"),
                       ("llama4-scout-17b-a16e-smoke-int8", "int8"),
                       ("mixtral-8x7b-w4", "w4")):
        assert get_config(name).quant == mode
    cfg = get_config("mixtral-8x7b-smoke-w8")
    _, tp = _moe_params(cfg.d_model, cfg.d_ff, cfg.num_experts, 0)
    with pytest.raises(ValueError, match="ragged"):
        tmoe.moe_mlp(torch.zeros(3, cfg.d_model), tp,
                     num_experts=cfg.num_experts, top_k=cfg.top_k,
                     dispatch=cfg.moe_dispatch, quant=cfg.quant)
    with pytest.raises(KeyError, match="not ported"):
        get_config("gemma3-4b-w8")


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("t,e,k", [(4, 8, 2), (256, 8, 2), (37, 16, 1)])
@pytest.mark.parametrize("elt", [4, 2, 1])
def test_plan_moe_dispatch_rows_match_jax(dispatch, t, e, k, elt):
    from repro.core.gemm import plan_moe_dispatch as jplan
    from repro_torch.core.gemm import plan_moe_dispatch as tplan
    kw = dict(dispatch=dispatch, capacity_factor=1.25, elt_bytes=elt)
    assert (tplan(t, e, k, 4096, 14336, **kw).rows
            == jplan(t, e, k, 4096, 14336, **kw).rows)


def test_ragged_and_grouped_swiglu_plans():
    """Ragged plans come from the compiled menu (one grid walk): a bf16
    4-row forward takes the weight stream, the SwiGLU pair's too (its ring
    prices both panels' shared memory), the fp32 pair's FMA tiles price its
    two panels' shared memory, and the dW plan (``ragged="k"``) writes each
    of the G panels once, empty ones too; the grouped SwiGLU plan carries
    two panels too."""
    from repro_torch.core.gemm import (estimate_ragged, plan_batched_gemm,
                                       plan_ragged_gemm)
    from repro_torch.kernels.ftimm.kernel import (GSTREAM_ROWS, TC_TILES,
                                                  TILES, gstream_smem,
                                                  smem_bytes)
    for panels in (1, 2):
        plan = plan_ragged_gemm(16, 4, 5120, 8192, 2, 2, panels=panels)
        assert plan.dim_order == "mn"
        assert plan.body == "stream" and plan.bm == GSTREAM_ROWS
        assert plan.est.smem_bytes == gstream_smem(panels)
    plan = plan_ragged_gemm(16, 4, 5120, 8192, 4, 4, panels=2)
    assert plan.body == "fma" and (plan.bm, plan.bn, plan.bk) in TILES
    assert plan.est.smem_bytes == smem_bytes(plan.bm, plan.bn, plan.bk, 2)
    dw = plan_ragged_gemm(16, 1024, 5120, 8192, 2, 2, ragged="k")
    assert (dw.bm, dw.bn, dw.bk) in (TC_TILES if dw.body == "tc" else TILES)
    assert dw.nsplit == 1
    for t in (0, 4, 1024):
        e = estimate_ragged(16, t, 5120, 8192, bm=dw.bm, bn=dw.bn, bk=dw.bk,
                            ragged="k", in_bytes=2, out_bytes=2)
        assert e.hbm_bytes >= 16 * 5120 * 8192 * 2
    with pytest.raises(ValueError):
        plan_ragged_gemm(16, 4, 5120, 8192, ragged="n")
    plan = plan_batched_gemm(8, 16, 4096, 14336, 2, 2, "none", panels=2)
    assert plan.body == "stream" and plan.est.smem_bytes == gstream_smem(2)
    plan = plan_batched_gemm(8, 16, 4096, 14336, 4, 4, "none", panels=2)
    assert plan.est.smem_bytes == smem_bytes(plan.bm, plan.bn, plan.bk, 2)
    # More rows never price lower; the price follows the total rows (plus
    # one partial chunk per group), not groups x the largest group.
    ts = [estimate_ragged(16, t, 512, 512, bm=16, bn=32, bk=64).hbm_bytes
          for t in (4, 64, 256, 1024)]
    assert ts == sorted(ts)
    few = estimate_ragged(16, 4, 512, 512, bm=16, bn=32, bk=64)
    assert few.hbm_bytes < 16 * 512 * 512 * 4
