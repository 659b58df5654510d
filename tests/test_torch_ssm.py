"""The port's Mamba2 (SSD) blocks and the SSM / hybrid models against the
JAX package on the CPU, in fp32: the same parameters (the JAX init,
carried over through numpy) and the same numpy inputs through
``ssd_forward``, ``ssd_decode_step``, ``forward_train``, ``prefill`` and
``decode_step``.  Outputs and states agree within 1e-4 normwise
(max|diff| / max|reference|: the same fp32 arithmetic summed in other
orders).  The reference's own SSD properties (chunked scan = recurrence,
decode continues prefill, initial-state threading) hold for the port at
the reference's tolerances."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import SSMBlock  # noqa: E402
from repro_torch.models.weights import (from_numpy_params,  # noqa: E402
                                        to_numpy_params)

CPU = torch.device("cpu")
F32 = torch.float32
D_MODEL, NSTATE, CHUNK = 64, 16, 32
TOL = 1e-4
# (arch, depth): mamba2, the smoke hybrid (one group of 2), and a hybrid
# of 5 layers -- 2 groups of 2 and a remainder of 1 with no attention.
MODELS = [("mamba2-370m-smoke", None), ("zamba2-7b-smoke", None),
          ("zamba2-7b-smoke", 5)]


def _rel_err(got, want):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_ssm_params(seed=5):
    return jssm.init_ssm_params(jax.random.PRNGKey(seed), D_MODEL, NSTATE)


def _port_ssm_params(jparams) -> ssm.SSMParams:
    return ssm.SSMParams(**{k: torch.tensor(np.asarray(v))
                            for k, v in jparams.items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.5


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [5, 32, 70])
def test_ssd_forward_matches_jax(s, with_state):
    """y and the final state at S = 5 (one padded chunk), 32 (one whole
    chunk) and 70 (three chunks, the last padded), chunk 32, from zero or
    a carried state."""
    jp = _jax_ssm_params()
    x = _x((2, s, D_MODEL), s)
    di, heads, n = ssm.ssm_dims(D_MODEL, NSTATE)
    h0 = (_x((2, heads, ssm.HEADDIM, n), 99) if with_state else None)
    jy, jh = jssm.ssd_forward(
        jnp.asarray(x), jp, ssm_state=NSTATE, chunk=CHUNK,
        compute_dtype=jnp.float32,
        initial_state=None if h0 is None else jnp.asarray(h0))
    ty, th = ssm.ssd_forward(
        torch.tensor(x), _port_ssm_params(jp), ssm_state=NSTATE,
        chunk=CHUNK, compute_dtype=F32,
        initial_state=None if h0 is None else torch.tensor(h0))
    assert _rel_err(ty, jy) <= TOL
    assert _rel_err(th, jh) <= TOL


def test_ssd_decode_step_matches_jax():
    """One recurrent step from a random state and conv window."""
    jp = _jax_ssm_params()
    di, heads, n = ssm.ssm_dims(D_MODEL, NSTATE)
    x = _x((3, 1, D_MODEL), 1)
    h = _x((3, heads, ssm.HEADDIM, n), 2)
    conv = _x((3, ssm.CONV_WIDTH - 1, di + 2 * n), 3)
    jy, jst = jssm.ssd_decode_step(
        jnp.asarray(x), jp, {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        ssm_state=NSTATE, compute_dtype=jnp.float32)
    ty, tst = ssm.ssd_decode_step(
        torch.tensor(x), _port_ssm_params(jp),
        {"h": torch.tensor(h), "conv": torch.tensor(conv)},
        ssm_state=NSTATE, compute_dtype=F32)
    assert _rel_err(ty, jy) <= TOL
    assert _rel_err(tst["h"], jst["h"]) <= TOL
    assert _rel_err(tst["conv"], jst["conv"]) <= TOL


def test_softplus_is_logaddexp_past_the_identity_threshold():
    """dt's softplus follows ``jax.nn.softplus`` where ``F.softplus``
    turns into the identity (x > 20)."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 19.5, 20.5, 40.0], np.float32)
    got = ssm._softplus(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-7, atol=0)


# --------------------- the reference's SSD properties ----------------------

def _naive_ssd(x: torch.Tensor, params: ssm.SSMParams):
    """Per-timestep recurrence oracle (no chunking), in fp32."""
    from repro_torch.models.layers import dense, rms_norm
    bsz, s, _ = x.shape
    di, hh, n = ssm.ssm_dims(D_MODEL, NSTATE)
    z, xs, b, c, dt = ssm._split_proj(dense(x, params.in_proj, F32), di, n)
    xbc = ssm._causal_conv(torch.cat([xs, b, c], -1), params.conv_w,
                           params.conv_b)
    xs = xbc[..., :di].reshape(bsz, s, hh, ssm.HEADDIM)
    b, c = xbc[..., di:di + n], xbc[..., di + n:]
    a = -torch.exp(params.A_log)
    dt = ssm._softplus(dt + params.dt_bias)
    h = torch.zeros(bsz, hh, ssm.HEADDIM, n)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)
        xdt = xs[:, t] * dt[:, t][..., None]
        h = decay[:, :, None, None] * h + torch.einsum(
            "bhp,bn->bhpn", xdt, b[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, c[:, t]))
    y = torch.stack(ys, 1) + xs * params.D_skip[None, None, :, None]
    y = y.reshape(bsz, s, di) * torch.nn.functional.silu(z)
    return dense(rms_norm(y, params.norm), params.out_proj, F32), h


@pytest.mark.parametrize("s,chunk", [(32, 8), (40, 16), (16, 16)])
def test_chunked_ssd_equals_recurrence(s, chunk):
    params = _port_ssm_params(_jax_ssm_params())
    x = torch.tensor(_x((2, s, D_MODEL), 10 + s))
    y, h = ssm.ssd_forward(x, params, ssm_state=NSTATE, chunk=chunk,
                           compute_dtype=F32)
    y_ref, h_ref = _naive_ssd(x, params)
    torch.testing.assert_close(y, y_ref, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(h, h_ref, rtol=2e-3, atol=2e-3)


def test_decode_continues_prefill():
    """ssd_forward(x[:, :s]) then one decode step from its state and conv
    tail == ssd_forward(x)[:, s]."""
    params = _port_ssm_params(_jax_ssm_params())
    s = 24
    x = torch.tensor(_x((1, s + 1, D_MODEL), 20))
    y_full, _ = ssm.ssd_forward(x, params, ssm_state=NSTATE, chunk=8,
                                compute_dtype=F32)
    _, h = ssm.ssd_forward(x[:, :s], params, ssm_state=NSTATE, chunk=8,
                           compute_dtype=F32)
    state = {"h": h, "conv": ssm.conv_tail(x[:, :s], params,
                                           ssm_state=NSTATE,
                                           compute_dtype=F32)}
    y_dec, _ = ssm.ssd_decode_step(x[:, s:s + 1], params, state,
                                   ssm_state=NSTATE, compute_dtype=F32)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, s], rtol=5e-3,
                               atol=5e-3)


def test_initial_state_threading():
    """ssd_forward(x2, initial_state=state(x1)) == the tail of
    ssd_forward(x1 x2), with an identity conv tap so that the split point
    carries no conv history."""
    jp = dict(_jax_ssm_params())
    jp["conv_w"] = np.zeros_like(jp["conv_w"])
    jp["conv_w"][-1] = 1.0
    jp["conv_b"] = np.zeros_like(jp["conv_b"])
    params = _port_ssm_params(jp)
    x = torch.tensor(_x((1, 32, D_MODEL), 30))
    kw = dict(ssm_state=NSTATE, chunk=8, compute_dtype=F32)
    y_full, h_full = ssm.ssd_forward(x, params, **kw)
    _, h1 = ssm.ssd_forward(x[:, :16], params, **kw)
    y2, h2 = ssm.ssd_forward(x[:, 16:], params, initial_state=h1, **kw)
    torch.testing.assert_close(h2, h_full, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(y2, y_full[:, 16:], rtol=5e-3, atol=5e-3)


# ------------------------------ model level --------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch, layers):
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, from_numpy_params(tree, tcfg, CPU)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(2, 512, shape).astype(np.int32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


@pytest.mark.parametrize("arch,layers", MODELS)
def test_forward_train_matches_jax(arch, layers):
    """Logits of a 40-token sequence: two SSD chunks of 32, the second
    padded."""
    jcfg, params, tcfg, model = _models(arch, layers)
    toks = _tokens((2, 40), 1)
    jl, _ = jmodel.forward_train(params, jcfg, {"tokens": jnp.asarray(toks)})
    tl, aux = tmodel.forward_train(model, tcfg, {"tokens": _t(toks)})
    assert _rel_err(tl, jl) <= TOL
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch,layers", MODELS)
def test_prefill_and_decode_match_jax(arch, layers):
    """A 37-token prefill (every cache leaf) and then 3 decode steps at
    per-slot positions (logits and every cache leaf after each)."""
    jcfg, params, tcfg, model = _models(arch, layers)
    toks = _tokens((2, 40), 2)
    jcache = jmodel.make_cache(jcfg, 2, 48)
    tcache = tmodel.make_cache(tcfg, 2, 48, device=CPU)
    assert set(tcache) == set(jcache)
    jl, jcache = jmodel.prefill(params, jcfg,
                                {"tokens": jnp.asarray(toks[:, :37])}, jcache)
    tl, tcache = tmodel.prefill(model, tcfg, {"tokens": _t(toks[:, :37])},
                                tcache)
    assert _rel_err(tl, jl) <= TOL
    for key in jcache:
        assert _rel_err(tcache[key], jcache[key]) <= TOL, key
    for step in range(3):
        pos = np.full(2, 37 + step, np.int32)
        nxt = toks[:, 37 + step:38 + step]
        jl, jcache = jmodel.decode_step(params, jcfg, jnp.asarray(nxt),
                                        jcache, jnp.asarray(pos))
        tl, tcache = tmodel.decode_step(model, tcfg, _t(nxt), tcache,
                                        torch.as_tensor(pos, dtype=torch.long))
        assert _rel_err(tl, jl) <= TOL, step
        for key in jcache:
            assert _rel_err(tcache[key], jcache[key]) <= TOL, (step, key)
        assert (tl.argmax(-1).numpy()
                == np.asarray(jnp.argmax(jl, -1))).all()


@pytest.mark.parametrize("prompt", [1, 2, 3, 5])
def test_short_prompt_then_decode_matches_jax_forward(prompt):
    """A prompt of 1, 2, 3 or 5 tokens, prefilled, then one decode step:
    its logits are the JAX ``forward_train``'s at that position.  A
    1-token prompt takes the decode branch; a 2-token prompt's conv tail
    is left-padded with a zero row (the reference's prefill leaves that
    row as the cache held it: ROADMAP Queue 3)."""
    jcfg, params, tcfg, model = _models("mamba2-370m-smoke", None)
    toks = _tokens((1, prompt + 1), 3)
    want, _ = jmodel.forward_train(params, jcfg,
                                   {"tokens": jnp.asarray(toks)})
    cache = tmodel.make_cache(tcfg, 1, 8, device=CPU)
    _, cache = tmodel.prefill(model, tcfg, {"tokens": _t(toks[:, :prompt])},
                              cache)
    got, _ = tmodel.decode_step(model, tcfg, _t(toks[:, prompt:]), cache,
                                prompt)
    assert _rel_err(got, want[:, prompt]) <= TOL


def test_hybrid_applies_one_shared_block():
    """The hybrid holds one shared attention + MLP block (one parameter
    set, applied after every group) and its cache one K/V pair per
    group."""
    _, _, tcfg, model = _models("zamba2-7b-smoke", 5)
    assert all(isinstance(b, SSMBlock) for b in model.layers)
    assert model.shared_attn is not None and model.shared_attn.mlp is not None
    names = [n for n, _ in model.named_parameters() if "shared" in n]
    assert len(names) == len(set(names)) and "shared_attn.attn.wq" in names
    cache = tmodel.make_cache(tcfg, 3, 16, device=CPU)
    assert cache["attn_k"].shape == (2, 3, 16, tcfg.num_kv_heads,
                                     tcfg.head_dim_)
    assert cache["ssm_h"].shape[:2] == (5, 3)


@pytest.mark.parametrize("arch", ["mamba2-370m-smoke", "zamba2-7b-smoke"])
def test_numpy_tree_round_trip(arch):
    """``to_numpy_params`` gives back the reference's tree, leaf for leaf
    (``layers.ssm.*`` stacked on (L,), ``shared_attn`` unstacked)."""
    _, params, _, model = _models(arch, None)
    want = jax.tree.map(np.asarray, params)
    got = to_numpy_params(model)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.astype(np.float32), w)


def test_serving_dtypes_keep_the_decay_parameters_fp32():
    """A serving model: projections and conv taps in the compute dtype,
    A_log / D_skip / dt_bias / norm and the norm scales in fp32."""
    cfg = get_config("mamba2-370m-smoke")
    model = tmodel.init_params(cfg, 0, device="cpu")
    p = model.layers[0].ssm
    for name in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert getattr(p, name).dtype == torch.bfloat16, name
    for name in ("A_log", "D_skip", "dt_bias", "norm"):
        assert getattr(p, name).dtype == F32, name
    assert model.layers[0].ln.dtype == F32
    assert torch.allclose(p.A_log.exp(),
                          torch.linspace(1, 16, p.A_log.numel()))
    di, heads, n = ssm.ssm_dims(cfg.d_model, cfg.ssm_state)
    assert p.in_proj.shape == (cfg.d_model, 2 * di + 2 * n + heads)
    assert abs(p.in_proj.float().std().item()
               - (2.0 / cfg.d_model) ** 0.5) < 0.01
    assert not any(q.requires_grad for q in model.parameters())
    again = tmodel.init_params(cfg, 0, device="cpu")
    assert torch.equal(again.layers[1].ssm.in_proj,
                       model.layers[1].ssm.in_proj)
    cache = tmodel.make_cache(cfg, 2, 8, device=CPU)
    assert (cache["h"].dtype, cache["conv"].dtype) == (F32, torch.bfloat16)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_full_configs_resolve_with_the_reference_widths(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert get_config(arch + "-smoke").num_layers == 2
    di, heads, n = ssm.ssm_dims(cfg.d_model, cfg.ssm_state)
    assert 2 * di + 2 * n + heads == {"mamba2-370m": 4384,
                                      "zamba2-7b": 14576}[arch]


def test_bucketed_prefill_refuses_a_recurrent_family():
    _, _, tcfg, model = _models("mamba2-370m-smoke", None)
    with pytest.raises(ValueError, match="bucketed prefill"):
        tmodel.prefill_bucket(model, tcfg, {"tokens": _t(_tokens((2, 8), 4))},
                              tmodel.make_cache(tcfg, 2, 8, device=CPU),
                              torch.tensor([8, 5]))


@pytest.mark.parametrize("symbol", [
    "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32",
    "ampere_sgemm_32x32_sliced1x4_nn",
    "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16>"])
def test_profile_files_the_ssd_library_products_apart(symbol):
    """``profile_serve`` files the SSD contractions' library kernels under
    a group of their own, and the ragged dW's under its kernel."""
    from repro_torch.launch.profile_serve import group_of
    assert group_of(symbol) == "library GEMM (SSD)"
    assert (group_of("void ftimm_gemm_ragged_dw_tc_kernel<true>()")
            == "ftimm_gemm_ragged_dw")
