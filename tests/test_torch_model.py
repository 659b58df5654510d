"""The port's dense decoder against the JAX model on ``qwen3-1.7b-smoke``:
the same parameters (the JAX init, carried over by ``from_numpy_params``)
and the same numpy token ids through ``prefill``, ``prefill_bucket`` and
``decode_step``, dense and paged, on the CPU.

In ``compute_dtype="float32"`` the logits agree within 1e-4 (normwise,
max|diff| / max|logits|: the same fp32 arithmetic summed in other orders)
and the greedy ids are equal.  In bf16 both sides round the same fp32
accumulators to bf16 at the same places; where two fp32 sums straddle a
bf16 rounding boundary one activation moves by an ulp (2^-8 relative), so
the bound is 2e-2 normwise, the per-kernel bf16 tolerance."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import from_numpy_params  # noqa: E402
from repro_torch.serve.kv_pages import PagedKV  # noqa: E402

ARCH = "qwen3-1.7b-smoke"
CPU = torch.device("cpu")


def _configs(dtype):
    return (dataclasses.replace(jget_config(ARCH), compute_dtype=dtype),
            dataclasses.replace(get_config(ARCH), compute_dtype=dtype))


@functools.lru_cache(maxsize=None)
def _models(dtype):
    jcfg, tcfg = _configs(dtype)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, tcfg, from_numpy_params(tree, tcfg, CPU)


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(2, 512, shape).astype(np.int32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jcfg, params, tcfg, model = _models(dtype)
    toks = _tokens((2, 12), 1)
    jl, jc = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, 2, 16))
    tl, tc = tmodel.prefill(model, tcfg, {"tokens": _t(toks)},
                            tmodel.make_cache(tcfg, 2, 16, device=CPU))
    assert _rel_err(tl.numpy(), jl) <= TOL[dtype]
    assert _rel_err(tc["k"].float().numpy(), jc["k"]) <= TOL[dtype]
    assert _rel_err(tc["v"].float().numpy(), jc["v"]) <= TOL[dtype]
    if dtype == "float32":
        assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()


def test_prefill_bucket_matches_jax():
    jcfg, params, tcfg, model = _models("float32")
    lens = np.array([12, 7, 1], np.int32)
    toks = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = _tokens((n,), 10 + i)
    jl, _ = jax.jit(functools.partial(jmodel.prefill_bucket, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, 3, 16), lens=jnp.asarray(lens))
    tl, _ = tmodel.prefill_bucket(model, tcfg, {"tokens": _t(toks)},
                                  tmodel.make_cache(tcfg, 3, 16, device=CPU),
                                  torch.as_tensor(lens))
    assert _rel_err(tl.numpy(), jl) <= 1e-4
    assert (tl.argmax(-1).numpy() == np.asarray(jl.argmax(-1))).all()
    # Each row equals the unpadded prefill of its own prompt.
    for i, n in enumerate(lens):
        one, _ = tmodel.prefill(model, tcfg, {"tokens": _t(toks[i:i + 1, :n])},
                                tmodel.make_cache(tcfg, 1, int(n), device=CPU))
        assert _rel_err(one.numpy(), tl[i:i + 1].numpy()) <= 1e-5


def _prefilled(dtype, toks, max_len):
    """Both models' logits and caches after prefilling ``toks``."""
    jcfg, params, tcfg, model = _models(dtype)
    b = toks.shape[0]
    _, jc = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, b, max_len))
    _, tc = tmodel.prefill(model, tcfg, {"tokens": _t(toks)},
                           tmodel.make_cache(tcfg, b, max_len, device=CPU))
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    """Three decode steps at per-slot depths, fed the same tokens."""
    jcfg, params, tcfg, model = _models(dtype)
    toks = _tokens((2, 9), 2)
    jc, tc = _prefilled(dtype, toks, 24)
    jdec = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
    nxt = _tokens((2, 1), 3)
    pos = np.array([9, 9], np.int32)
    for step in range(3):
        jl, jc = jdec(params, tokens=jnp.asarray(nxt), cache=jc,
                      pos=jnp.asarray(pos))
        tl, tc = tmodel.decode_step(model, tcfg, _t(nxt), tc,
                                    torch.as_tensor(pos, dtype=torch.long))
        assert _rel_err(tl.numpy(), jl) <= TOL[dtype], step
        if dtype == "float32":
            want = np.asarray(jl.argmax(-1))
            assert (tl.argmax(-1).numpy() == want).all(), step
        nxt = np.asarray(jl.argmax(-1), np.int32)[:, None]
        pos = pos + 1


def test_scalar_position_decode_matches_jax():
    jcfg, params, tcfg, model = _models("float32")
    toks = _tokens((2, 5), 4)
    jc, tc = _prefilled("float32", toks, 8)
    nxt = _tokens((2, 1), 5)
    jl, _ = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))(
        params, tokens=jnp.asarray(nxt), cache=jc, pos=jnp.int32(5))
    tl, _ = tmodel.decode_step(model, tcfg, _t(nxt), tc, 5)
    assert _rel_err(tl.numpy(), jl) <= 1e-4


def test_paged_decode_equals_dense_decode():
    """Paged decode (pages scattered over the pool in a non-trivial order,
    slots at different depths) gives the dense cache's logits."""
    _, _, tcfg, model = _models("float32")
    page, max_len = 4, 16
    lens = [7, 3]
    dense = tmodel.make_cache(tcfg, 2, max_len, device=CPU)
    kv = PagedKV.build(tcfg, slots=2, max_len=max_len, num_pages=9,
                       page_size=page, device=CPU)
    slot_pages = [[5, 2], [7]]
    for slot, n in enumerate(lens):
        toks = _tokens((1, n), 20 + slot)
        one = tmodel.make_cache(tcfg, 1, n, device=CPU)
        _, one = tmodel.prefill(model, tcfg, {"tokens": _t(toks)}, one)
        for name in ("k", "v"):
            dense[name][:, slot, :n] = one[name][:, 0]
        kv.insert(slot, slot_pages[slot], one["k"][:, 0], one["v"][:, 0])
    kv.extend_slot(1, [3], 1)
    pos = torch.as_tensor(lens, dtype=torch.long)
    nxt = _t(_tokens((2, 1), 30))
    for _ in range(3):
        dl, dense = tmodel.decode_step(model, tcfg, nxt, dense, pos)
        pl, _ = tmodel.decode_step(model, tcfg, nxt, kv.cache(), pos,
                                   page_table=kv.device_table())
        assert _rel_err(pl.numpy(), dl.numpy()) <= 1e-6
        nxt = dl.argmax(-1)[:, None]
        pos = pos + 1


def test_paged_decode_matches_jax():
    jcfg, params, tcfg, model = _models("float32")
    page = 4
    toks = _tokens((2, 6), 6)
    jc, tc = _prefilled("float32", toks, 6)
    table = np.array([[3, 1, 0, 0], [2, 4, 0, 0]], np.int32)
    shape = (tcfg.num_layers, 5, page, tcfg.num_kv_heads, tcfg.head_dim_)
    jpool = {n: np.zeros(shape, np.float32) for n in ("k", "v")}
    kv = PagedKV.build(tcfg, slots=2, max_len=16, num_pages=5,
                       page_size=page, device=CPU)
    for slot in range(2):
        kv.insert(slot, list(table[slot, :2]), tc["k"][:, slot],
                  tc["v"][:, slot])
        for n in ("k", "v"):
            flat = jpool[n].reshape(shape[0], -1, *shape[3:])
            rows = (table[slot, np.arange(6) // page] * page
                    + np.arange(6) % page)
            flat[:, rows] = np.asarray(jc[n])[:, slot]
    nxt = _tokens((2, 1), 7)
    pos = np.array([6, 6], np.int32)
    jl, _ = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))(
        params, tokens=jnp.asarray(nxt),
        cache={n: jnp.asarray(v) for n, v in jpool.items()},
        pos=jnp.asarray(pos), page_table=jnp.asarray(table))
    tl, _ = tmodel.decode_step(model, tcfg, _t(nxt), kv.cache(),
                               torch.as_tensor(pos, dtype=torch.long),
                               page_table=kv.device_table())
    assert _rel_err(tl.numpy(), jl) <= 1e-4


def test_init_params_shapes_and_scales():
    """The port's own init: reference shapes, dtypes and distributions."""
    cfg = get_config(ARCH)
    model = tmodel.init_params(cfg, 0, device="cpu")
    assert model.embed.shape == (cfg.vocab_padded, cfg.d_model)
    assert model.embed.dtype == torch.bfloat16
    assert len(model.layers) == cfg.num_layers
    wq = model.layers[0].attn.wq.float()
    assert wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim_)
    assert abs(wq.std().item() - (2.0 / cfg.d_model) ** 0.5) < 0.01
    assert abs(model.embed.float().std().item() - 0.02) < 0.002
    assert model.final_norm.dtype == torch.float32
    assert not any(p.requires_grad for p in model.parameters())
    again = tmodel.init_params(cfg, 0, device="cpu")
    assert torch.equal(again.layers[1].mlp.w_down, model.layers[1].mlp.w_down)


def test_init_params_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(get_config(ARCH), 0)


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="not ported yet"):
        get_config("gemma3-4b-smoke")
