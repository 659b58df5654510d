"""The last three dense architectures of the reference in the port, on the
CPU: ``gemma3-4b`` (qk-norm, the 5 : 1 sliding-window : global pattern),
``minitron-4b`` (no qk-norm, full attention) and ``qwen3-8b``, each at
``-smoke`` in fp32, the port against the JAX package on the same
numpy-seeded weights (bridged by ``models.weights``): the training
forward's logits (1e-4 normwise), the greedy ids of a prefill and of
paged decode steps, and the serve engine's tokens against the reference
engine's.  gemma3 runs 6 layers (five windowed layers of window 16, one
global), a 40-token prompt and decode steps past the window, so the
windowed layers drop rows.  The registry lists the reference's ten
architectures, and each ``-smoke`` config equals the reference's field for
field."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import from_numpy_params  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_pages import PagedKV  # noqa: E402

GEMMA, MINITRON, QWEN8 = ("gemma3-4b-smoke", "minitron-4b-smoke",
                          "qwen3-8b-smoke")
ARCHS = [GEMMA, MINITRON, QWEN8]
DEPTH = {GEMMA: 6}        # five windowed layers and one global
PROMPT = 40               # past the smoke window of 16
TOL = 1e-4
CPU = torch.device("cpu")


def _configs(arch):
    depth = {"num_layers": DEPTH[arch]} if arch in DEPTH else {}
    return (dataclasses.replace(jget_config(arch), compute_dtype="float32",
                                **depth),
            dataclasses.replace(get_config(arch), compute_dtype="float32",
                                **depth))


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, tcfg = _configs(arch)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, CPU)
    return jcfg, params, tcfg, model


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(2, 512, shape).astype(np.int32)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int64))


def test_registry_lists_the_reference_archs():
    assert list_archs() == jlist_archs()
    assert len(list_archs()) == 10


@pytest.mark.parametrize("arch", sorted(jlist_archs()))
def test_smoke_config_equals_the_reference(arch):
    want = dataclasses.asdict(jget_config(arch + "-smoke"))
    assert dataclasses.asdict(get_config(arch + "-smoke")) == want
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, params, tcfg, model = _models(arch)
    toks = _tokens((2, PROMPT), 1)
    jl, _ = jax.jit(functools.partial(jmodel.forward_train, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)})
    tl, _ = tmodel.forward_train(model, tcfg, {"tokens": _t(toks)})
    v = tcfg.vocab_size
    assert _rel_err(tl[..., :v].numpy(), np.asarray(jl)[..., :v]) <= TOL
    assert (tl[..., :v].argmax(-1).numpy()
            == np.asarray(jl)[..., :v].argmax(-1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_greedy_decode_matches_jax(arch):
    """A 40-token prefill into the reference's dense cache and the port's
    page pool (pages in reverse order), then 6 greedy decode steps on each:
    the logits of every step within 1e-4 and the same ids."""
    jcfg, params, tcfg, model = _models(arch)
    page, steps = 4, 6
    toks = _tokens((1, PROMPT), 2)
    cap = PROMPT + steps
    _, jc = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(toks)},
        cache=jmodel.make_cache(jcfg, 1, cap))
    one = tmodel.make_cache(tcfg, 1, PROMPT, device=CPU)
    tl, one = tmodel.prefill(model, tcfg, {"tokens": _t(toks)}, one)
    n_pages = -(-cap // page)
    pages = list(range(n_pages, 0, -1))
    kv = PagedKV.build(tcfg, slots=1, max_len=cap, num_pages=n_pages + 1,
                       page_size=page, device=CPU)
    kv.insert(0, pages, one["k"][:, 0], one["v"][:, 0])
    jdecode = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
    nxt = tl.argmax(-1)[:, None]
    for step in range(steps):
        pos = PROMPT + step
        jl, jc = jdecode(params, tokens=jnp.asarray(nxt.numpy(), jnp.int32),
                         cache=jc, pos=jnp.int32(pos))
        tl, _ = tmodel.decode_step(model, tcfg, nxt, kv.cache(),
                                   torch.as_tensor([pos]),
                                   page_table=kv.device_table())
        assert _rel_err(tl.numpy(), jl) <= TOL, step
        assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
        nxt = tl.argmax(-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """2 slots, 3 requests (one waits for a slot), 6 new tokens each: the
    40-token prompt decodes past the window on gemma3's windowed layers."""
    jcfg, params, tcfg, model = _models(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, 512, n).astype(np.int32)
               for n in (PROMPT, 9, 17)]
    jreqs = JServeEngine(jcfg, params, batch_slots=2, max_len=64).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    treqs = ServeEngine(tcfg, model, batch_slots=2, max_len=64,
                        device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens,
                                              j.out_tokens)
        assert t.done and len(t.out_tokens) == 6


def test_gemma3_windows_drop_rows():
    """A windowed layer reads only the last 16 positions: over one layer,
    changing the first of 40 prompt tokens leaves the last position's
    logits exactly as they were, and moves them with the window off."""
    _, _, tcfg, model = _models(GEMMA)
    assert tcfg.windows() == (16, 16, 16, 16, 16, 0)
    toks = _tokens((1, PROMPT), 5)
    other = toks.copy()
    other[0, 0] += 1
    layers = model.layers
    moved = {}
    try:
        model.layers = layers[:1]
        for pattern in ((16,), (0,)):
            cfg = dataclasses.replace(tcfg, num_layers=1,
                                      window_pattern=pattern)
            a, _ = tmodel.forward_train(model, cfg, {"tokens": _t(toks)})
            b, _ = tmodel.forward_train(model, cfg, {"tokens": _t(other)})
            moved[pattern] = float((a[0, -1] - b[0, -1]).abs().max())
    finally:
        model.layers = layers
    assert moved[(16,)] == 0.0 and moved[(0,)] > 1e-6
