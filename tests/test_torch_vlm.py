"""The port's vision-language family (llava-next-34b) against the JAX
package on the CPU, in fp32: the same parameters (the JAX init, carried
over through numpy) and the same numpy inputs -- tokens after the stub
frontend's patch embeddings -- through ``forward_train`` (logits over the
text positions only), ``prefill`` (logits and cache, the patch rows in
front), three ``decode_step`` calls and the bucketed ``prefill_bucket``
(right-padded rows of two lengths, each row's logits at its own last
position past the patches).  Outputs agree within 1e-4 normwise
(max|diff| / max|reference|); the port's ``ServeEngine`` (paged rung,
buckets) gives the JAX ``ServeEngine``'s greedy tokens.  Pages of 4 rows
make every request span several pages, so a patch offset counted twice or
not at all shows as another token."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import (from_numpy_params,  # noqa: E402
                                        to_numpy_params)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "llava-next-34b-smoke"
CPU = torch.device("cpu")
TOL = 1e-4


def _rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _models():
    """(jax cfg, jax params, port cfg, port model), fp32, PRNGKey(0)."""
    jcfg = dataclasses.replace(jget_config(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, tcfg, model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(2, cfg.vocab_size, (b, s)),
            "patch_embeds": rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32) * 0.02}


def _jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_weights_round_trip_and_init():
    """The reference's tree -> the port's modules -> the tree, bitwise;
    ``init_params`` draws the (D, D) patch projection He-scaled."""
    jcfg, params, tcfg, model = _models()
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(to_numpy_params(model))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(got[path], leaf), path
    fresh = tmodel.init_params(get_config(ARCH), 0, device="cpu")
    d = tcfg.d_model
    assert fresh.patch_proj.shape == (d, d)
    assert fresh.encoder is None and fresh.frame_proj is None
    assert abs(fresh.patch_proj.float().std().item() - (2 / d) ** 0.5) < 0.01


def test_forward_train_matches_jax():
    """Logits over the text positions only: (B, S, V_pad)."""
    jcfg, params, tcfg, model = _models()
    batch = _batch(jcfg, 2, 10, 4)
    want, _ = jmodel.forward_train(params, jcfg, _jax(batch))
    got, _ = tmodel.forward_train(model, tcfg, _torch(batch))
    assert got.shape == (2, 10, tcfg.vocab_padded)
    assert _rel_err(got, want) <= TOL


def test_prefill_cache_and_decode_match_jax():
    """The cache holds num_patches + max_len rows; prefill (logits, k, v),
    then three decode steps at a scalar position counting the patches."""
    jcfg, params, tcfg, model = _models()
    batch = _batch(jcfg, 2, 10, 5)
    jlog, jcache = jmodel.prefill(params, jcfg, _jax(batch),
                                  jmodel.make_cache(jcfg, 2, 16))
    tcache = tmodel.make_cache(tcfg, 2, 16, device=CPU)
    assert tcache["k"].shape[2] == 16 + tcfg.num_patches
    tlog, tcache = tmodel.prefill(model, tcfg, _torch(batch), tcache)
    assert _rel_err(tlog, jlog) <= TOL
    for name in jcache:
        assert _rel_err(tcache[name], jcache[name]) <= TOL, name
    nxt = np.random.default_rng(6).integers(2, jcfg.vocab_size, (2, 3))
    pos = 10 + jcfg.num_patches
    for step in range(3):
        tok = nxt[:, step:step + 1]
        jlog, jcache = jmodel.decode_step(params, jcfg, jnp.asarray(tok),
                                          jcache, jnp.int32(pos + step))
        tlog, tcache = tmodel.decode_step(model, tcfg, torch.tensor(tok),
                                          tcache, pos + step)
        assert _rel_err(tlog, jlog) <= TOL, step
    assert _rel_err(tcache["v"], jcache["v"]) <= TOL


def test_prefill_bucket_matches_jax():
    """Two right-padded rows of 5 and 11 tokens in a 16-token bucket: each
    row's logits at lens - 1 + num_patches, and the cache."""
    jcfg, params, tcfg, model = _models()
    batch = _batch(jcfg, 2, 16, 7)
    lens = np.array([5, 11], np.int32)
    jlog, jcache = jmodel.prefill_bucket(params, jcfg, _jax(batch),
                                         jmodel.make_cache(jcfg, 2, 16),
                                         jnp.asarray(lens))
    tlog, tcache = tmodel.prefill_bucket(
        model, tcfg, _torch(batch),
        tmodel.make_cache(tcfg, 2, 16, device=CPU), torch.as_tensor(lens))
    assert _rel_err(tlog, jlog) <= TOL
    for name in jcache:
        assert _rel_err(tcache[name], jcache[name]) <= TOL, name


def test_engine_matches_jax_engine():
    """Both engines' paged rung with buckets, fp32, 2 slots, 5 requests (the
    queue runs past the slots), prompts of 3 or more tokens, 4 new tokens
    each, pages of 4 rows: identical greedy tokens and terminal flags, and
    each request held num_patches + its depth rows of pages."""
    jcfg, params, tcfg, model = _models()
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (3, 12, 5, 9, 7)]
    kw = dict(batch_slots=2, max_len=32, page_size=4)
    jreqs = JServeEngine(jcfg, params, **kw).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=4)
         for i, p in enumerate(prompts)])
    eng = ServeEngine(tcfg, model, device="cpu", **kw)
    assert eng.paged and eng.extra == tcfg.num_patches
    assert eng.kv.table.shape[1] == -(-(32 + tcfg.num_patches) // 4)
    peak = {}
    alloc = eng.alloc.alloc

    def tracking(n, owner):
        pages = alloc(n, owner)
        peak[owner] = peak.get(owner, 0) + n
        return pages

    eng.alloc.alloc = tracking
    treqs = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                     for i, p in enumerate(prompts)])
    for j, t, p in zip(jreqs, treqs, prompts):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens,
                                              j.out_tokens)
        assert (t.done, t.timed_out, t.shed) == (j.done, j.timed_out, j.shed)
        assert t.done and len(t.out_tokens) == 4
        # The last decode writes row num_patches + len + 2.
        assert peak[id(t)] == -(-(tcfg.num_patches + len(p) + 3) // 4)
    eng.alloc.check()
    assert eng.alloc.available == eng.alloc.total


def test_decode_stops_at_max_len_past_the_patches():
    """A request that asks for more tokens than ``max_len`` holds stops
    where the JAX engine's does: at depth max_len - 1 + num_patches, so
    its tokens fill max_len past its prompt, as a text model's would."""
    jcfg, params, tcfg, model = _models()
    prompt = np.arange(2, 7, dtype=np.int32)
    kw = dict(batch_slots=2, max_len=16, page_size=4)
    want = JServeEngine(jcfg, params, **kw).run(
        [JRequest(rid=0, prompt=prompt, max_new_tokens=30)])[0].out_tokens
    got = ServeEngine(tcfg, model, device="cpu", **kw).run(
        [Request(rid=0, prompt=prompt, max_new_tokens=30)])[0].out_tokens
    assert got == want and len(got) == 16 - len(prompt)


def test_launcher_serves_llava_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new", "3", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "KV pool" in out
    assert out.count("req ") == 3 and "serving done" in out
