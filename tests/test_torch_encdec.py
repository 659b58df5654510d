"""The port's encoder-decoder family (whisper-base) against the JAX package
on the CPU, in fp32: the same parameters (the JAX init, carried over
through numpy) and the same numpy inputs through the cross-attention,
``encode``, ``forward_train``, ``prefill`` (every cache leaf, the cross K /
V included) and three ``decode_step`` calls.  Outputs agree within 1e-4
normwise (max|diff| / max|reference|: the same fp32 arithmetic summed in
other orders); greedy tokens exactly.

The reference's ``ServeEngine`` cannot serve this family: it decodes with
per-slot (B, 1) positions, which its cross-attention mask turns into an
extra axis, and the first step raises.  The port builds the cross mask
from the encoder rows alone, so its engine is held against the reference's
model-level greedy loop (a scalar position), one request at a time."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import (from_numpy_params,  # noqa: E402
                                        to_numpy_params)
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "whisper-base-smoke"
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


def _frames(cfg, b, seed):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(2, cfg.vocab_size, (b, s)),
            "frames": _frames(cfg, b, seed + 1)}


def _jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ----------------------------- cross-attention -----------------------------

D, H, KVH, HD = 64, 4, 2, 16


def _cross_inputs(s_enc, sq=3, b=2, seed=0):
    rng = np.random.default_rng(seed)
    jp = jattn.init_attention_params(jax.random.PRNGKey(seed), D, H, KVH, HD)
    tp = tattn.AttentionParams(*(torch.tensor(np.asarray(jp[n]))
                                 for n in ("wq", "wk", "wv", "wo")))
    x = rng.standard_normal((b, sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_enc, KVH, HD)).astype(np.float32)
            for _ in range(2))
    res = rng.standard_normal((b, sq, D)).astype(np.float32)
    return jp, tp, x, k, v, res


_KW = dict(num_heads=H, num_kv_heads=KVH, head_dim=HD, window=0,
           causal=False, qk_norm=False, use_rope=False)


@pytest.mark.parametrize("s_enc", [16, 1030])
def test_cross_attention_matches_jax(s_enc):
    """S_enc = 16 (one KV block) and 1030 (past a 1024-row block: padded
    rows masked), with the residual in the out-projection."""
    jp, tp, x, k, v, res = _cross_inputs(s_enc)
    want, jcache = jattn.attention(
        jnp.asarray(x), jp, positions=jnp.arange(3),
        cross_kv=(jnp.asarray(k), jnp.asarray(v)),
        compute_dtype=jnp.float32, residual=jnp.asarray(res), **_KW)
    got, tcache = tattn.attention(
        torch.tensor(x), tp, positions=torch.arange(3),
        cross_kv=(torch.tensor(k), torch.tensor(v)),
        compute_dtype=torch.float32, residual=torch.tensor(res), **_KW)
    assert jcache is None and tcache is None
    assert _rel_err(got, want) <= TOL


def test_cross_attention_with_per_row_positions():
    """A (B, 1) per-slot decode, rows at positions 5 and 9, equals each row
    run alone with a scalar position: the cross mask depends on the encoder
    rows only.  The reference raises on the same input (its mask gains an
    axis from the (B, 1) positions)."""
    jp, tp, x, k, v, _ = _cross_inputs(20, sq=1)
    kv = (torch.tensor(k), torch.tensor(v))
    got, _ = tattn.attention(torch.tensor(x), tp,
                             positions=torch.tensor([[5], [9]]), cross_kv=kv,
                             compute_dtype=torch.float32, **_KW)
    for row, pos in enumerate((5, 9)):
        alone, _ = tattn.attention(
            torch.tensor(x[row:row + 1]), tp,
            positions=torch.arange(pos, pos + 1),
            cross_kv=tuple(t[row:row + 1] for t in kv),
            compute_dtype=torch.float32, **_KW)
        torch.testing.assert_close(got[row:row + 1], alone, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError):
        jattn.attention(jnp.asarray(x), jp,
                        positions=jnp.asarray([[5], [9]]),
                        cross_kv=(jnp.asarray(k), jnp.asarray(v)),
                        compute_dtype=jnp.float32, **_KW)


# ------------------------------- the model ---------------------------------

def test_weights_round_trip_and_init():
    """The reference's tree -> the port's modules -> the tree, bitwise;
    ``init_params`` draws the encoder, the cross-attention and the frame
    projection with the reference's shapes and scales."""
    jcfg, params, tcfg, model = _models()
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(to_numpy_params(model))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert np.array_equal(got[path], leaf), path
    fresh = tmodel.init_params(get_config(ARCH), 0, device="cpu")
    assert len(fresh.encoder) == tcfg.encoder_layers
    assert fresh.enc_norm.dtype == fresh.layers[0].ln_cross.dtype == \
        torch.float32
    assert fresh.layers[0].cross.q_norm is None
    d = tcfg.d_model
    assert fresh.frame_proj.shape == (d, d) and fresh.patch_proj is None
    assert abs(fresh.frame_proj.float().std().item() - (2 / d) ** 0.5) < 0.01


def test_encode_matches_jax():
    jcfg, params, tcfg, model = _models()
    frames = _frames(jcfg, 2, 3)
    want = jmodel.encode(params, jcfg, jnp.asarray(frames))
    got = tmodel.encode(model, tcfg, torch.tensor(frames))
    assert _rel_err(got, want) <= TOL


def test_forward_train_matches_jax():
    jcfg, params, tcfg, model = _models()
    batch = _batch(jcfg, 2, 10, 4)
    want, _ = jmodel.forward_train(params, jcfg, _jax(batch))
    got, _ = tmodel.forward_train(model, tcfg, _torch(batch))
    assert _rel_err(got, want) <= TOL


def test_prefill_cache_and_decode_match_jax():
    """Prefill (logits and every cache leaf: k / v and the cross K / V),
    then three decode steps at a scalar position."""
    jcfg, params, tcfg, model = _models()
    batch = _batch(jcfg, 2, 10, 5)
    jlog, jcache = jmodel.prefill(params, jcfg, _jax(batch),
                                  jmodel.make_cache(jcfg, 2, 16))
    tlog, tcache = tmodel.prefill(model, tcfg, _torch(batch),
                                  tmodel.make_cache(tcfg, 2, 16, device=CPU))
    assert sorted(tcache) == sorted(jcache) == ["cross_k", "cross_v", "k",
                                                "v"]
    assert _rel_err(tlog, jlog) <= TOL
    for name in jcache:
        assert _rel_err(tcache[name], jcache[name]) <= TOL, name
    nxt = np.random.default_rng(6).integers(2, jcfg.vocab_size, (2, 3))
    for step in range(3):
        tok = nxt[:, step:step + 1]
        jlog, jcache = jmodel.decode_step(params, jcfg, jnp.asarray(tok),
                                          jcache, jnp.int32(10 + step))
        tlog, tcache = tmodel.decode_step(model, tcfg, torch.tensor(tok),
                                          tcache, 10 + step)
        assert _rel_err(tlog, jlog) <= TOL, step
    assert _rel_err(tcache["k"], jcache["k"]) <= TOL


# ------------------------------ serving ------------------------------------

def _jax_greedy(jcfg, params, decode, prompt, new, max_len):
    """The reference's model-level greedy loop for one request: zero frames,
    ``prefill`` then ``decode`` (its jitted ``decode_step``) at a scalar
    position."""
    batch = {"tokens": jnp.asarray(prompt[None, :]),
             "frames": jnp.zeros((1, jcfg.encoder_seq, jcfg.d_model))}
    logits, cache = jmodel.prefill(params, jcfg, batch,
                                   jmodel.make_cache(jcfg, 1, max_len))
    out = [int(jnp.argmax(logits[0]))]
    for i in range(new - 1):
        logits, cache = decode(params, tokens=jnp.asarray([[out[-1]]]),
                               cache=cache, pos=jnp.int32(len(prompt) + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_engine_matches_jax_model_greedy():
    """The port's engine on the dense-slot rung, fp32, 2 slots, 5 requests
    (the queue runs past the slots), prompts of 3 or more tokens, 4 new
    tokens each: every request's tokens are the reference's model-level
    greedy tokens."""
    jcfg, params, tcfg, model = _models()
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, jcfg.vocab_size, n).astype(np.int32)
               for n in (3, 12, 5, 9, 7)]
    eng = ServeEngine(tcfg, model, batch_slots=2, max_len=32, device="cpu")
    reqs = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                    for i, p in enumerate(prompts)])
    assert not eng.paged and sorted(eng.cache) == ["cross_k", "cross_v", "k",
                                                   "v"]
    decode = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
    for r, p in zip(reqs, prompts):
        assert r.done and r.out_tokens == _jax_greedy(jcfg, params, decode,
                                                      p, 4, 32)
    assert not eng.health()["degraded_mode"]


def test_paged_engine_and_bucketed_prefill_refused():
    """encdec serves on the dense-slot rung only, and has no bucketed
    prefill, as in the reference."""
    cfg = get_config(ARCH)
    model = tmodel.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        ServeEngine(cfg, model, paged=True, device="cpu")
    cache = tmodel.make_cache(cfg, 1, 8, device=CPU)
    with pytest.raises(ValueError, match="bucketed prefill unsupported"):
        tmodel.prefill_bucket(model, cfg, _torch(_batch(cfg, 1, 4, 0)), cache,
                              torch.tensor([4]))


def test_launcher_serves_whisper_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new", "3", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "slot cache" in out and "cross_k" in out and "KV pool" not in out
    assert out.count("req ") == 3 and "serving done" in out
