"""The port's serving engine on the CPU: the same requests through the JAX
``ServeEngine`` and the port's give the same tokens and terminal states
(fp32 config, greedy; the dense decoder and both MoE decoders), and the
engine's paging, preemption, buckets and admission control behave as the
reference's do."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.serve import buckets as jbuckets  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.models.weights import from_numpy_params  # noqa: E402
from repro_torch.serve import buckets  # noqa: E402
from repro_torch.serve.engine import Overloaded, Request, ServeEngine  # noqa: E402
from repro_torch.serve.kv_pages import PageAllocator, PagesExhausted  # noqa: E402

ARCH = "qwen3-1.7b-smoke"


def _prompts(n, seed, lens=(12,)):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 512, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


def _engine(cfg=None, **kw):
    cfg = cfg or get_config(ARCH)
    kw.setdefault("device", "cpu")
    return ServeEngine(cfg, init_params(cfg, 0, device="cpu"), **kw)


def test_engine_matches_jax_engine():
    """fp32 config, 2 slots, 3 requests (one waits for a slot), 4 new
    tokens each: identical greedy tokens and terminal flags."""
    jcfg = dataclasses.replace(jget_config(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompts = _prompts(3, 0, lens=(12, 5, 9))
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


@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke",
                                  "llama4-scout-17b-a16e-smoke"])
def test_moe_engine_matches_jax_engine(arch):
    """The MoE decoders (capacity and ragged dispatch) through both
    engines: 2 slots, 3 requests, decode past the 16-position window."""
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    params = jinit_params(jcfg, jax.random.PRNGKey(1))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompts = _prompts(3, 1, lens=(18, 5, 11))
    jreqs = JServeEngine(jcfg, params, batch_slots=2, max_len=32).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    treqs = ServeEngine(tcfg, model, batch_slots=2, max_len=32,
                        device="cpu").run(
        [Request(rid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens,
                                              j.out_tokens)
        assert (t.done, t.timed_out, t.shed) == (j.done, j.timed_out, j.shed)
        assert t.done and len(t.out_tokens) == 6


def test_batched_equals_single_with_mixed_lengths():
    """Slots at different depths in one fused decode, and freed-slot reuse,
    give each request its solo tokens."""
    prompts = _prompts(4, 2, lens=(5, 12, 9, 7))
    mnts = [3, 10, 6, 8]
    single = [_engine(batch_slots=1, max_len=48).run(
        [Request(rid=0, prompt=p, max_new_tokens=m)])[0].out_tokens
        for p, m in zip(prompts, mnts)]
    batched = _engine(batch_slots=2, max_len=48).run(
        [Request(rid=i, prompt=p, max_new_tokens=m)
         for i, (p, m) in enumerate(zip(prompts, mnts))])
    assert [r.out_tokens for r in batched] == single


def test_page_exhaustion_preempts_and_recovers():
    """A pool too small for both requests' full depth: decode growth
    preempts the youngest, which re-prefills prompt + generated tokens and
    finishes with the tokens of an undisturbed run; the pool drains."""
    prompts = _prompts(2, 5, lens=(6,))
    mk = lambda: [Request(rid=i, prompt=p, max_new_tokens=8)  # noqa: E731
                  for i, p in enumerate(prompts)]
    ref = [r.out_tokens for r in _engine(batch_slots=2, max_len=32,
                                         page_size=4).run(mk())]
    eng = _engine(batch_slots=2, max_len=32, page_size=4, num_pages=6)
    out = eng.run(mk())
    assert [r.out_tokens for r in out] == ref
    assert eng.faults["preemptions"] >= 1
    assert eng.health()["degraded_mode"]
    eng.alloc.check()
    assert eng.alloc.available == eng.alloc.total


def test_one_token_request_stops_after_its_prefill_token():
    """The prefill's token can be a request's last: the engine finishes it
    at once instead of decoding one more (the reference's engine returns
    two tokens for max_new_tokens=1)."""
    eng = _engine(batch_slots=2, max_len=32)
    reqs = eng.run([Request(rid=i, prompt=p, max_new_tokens=1 + i)
                    for i, p in enumerate(_prompts(2, 12))])
    assert [len(r.out_tokens) for r in reqs] == [1, 2]
    assert all(r.done for r in reqs)
    assert eng.alloc.available == eng.alloc.total


def test_bucket_miss_takes_the_exact_prefill_rung():
    prompt = _prompts(1, 6, lens=(20,))[0]
    mk = lambda: [Request(rid=0, prompt=prompt, max_new_tokens=4)]  # noqa: E731
    ref = _engine(batch_slots=1, max_len=32).run(mk())[0].out_tokens
    eng = _engine(batch_slots=1, max_len=32, buckets=(8, 16))
    assert eng.run(mk())[0].out_tokens == ref
    assert eng.faults["bucket_misses"] == 1


def test_admission_rejects_with_typed_overloaded():
    eng = _engine(batch_slots=1, max_len=64)
    eng.run([Request(rid=i, prompt=p, max_new_tokens=3)
             for i, p in enumerate(_prompts(3, 7))])
    assert eng.cost.calibrated()
    with pytest.raises(Overloaded) as exc:
        eng.submit(Request(rid=9, prompt=_prompts(1, 8)[0],
                           max_new_tokens=50, deadline_s=1e-9))
    assert exc.value.projected_s > exc.value.deadline_s
    assert eng.faults["admission_rejected"] == 1
    assert not eng.queue


def test_oversized_request_rejected_up_front():
    eng = _engine(batch_slots=1, max_len=64, page_size=4, num_pages=2)
    with pytest.raises(Overloaded, match="KV pages"):
        eng.submit(Request(rid=0, prompt=_prompts(1, 9)[0],
                           max_new_tokens=20))


def test_expired_deadline_frees_the_slot():
    eng = _engine(batch_slots=1, max_len=32)
    reqs = [Request(rid=0, prompt=_prompts(1, 10)[0], max_new_tokens=6,
                    deadline_s=0.0)]
    eng.run(reqs)
    assert reqs[0].done and reqs[0].timed_out
    assert eng.faults["deadline_expired"] == 1
    assert eng.alloc.available == eng.alloc.total


def test_detokenize_and_temperature_sampling():
    eng = _engine(batch_slots=2, max_len=32, seed=3,
                  detokenize=lambda t: f"<{t}>")
    reqs = eng.run([Request(rid=i, prompt=p, max_new_tokens=5,
                            temperature=1.0)
                    for i, p in enumerate(_prompts(2, 11))])
    for r in reqs:
        assert len(r.out_tokens) == 5
        assert all(0 <= t < 512 for t in r.out_tokens)
        assert r.text == "".join(f"<{t}>" for t in r.out_tokens)
    eng.close()


def test_engine_without_a_device_needs_a_card(monkeypatch):
    cfg = get_config(ARCH)
    model = init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model)


def test_engine_refuses_parameters_on_another_device():
    cfg = get_config(ARCH)
    model = init_params(cfg, 0, device="cpu").to("meta")
    with pytest.raises(ValueError, match="parameters live on"):
        ServeEngine(cfg, model, device="cpu")


def test_page_allocator_lifo_and_all_or_nothing():
    a = PageAllocator(4, first=1)
    assert a.alloc(2, "x") == [1, 2]
    with pytest.raises(PagesExhausted) as exc:
        a.alloc(3, "y")
    assert (exc.value.needed, exc.value.available) == (3, 2)
    assert a.available == 2 and a.owned("y") == []
    assert a.free_owner("x") == [1, 2]
    a.check()
    assert a.alloc(1, "z") == [2]


@pytest.mark.parametrize("max_prompt", [1, 31, 32, 100, 512])
def test_buckets_match_jax(max_prompt):
    ladder = buckets.make_buckets(max_prompt)
    assert ladder == jbuckets.make_buckets(max_prompt)
    for n in (1, 17, 32, 33, max_prompt, max_prompt + 1):
        assert (buckets.bucket_for(n, ladder)
                == jbuckets.bucket_for(n, ladder))
    cfg, jcfg = get_config("qwen3-1.7b"), jget_config("qwen3-1.7b")
    assert (buckets.gemm_signatures(cfg, 4)
            == jbuckets.gemm_signatures(jcfg, 4))


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new", "3", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "serving done" in out


# ------------------------- the dense-slot rung -----------------------------

RECURRENT = ["mamba2-370m-smoke", "zamba2-7b-smoke"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engine_matches_jax_engine(arch):
    """The SSM and hybrid families through both engines' dense-slot rung:
    fp32, 2 slots, 5 requests (the queue runs beyond the slots, so slots
    are reused after an idle slot's decode), prompts of 3 or more tokens,
    4 new tokens each: identical greedy tokens and terminal flags."""
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    params = jinit_params(jcfg, jax.random.PRNGKey(2))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    prompts = _prompts(5, 13, lens=(3, 12, 5, 9, 7))
    jeng = JServeEngine(jcfg, params, batch_slots=2, max_len=32)
    jreqs = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=4)
                      for i, p in enumerate(prompts)])
    teng = ServeEngine(tcfg, model, batch_slots=2, max_len=32, device="cpu")
    treqs = teng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                      for i, p in enumerate(prompts)])
    assert not jeng.paged and not teng.paged
    for j, t in zip(jreqs, treqs):
        assert t.out_tokens == j.out_tokens, (t.rid, t.out_tokens,
                                              j.out_tokens)
        assert (t.done, t.timed_out, t.shed) == (j.done, j.timed_out, j.shed)
        assert t.done and len(t.out_tokens) == 4
    assert [b for b, _ in teng.walls["prefill"]] == [None] * 5
    health = teng.health()
    assert set(health) == set(jeng.health()) - {"prefill_cache_size",
                                                "degraded_servings"}
    assert not health["degraded_mode"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_paged_engine_refused_for_a_recurrent_family(arch):
    cfg = get_config(arch)
    model = init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="paged KV unsupported"):
        ServeEngine(cfg, model, paged=True, device="cpu")
    eng = ServeEngine(cfg, model, device="cpu")
    assert (eng.paged, eng.cost, eng.alloc, eng.kv, eng.buckets) == (
        False, None, None, None, ())


def test_dense_model_on_the_dense_slot_rung_matches_paged():
    """qwen3-1.7b-smoke with ``paged=False`` (a dense slot cache, exact-
    length prefills) gives the paged engine's tokens: 2 slots, 5
    requests."""
    prompts = _prompts(5, 14, lens=(12, 5, 9, 7, 3))
    mk = lambda: [Request(rid=i, prompt=p, max_new_tokens=5)  # noqa: E731
                  for i, p in enumerate(prompts)]
    cfg = get_config(ARCH)
    model = init_params(cfg, 0, device="cpu")
    paged = ServeEngine(cfg, model, batch_slots=2, max_len=32, device="cpu")
    dense = ServeEngine(cfg, model, batch_slots=2, max_len=32, device="cpu",
                        paged=False)
    assert paged.paged and not dense.paged
    assert ([r.out_tokens for r in dense.run(mk())]
            == [r.out_tokens for r in paged.run(mk())])
    assert set(dense.cache) == {"k", "v"}
    assert "pages" not in dense.health() and "pages" in paged.health()


def test_dense_slot_rung_never_rejects_and_stops_one_token_requests():
    """No pages and no cost model: a deadline cannot be priced, so submit
    takes it; a one-token request ends on its prefill token (the port's
    deviation from the reference's engine, ROADMAP Queue 3)."""
    eng = _engine(get_config("mamba2-370m-smoke"), batch_slots=2, max_len=32)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=1 + i,
                    deadline_s=60.0)
            for i, p in enumerate(_prompts(2, 15))]
    eng.run(reqs)
    assert [len(r.out_tokens) for r in reqs] == [1, 2]
    assert all(r.done and not r.timed_out for r in reqs)
    assert eng.faults["admission_rejected"] == 0
    assert eng.active == [None, None]


def test_dense_slot_quarantine_zeroes_the_slot_region():
    """A slot whose state turns non-finite is quarantined: every leaf's
    region of that slot is zeroed, the request re-prefills prompt + tokens
    so far and finishes with the tokens of an undisturbed run; the other
    slot is untouched."""
    cfg = dataclasses.replace(get_config("zamba2-7b-smoke"),
                              compute_dtype="float32")
    model = init_params(cfg, 0, device="cpu")
    prompts = _prompts(2, 16, lens=(6, 9))
    mk = lambda: [Request(rid=i, prompt=p, max_new_tokens=6)  # noqa: E731
                  for i, p in enumerate(prompts)]
    ref = [r.out_tokens for r in ServeEngine(
        cfg, model, batch_slots=2, max_len=32, device="cpu").run(mk())]

    eng = ServeEngine(cfg, model, batch_slots=2, max_len=32, device="cpu")
    evicted = []
    evict = eng._evict_slot

    def spy(slot):
        evict(slot)
        evicted.append({k: v[:, slot].clone() for k, v in eng.cache.items()})

    eng._evict_slot = spy
    reqs = mk()
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.cache["ssm_h"][:, 1] = float("nan")       # poison slot 1
    while eng.queue or any(eng.active):
        eng.step()
    assert eng.faults["nonfinite_quarantined"] == 1
    assert len(evicted) == 1
    assert all(not leaf.any() for leaf in evicted[0].values())
    assert [r.out_tokens for r in reqs] == ref
    assert all(torch.isfinite(v).all() for v in eng.cache.values())


@pytest.mark.parametrize("arch", RECURRENT)
def test_launcher_serves_a_recurrent_family_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new", "3", "--prompt-len", "6"])
    out = capsys.readouterr().out
    assert "slot cache" in out and "KV pool" not in out
    assert out.count("req ") == 3 and "serving done" in out
