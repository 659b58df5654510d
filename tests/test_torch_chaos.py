"""The port's fault injection and fault tolerance on the CPU, against the
JAX package where the reference can run the same case.

* The harness (``runtime.chaos``): occurrence windows, the ``REPRO_CHAOS``
  grammar (malformed specs too), the context manager -- each case through
  both packages' modules.
* The dispatch ladder: the fused -> unfused rung of the dense epilogue
  and of the three SwiGLU pairs (counted once per fault, warned once, the
  result the fused one's within 1e-6 in fp32 and the reference's within
  1e-5), and the ``kernel`` site, where the port raises and the reference
  degrades to its XLA oracle: the deliberate difference, pinned.
* The plan store: a crash between the temp write and the rename, and
  corrupt files.
* The serve engine: transient decode retry, NaN quarantine, page
  exhaustion and bucket miss, each with the reference's token assertions
  and the port's tokens equal to the reference engine's under the same
  plan (fp32, greedy); ``health()``.
* Training: no final checkpoint after an injected shard loss, the
  heartbeat hook, the slow-step site, the supervisor's elastic arithmetic
  through both packages, and a supervised restart whose final parameters
  equal an uninterrupted run's bitwise.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import gemm as jgemm  # noqa: E402
from repro.models.model import init_params as jinit_params  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.gemm import (batched_matmul, dispatch,  # noqa: E402
                                   grouped_swiglu, matmul, matmul_swiglu,
                                   plan_mode_stats, plan_store,
                                   ragged_matmul, ragged_swiglu, tuner)
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402
from repro_torch.models.weights import (from_numpy_params,  # noqa: E402
                                        to_numpy_params)
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.runtime import chaos  # noqa: E402
from repro_torch.runtime import fault_tolerance as ft  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BOTH = pytest.mark.parametrize("mod", [jchaos, chaos], ids=["jax", "torch"])
BOTH_FT = pytest.mark.parametrize("mod", [jft, ft], ids=["jax", "torch"])


# ----------------------------- the harness --------------------------------

@BOTH
def test_fault_plan_occurrence_windows(mod):
    p = mod.FaultPlan([mod.Fault("kernel", at=1, count=2)])
    fired = [p.should_fire("kernel") is not None for _ in range(5)]
    assert fired == [False, True, True, False, False]
    assert p.counters["kernel"] == 5 and p.fired["kernel"] == 2
    assert p.should_fire("ep_ring") is None


@BOTH
def test_parse_env_spec(mod):
    p = mod.parse_env(
        "kernel@2x3; shard_loss@1:chips=4 ;slow_step@0:delay_s=0.5;seed=7")
    assert p.seed == 7
    sites = {f.site: f for f in p.faults}
    assert (sites["kernel"].at, sites["kernel"].count) == (2, 3)
    assert sites["shard_loss"].chips == 4
    assert sites["slow_step"].delay_s == 0.5
    p = mod.parse_env(
        "page_exhaustion@2;bucket_miss@0x3;burst_arrival@1:burst=8;"
        "ep_ring@0;ep_gather@1")
    sites = {f.site: f for f in p.faults}
    assert sites["page_exhaustion"].at == 2
    assert sites["bucket_miss"].count == 3
    assert sites["burst_arrival"].burst == 8
    assert mod.parse_env("").faults == [] and mod.parse_env("  ").faults == []
    assert mod.KNOWN_SITES == jchaos.KNOWN_SITES


@BOTH
@pytest.mark.parametrize("spec,needle", [
    ("kernel@0;", "trailing ';'"),
    ("kernel@0;;slow_step@1", "empty segment"),
    ("kernle@0", "unknown site 'kernle'"),
    ("kernel@x", "occurrence 'x' is not an integer"),
    ("kernel@0x1.5", "count '1.5' is not an integer"),
    ("shard_loss@0:chps=4", "unknown payload key 'chps'"),
    ("slow_step@0:delay_s=fast", "payload delay_s='fast' is not numeric"),
    ("shard_loss@0:chips", "'chips' is not key=value"),
    ("seed=pi", "seed must be an integer"),
])
def test_parse_env_rejects_malformed_specs(mod, spec, needle):
    with pytest.raises(ValueError) as ei:
        mod.parse_env(spec)
    assert "malformed REPRO_CHAOS segment" in str(ei.value)
    assert needle in str(ei.value)


@BOTH
def test_context_manager_restores_state(mod):
    with mod.chaos(mod.FaultPlan([mod.Fault("kernel")])):
        assert mod.active() is not None
        with pytest.raises(mod.KernelLaunchFailure):
            mod.fire("kernel")
    assert mod.should_fire("kernel") is None


def test_poison_logits_on_a_tensor():
    """The port poisons the torch logits on their own device; with no plan
    the very tensor comes back."""
    x = torch.ones(3, 5)
    assert chaos.poison_logits(x) is x
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("nan_logits", slot=1)])):
        y = chaos.poison_logits(x)
    assert torch.isnan(y[1]).all() and torch.isfinite(y[[0, 2]]).all()
    assert torch.isfinite(x).all()


def test_clear_plan_cache_resets_degraded_and_warn_once_state():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        dispatch._degraded("dense", "fused->unfused", RuntimeError("boom"))
    assert plan_mode_stats()["degraded"] == {"dense:fused->unfused": 1}
    assert dispatch._WARNED_RUNGS
    tuner.clear_plan_cache()
    assert "degraded" not in plan_mode_stats()
    assert not tuner.DEGRADED_COUNTS and not dispatch._WARNED_RUNGS


# ------------------------- dispatch fallback ladder ------------------------

def _rng(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _rung_case(name):
    """(port call, reference call, family) of each fused launch."""
    if name == "dense_epilogue":
        a, b, r = _rng(0, 24, 16), _rng(1, 16, 20), _rng(2, 24, 20)
        epi = Epilogue(residual=True)
        return (lambda: matmul(torch.tensor(a), torch.tensor(b), epilogue=epi,
                               residual=torch.tensor(r)),
                lambda: jgemm.matmul(jnp.asarray(a), jnp.asarray(b),
                                     backend="xla") + r, "dense")
    x = _rng(3, 24, 16)
    if name == "dense_pair":
        wg, wu = _rng(4, 16, 20), _rng(5, 16, 20)
        return (lambda: matmul_swiglu(torch.tensor(x), torch.tensor(wg),
                                      torch.tensor(wu)),
                lambda: jgemm.matmul_swiglu(jnp.asarray(x), jnp.asarray(wg),
                                            jnp.asarray(wu), backend="xla"),
                "dense")
    wg, wu = _rng(6, 2, 16, 20), _rng(7, 2, 16, 20)
    if name == "grouped_pair":
        xg = _rng(8, 2, 24, 16)
        return (lambda: grouped_swiglu(torch.tensor(xg), torch.tensor(wg),
                                       torch.tensor(wu)),
                lambda: jgemm.grouped_swiglu(jnp.asarray(xg), jnp.asarray(wg),
                                             jnp.asarray(wu), backend="xla"),
                "batched")
    offs = np.array([0, 10, 24], np.int32)
    return (lambda: ragged_swiglu(torch.tensor(x), torch.tensor(wg),
                                  torch.tensor(wu), torch.tensor(offs)),
            lambda: jgemm.ragged_swiglu(jnp.asarray(x), jnp.asarray(wg),
                                        jnp.asarray(wu), jnp.asarray(offs),
                                        backend="xla"), "ragged")


@pytest.mark.parametrize("name", ["dense_epilogue", "dense_pair",
                                  "grouped_pair", "ragged_pair"])
def test_fused_to_unfused_rung(name):
    """Two injected faults: the rung serves both, counted twice, warned
    once; its result is the fused launch's within 1e-6 and the
    reference's within 1e-5."""
    tuner.clear_plan_cache()
    port, ref, family = _rung_case(name)
    fused = port()
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("kernel_fused",
                                                  count=2)])) as plan:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            outs = [port(), port()]
    assert plan.fired == {"kernel_fused": 2}
    assert plan_mode_stats()["degraded"] == {f"{family}:fused->unfused": 2}
    assert len([r for r in rec
                if "gemm dispatch degraded" in str(r.message)]) == 1
    want = np.asarray(ref())
    for out in outs:
        err = (out - fused).abs().max() / fused.abs().max()
        assert err <= 1e-6
        assert np.abs(out.numpy() - want).max() / np.abs(want).max() <= 1e-5
    tuner.clear_plan_cache()


def _kernel_case(name):
    a, b = _rng(9, 24, 16), _rng(10, 16, 20)
    if name == "dense":
        return (lambda: matmul(torch.tensor(a), torch.tensor(b)),
                lambda **kw: jgemm.matmul(jnp.asarray(a), jnp.asarray(b),
                                          **kw))
    if name == "batched":
        a3, b3 = _rng(11, 3, 24, 16), _rng(12, 3, 16, 20)
        return (lambda: batched_matmul(torch.tensor(a3), torch.tensor(b3)),
                lambda **kw: jgemm.batched_matmul(jnp.asarray(a3),
                                                  jnp.asarray(b3), **kw))
    w = _rng(13, 2, 16, 20)
    offs = np.array([0, 10, 24], np.int32)
    return (lambda: ragged_matmul(torch.tensor(a), torch.tensor(w),
                                  torch.tensor(offs)),
            lambda **kw: jgemm.ragged_matmul(jnp.asarray(a), jnp.asarray(w),
                                             jnp.asarray(offs), **kw))


@pytest.mark.parametrize("name", ["dense", "batched", "ragged"])
def test_kernel_site_raises_where_the_reference_degrades(name):
    """The deliberate difference (ROADMAP Queue 3): an injected ``kernel``
    failure degrades the reference's call to its XLA oracle; the port's
    call raises it (kernel or raise, no plain-version rung) and counts no
    degraded serving."""
    port, ref = _kernel_case(name)
    jgemm.clear_plan_cache()
    with jchaos.chaos(jchaos.FaultPlan([jchaos.Fault("kernel")])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            out = ref(backend="pallas_interpret")
    family = {"dense": "dense", "batched": "batched", "ragged": "ragged"}
    assert jgemm.plan_mode_stats()["degraded"] == {
        f"{family[name]}:pallas->xla": 1}
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref(backend="xla")),
                               rtol=1e-5, atol=1e-5)
    jgemm.clear_plan_cache()
    tuner.clear_plan_cache()
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("kernel")])):
        with pytest.raises(chaos.KernelLaunchFailure):
            port()
        port()                          # the next occurrence runs
    assert "degraded" not in plan_mode_stats()


# ---------------------- plan-store crash & corruption ----------------------

def test_crash_mid_save_leaves_store_intact(tmp_path):
    path = str(tmp_path / "plans.json")
    st = plan_store.PlanStore()
    st.put("dense|64x64x64|ib4|ob4", {"bm": 16, "bn": 32, "bk": 64}, "cpu")
    st.save(path)
    st.put("dense|128x64x64|ib4|ob4", {"bm": 16, "bn": 32, "bk": 64}, "cpu")
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("plan_save_crash")])):
        with pytest.raises(chaos.ChaosError):
            st.save(path)
    blob = json.loads(open(path).read())
    assert list(blob["entries"]) == ["dense|64x64x64|ib4|ob4"]
    assert not [p for p in tmp_path.iterdir()
                if p.name.startswith(".plan_cache.")]
    st.save(path)
    assert len(json.loads(open(path).read())["entries"]) == 2


@pytest.mark.parametrize("mode", ["truncate", "scramble"])
def test_corrupt_plan_cache_degrades_gracefully(tmp_path, mode):
    """Both packages' ``corrupt_json`` damage a file identically, and the
    port's loader refuses it without raising."""
    paths = [tmp_path / f"{n}.json" for n in ("torch", "jax")]
    st = plan_store.PlanStore()
    st.put("dense|64x64x64|ib4|ob4", {"bm": 16, "bn": 32, "bk": 64}, "cpu")
    for p in paths:
        st.save(str(p))
    chaos.corrupt_json(str(paths[0]), seed=3, mode=mode)
    jchaos.corrupt_json(str(paths[1]), seed=3, mode=mode)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    fresh = plan_store.PlanStore()
    assert fresh.load(str(paths[0])) == 0 and fresh.entries == {}
    assert fresh.lookup("dense|64x64x64|ib4|ob4") is None


# -------------------------- serve-engine containment -----------------------

ARCH = "qwen3-1.7b-smoke"


def _serve_models():
    jcfg = dataclasses.replace(jget_config(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH), compute_dtype="float32")
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    model = from_numpy_params(jax.tree.map(np.asarray, params), tcfg, "cpu")
    return jcfg, params, tcfg, model


_MODELS = {}


def _models():
    if not _MODELS:
        _MODELS["m"] = _serve_models()
    return _MODELS["m"]


def _both(faults, prompts, max_new, **kw):
    """The clean port run, the port run under ``faults`` (its engine too)
    and the reference engine's run under the same faults."""
    jcfg, params, tcfg, model = _models()

    def port(plan):
        eng = ServeEngine(tcfg, model, device="cpu", **kw)
        with chaos.chaos(plan):
            out = eng.run([Request(rid=i, prompt=p, max_new_tokens=max_new)
                           for i, p in enumerate(prompts)])
        return eng, [r.out_tokens for r in out]

    _, clean = port(None)
    eng, faulted = port(chaos.FaultPlan([chaos.Fault(**f) for f in faults]))
    jeng = JServeEngine(jcfg, params, **kw)
    with jchaos.chaos(jchaos.FaultPlan([jchaos.Fault(**f) for f in faults])):
        jout = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=max_new)
                         for i, p in enumerate(prompts)])
    return clean, eng, faulted, jeng, [r.out_tokens for r in jout]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(2, 512, n).astype(np.int32)


@pytest.mark.parametrize("count", [1, 2])
def test_serve_transient_retry_is_transparent(count):
    clean, eng, out, jeng, jout = _both(
        [dict(site="transient_decode", at=1, count=count)], [_prompt(6)], 4,
        batch_slots=2, max_len=32)
    assert out == clean == jout
    assert eng.faults["transient_retries"] == count
    assert jeng.faults["transient_retries"] == count
    h = eng.health()
    assert h["degraded_mode"] and h["degraded_servings"] == {}


def test_serve_transient_retries_are_bounded():
    _, _, tcfg, model = _models()
    eng = ServeEngine(tcfg, model, device="cpu", batch_slots=1, max_len=32,
                      retry_backoff_s=0.0)
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("transient_decode",
                                                  count=3)])):
        with pytest.raises(chaos.TransientFault):
            eng.run([Request(rid=0, prompt=_prompt(6), max_new_tokens=4)])
    assert eng.faults["transient_retries"] == 3


def test_serve_nan_quarantine_reprefills():
    clean, eng, out, jeng, jout = _both(
        [dict(site="nan_logits", at=1, slot=0)], [_prompt(6)], 4,
        batch_slots=2, max_len=32)
    assert out == clean == jout
    assert all(t >= 0 for t in out[0])
    assert eng.faults["nonfinite_quarantined"] == 1
    assert jeng.faults["nonfinite_quarantined"] == 1


def test_page_exhaustion_preempts_and_recovers_bit_identical():
    """Occurrences 0 / 1 are the admission allocations; 2 is the first
    decode-growth one -> the preemption path."""
    prompts = [_prompt(6, 5), _prompt(6, 6)]
    clean, eng, out, jeng, jout = _both(
        [dict(site="page_exhaustion", at=2)], prompts, 8, batch_slots=2,
        max_len=32, page_size=4)
    assert out == clean == jout
    assert eng.faults["preemptions"] == jeng.faults["preemptions"] == 1
    assert eng.health()["degraded_mode"]
    eng.alloc.check()
    assert eng.alloc.available == eng.alloc.total


def test_bucket_miss_falls_back_to_exact_prefill():
    clean, eng, out, jeng, jout = _both(
        [dict(site="bucket_miss", at=0)], [_prompt(9, 6)], 4, batch_slots=1,
        max_len=32)
    assert out == clean == jout
    assert eng.faults["bucket_misses"] == jeng.faults["bucket_misses"] == 1
    assert [b for b, _ in eng.walls["prefill"]] == [None]


def test_health_reports_degraded_servings():
    tuner.clear_plan_cache()
    _, _, tcfg, model = _models()
    eng = ServeEngine(tcfg, model, device="cpu", batch_slots=1, max_len=32)
    h = eng.health()
    assert not h["degraded_mode"] and h["degraded_servings"] == {}
    assert h["faults"]["transient_retries"] == 0
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("kernel_fused")])):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng.run([Request(rid=0, prompt=_prompt(6), max_new_tokens=2)])
    h = eng.health()
    assert h["degraded_servings"] == {"dense:fused->unfused": 1}
    assert h["degraded_mode"] and not any(h["faults"].values())
    tuner.clear_plan_cache()


# ------------------------ trainer failure semantics ------------------------

SHAPE = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")


class _Beats:
    def __init__(self):
        self.calls = []

    def beat(self, host, step):
        self.calls.append((host, step))


def test_trainer_no_final_checkpoint_on_failure(tmp_path):
    """A mid-run HostFailure leaves no checkpoint labelled with the final
    step; the monitor hears every step that ran."""
    beats = _Beats()
    tr = Trainer(get_config(ARCH), SHAPE, OptConfig(lr=1e-3, total_steps=8),
                 ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100,
                 device="cpu", monitor=beats)
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("shard_loss", at=5,
                                                  chips=2)])):
        with pytest.raises(ft.HostFailure) as ei:
            tr.run(8, host="h1")
    assert ei.value.lost_chips == 2
    tr.ckpt.wait()
    assert tr.ckpt.latest_step() == 4
    assert beats.calls == [("h1", s) for s in range(5)]


def test_trainer_slow_step_site_sleeps():
    tr = Trainer(get_config(ARCH), SHAPE, OptConfig(total_steps=2),
                 log_every=100, device="cpu")
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("slow_step", at=1,
                                                  delay_s=0.01)])) as plan:
        tr.run(2)
    assert plan.counters["slow_step"] == 2 and plan.fired == {"slow_step": 1}


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@BOTH_FT
def test_dead_host_detection(mod):
    clk = _Clock()
    mon = mod.HeartbeatMonitor(["h0", "h1"], dead_after=10, clock=clk)
    clk.t = 5
    mon.beat("h0", 1)
    clk.t = 12
    assert mon.dead_hosts() == ["h1"]


@BOTH_FT
def test_straggler_detection(mod):
    clk = _Clock()
    mon = mod.HeartbeatMonitor(["h0", "h1", "h2"], straggler_factor=2.0,
                               clock=clk)
    for step in range(1, 6):
        clk.t = step * 1.0
        mon.beat("h0", step)
        mon.beat("h1", step)
    for step in range(1, 6):
        mon.hosts["h2"].step_times.append(5.0)
        mon.hosts["h2"].last_step = step
    assert mon.stragglers() == ["h2"]
    mon = mod.HeartbeatMonitor(["h0", "h1", "h2", "h3"],
                               straggler_factor=2.0, clock=clk)
    for h, t in [("h0", 1.0), ("h1", 1.0), ("h2", 3.0), ("h3", 5.0)]:
        mon.hosts[h].step_times.append(t)
        mon.hosts[h].last_step = 1
    assert mon.stragglers() == ["h3"]      # the true median of an even count


@BOTH_FT
def test_elastic_plans(mod):
    p = mod.plan_elastic_mesh(240, model_parallel=16, global_batch=256)
    assert p.model == 16 and p.data <= 15 and 256 % p.data == 0
    assert p.chips == p.data * 16 <= 240
    assert mod.plan_elastic_mesh(7 * 16, model_parallel=16,
                                 global_batch=256).data == 4
    with pytest.raises(ValueError):
        mod.plan_elastic_mesh(8, model_parallel=16, global_batch=64)


@BOTH_FT
def test_supervisor_retry_shrink_and_history(mod, tmp_path):
    ck = Checkpointer(tmp_path)
    attempts = []

    def run_fn(start_step, mesh_shape):
        attempts.append((start_step, mesh_shape))
        if len(attempts) == 1:
            ck.save(10, {"w": np.zeros(3, np.float32)}, blocking=True)
            raise mod.HostFailure(lost_chips=64, msg="rack power loss")
        return 100

    sup = mod.TrainSupervisor(checkpointer=ck, model_parallel=16,
                              global_batch=256, total_chips=256)
    assert sup.run(run_fn) == 100
    assert attempts == [(0, (16, 16)), (11, (8, 16))]
    kinds = [("failure" if "failure" in h else "attempt")
             for h in sup.history]
    assert kinds == ["attempt", "failure", "attempt"]
    assert sup.history[1] == {"attempt": 0, "failure": "HostFailure",
                              "lost_chips": 64}


def test_supervised_restart_equals_an_uninterrupted_run(tmp_path):
    """shard_loss before step 3: the supervisor re-plans, the trainer
    resumes from step 2's checkpoint, and the final parameters are the
    uninterrupted run's bit for bit."""
    cfg = get_config(ARCH)
    opt = OptConfig(lr=1e-3, total_steps=5)
    steps = 5
    whole = to_numpy_params(Trainer(cfg, SHAPE, opt, log_every=100,
                                    device="cpu").run(steps)[0])
    tr = Trainer(cfg, SHAPE, opt, ckpt_dir=str(tmp_path), ckpt_every=1,
                 log_every=100, device="cpu")

    def run_fn(start_step, mesh_shape):
        try:
            return tr.run(steps)
        finally:
            tr.ckpt.wait()

    sup = ft.TrainSupervisor(checkpointer=tr.ckpt, model_parallel=1,
                             global_batch=SHAPE.global_batch, total_chips=2)
    with chaos.chaos(chaos.FaultPlan([chaos.Fault("shard_loss", at=3)])):
        model, _ = sup.run(run_fn)
    assert [h.get("start") for h in sup.history] == [0, None, 3]
    assert sup.history[2]["chips"] == 1
    got = dict(_leaves(to_numpy_params(model)))
    want = dict(_leaves(whole))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


@pytest.mark.slow
def test_env_spec_arms_the_port_in_a_fresh_process():
    """``REPRO_CHAOS`` arms the port at its first probe, in a subprocess."""
    code = ("import torch\n"
            "from repro_torch.core.gemm import matmul\n"
            "from repro_torch.runtime.chaos import KernelLaunchFailure\n"
            "a = torch.ones(4, 8); b = torch.ones(8, 4)\n"
            "matmul(a, b)\n"
            "try:\n"
            "    matmul(a, b)\n"
            "except KernelLaunchFailure:\n"
            "    print('raised')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_CHAOS="kernel@1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
