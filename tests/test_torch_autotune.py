"""The port's measured tuning loop on the CPU: the plan store's round trip
and its refusals, the measured search through the plain versions (whose
time does not depend on the plan), calibration, the store's hooks in the
planners, dispatch, serving and the launcher, and parity with the JAX
package's plan store, calibration fit and epilogue helpers on the same
inputs."""
import importlib
import itertools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gemm import (autotune, dispatch, plan_store,  # noqa: E402
                                   tuner)
from repro_torch.core.gemm.cmr import H100, estimate  # noqa: E402
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.kernels.ftimm.epilogue import Epilogue  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16, F32 = torch.bfloat16, torch.float32
SHAPE = (300, 200, 96)          # a dense bf16 signature, small on the CPU


@pytest.fixture(autouse=True)
def _clean_store(monkeypatch):
    monkeypatch.delenv(plan_store.ENV_VAR, raising=False)
    tuner.clear_plan_cache()
    yield
    tuner.clear_plan_cache()


def _tune(m=SHAPE[0], k=SHAPE[1], n=SHAPE[2], **kw):
    kw.setdefault("top_k", 2)
    kw.setdefault("repeats", 1)
    kw.setdefault("device", "cpu")
    return autotune.autotune_gemm(m, k, n, 2, 2, **kw)


# ---------------------------------------------------------------------------
# The persistent store
# ---------------------------------------------------------------------------

def test_measured_then_cached_roundtrip(tmp_path):
    r = _tune()
    assert r.plan.mode == "measured" and r.engine == "plain"
    assert r.t_measured <= r.t_analytic         # analytic is candidate 0
    served = tuner.plan_gemm(*SHAPE, 2, 2)
    assert served.mode == "cached"
    assert (served.body, served.bm, served.bn, served.bk) == \
        (r.plan.body, r.plan.bm, r.plan.bn, r.plan.bk)

    path = tmp_path / "plans.json"
    autotune.save_plan_cache(str(path))
    blob = json.loads(path.read_text())
    assert blob["device_kind"] == "cpu"
    rec = blob["entries"][r.key]
    assert (rec["body"], rec["kslices"], rec["nsplit"]) == \
        (r.plan.body, r.plan.kslices, 1)
    autotune.clear_plan_store()
    assert tuner.plan_gemm(*SHAPE, 2, 2).mode == "analytic"
    assert autotune.load_plan_cache(str(path)) == 1
    assert tuner.plan_gemm(*SHAPE, 2, 2).mode == "cached"


@pytest.mark.slow
def test_roundtrip_survives_fresh_process(tmp_path):
    path = tmp_path / "plans.json"
    _tune()
    autotune.save_plan_cache(str(path))
    code = ("from repro_torch.core.gemm import tuner; "
            f"print(tuner.plan_gemm({SHAPE[0]}, {SHAPE[1]}, {SHAPE[2]}, 2, "
            "2).mode)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               **{plan_store.ENV_VAR: str(path)})
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cached"


_BAD_FILES = {
    "missing": None,
    "garbage": "{ not json !",
    "not_dict": json.dumps([1, 2, 3]),
    "bad_schema": json.dumps({"schema": 999, "device_kind": "cpu",
                              "entries": {}}),
    "bad_entries": json.dumps({"schema": 1, "device_kind": "cpu",
                               "entries": "nope"}),
}


@pytest.mark.parametrize("name", sorted(_BAD_FILES))
def test_corrupt_cache_files_ignored(tmp_path, name):
    p = tmp_path / f"{name}.json"
    if _BAD_FILES[name] is not None:
        p.write_text(_BAD_FILES[name])
    assert autotune.load_plan_cache(str(p)) == 0
    assert tuner.plan_gemm(256, 256, 32).mode == "analytic"


def test_mismatched_device_kind_ignored(tmp_path):
    r = _tune()
    path = tmp_path / "plans.json"
    autotune.save_plan_cache(str(path))
    blob = json.loads(path.read_text())
    blob["device_kind"] = "nvidia_h100_80gb_hbm3"
    path.write_text(json.dumps(blob))
    autotune.clear_plan_store()
    assert autotune.load_plan_cache(str(path)) == 0
    assert tuner.plan_gemm(*r.dims, 2, 2).mode == "analytic"


def test_store_never_mixes_device_kinds():
    st = plan_store.get_store()
    st.put("dense|8x8x8|ib4|ob4", {"bm": 16, "bn": 32, "bk": 64}, "cpu")
    with pytest.raises(ValueError, match="does not belong"):
        st.put("dense|8x8x9|ib4|ob4", {"bm": 16, "bn": 32, "bk": 64},
               "nvidia_h100_80gb_hbm3")


@pytest.mark.parametrize("case", [
    # (planner args, record): each names a plan the call cannot run.
    ("fma tile not compiled", ((4096, 4096, 128, 4, 4), {}),
     {"bm": 8192, "bn": 8192, "bk": 8192}),
    ("tc where TMA cannot read B", ((1024, 2048, 2048, 2, 2),
                                     {"b_ok": False}),
     {"body": "tc", "bm": 128, "bn": 128, "bk": 64}),
    ("tc on fp32", ((1024, 2048, 2048, 4, 4), {}),
     {"body": "tc", "bm": 128, "bn": 128, "bk": 64}),
    ("stream over 16 rows", ((64, 2048, 2048, 2, 2), {}),
     {"body": "stream", "bm": 16, "bn": 128, "bk": 256, "kslices": 8}),
    ("split-K on the stream", ((4, 2048, 2048, 2, 2), {}),
     {"body": "stream", "bm": 4, "bn": 128, "bk": 256, "kslices": 8,
      "nsplit": 4}),
    ("split-K on the SwiGLU pair", ((1024, 2048, 6144, 2, 2),
                                    {"panels": 2}),
     {"body": "tc", "bm": 128, "bn": 128, "bk": 64, "nsplit": 4}),
    ("padded edges", ((1024, 2048, 2048, 2, 2), {}),
     {"body": "tc", "bm": 128, "bn": 128, "bk": 64, "edge": "padded"}),
], ids=lambda c: c[0])
def test_cache_can_suggest_but_never_force_invalid_plans(case):
    _, (args, flags), rec = case
    key = tuner.dense_key(*args, **flags)
    plan_store.get_store().put(key, dict(rec, dim_order="mn"), "cpu")
    tuner.clear_planner_caches()
    p = tuner.plan_gemm(*args, **flags)
    assert p.mode == "analytic"
    assert p.est.smem_bytes <= H100.smem_per_block


def test_measured_plan_is_analytic_valid():
    for m, k, n, a in [(300, 200, 96, 2), (4, 2048, 512, 2), (63, 130, 33, 4)]:
        r = autotune.autotune_gemm(m, k, n, a, a, top_k=3, repeats=1,
                                   device="cpu", store=False)
        sigs = {(c.body, c.bm, c.bn, c.bk, c.dim_order, c.kslices)
                for c in tuner.gemm_candidates(m, k, n, a, a)}
        p = r.plan
        assert (p.body, p.bm, p.bn, p.bk, p.dim_order, p.kslices) in sigs
        assert p.est.smem_bytes <= H100.smem_per_block


def test_batched_and_ragged_roundtrip():
    kw = dict(top_k=2, repeats=1, device="cpu")
    rb = autotune.autotune_batched_gemm(4, 64, 64, 128, 2, 2, **kw)
    rm = autotune.autotune_ragged_gemm(4, 256, 64, 128, 2, 2, **kw)
    rk = autotune.autotune_ragged_gemm(4, 256, 64, 128, 2, 2, ragged="k",
                                       **kw)
    assert rb.plan.mode == rm.plan.mode == rk.plan.mode == "measured"
    assert tuner.plan_batched_gemm(4, 64, 64, 128, 2, 2).mode == "cached"
    assert tuner.plan_ragged_gemm(4, 256, 64, 128, 2, 2).mode == "cached"
    assert tuner.plan_ragged_gemm(4, 256, 64, 128, 2, 2,
                                  ragged="k").mode == "cached"
    # Other variants of the same dims do not collide.
    assert tuner.plan_batched_gemm(4, 64, 64, 128, 2, 2,
                                   shared="b").mode == "analytic"
    assert tuner.plan_ragged_gemm(4, 256, 64, 128, 2, 2,
                                  trans="nt").mode == "analytic"


_PAIRS = {
    "dense": (lambda **kw: autotune.autotune_gemm(4, 256, 512, 2, 2, **kw),
              lambda **kw: tuner.plan_gemm(4, 256, 512, 2, 2, **kw)),
    "batched": (lambda **kw: autotune.autotune_batched_gemm(
        8, 16, 256, 512, 2, 2, **kw),
        lambda **kw: tuner.plan_batched_gemm(8, 16, 256, 512, 2, 2, **kw)),
    "ragged": (lambda **kw: autotune.autotune_ragged_gemm(
        16, 4, 256, 512, 2, 2, **kw),
        lambda **kw: tuner.plan_ragged_gemm(16, 4, 256, 512, 2, 2, **kw)),
}


@pytest.mark.parametrize("family", sorted(_PAIRS))
def test_swiglu_pair_has_its_own_key(family):
    tune, plan = _PAIRS[family]
    r = tune(panels=2, top_k=2, repeats=1, device="cpu")
    assert r.key.endswith("pair") and r.plan.mode == "measured"
    assert plan(panels=2).mode == "cached"
    assert plan().mode == "analytic"        # the one-panel product


def test_key_fragments_keep_the_reference_key_by_default():
    assert tuner.dense_key(4, 8, 16, 2, 2, b_bytes=2) == "dense|4x8x16|ib2|ob2"
    assert tuner.batched_key(2, 4, 8, 16, 4, 4) == \
        "batched|2x4x8x16|ib4|ob4|shared:none"
    assert tuner.ragged_key(2, 4, 8, 16, 2, 2, "k") == \
        "ragged|2x4x8x16|ib2|ob2|ragged:k"
    assert tuner.dense_key(4, 8, 16, 2, 4, b_bytes=4, panels=2, a_ok=False,
                           b_ok=False, trans="nt") == \
        "dense|4x8x16|ib2|ob4|bb4+pair+a_ok:0+b_ok:0+trans:nt"
    assert tuner.batched_key(2, 4, 8, 16, 4, 4, a_major=None) == \
        "batched|2x4x8x16|ib4|ob4|shared:none+a_major:none"


# ---------------------------------------------------------------------------
# The timing harness and its refusals
# ---------------------------------------------------------------------------

def test_timing_harness_on_the_plain_versions():
    epi = Epilogue(bias=True, activation="silu", residual=True)
    r = _tune(top_k=4, repeats=2, epilogue=epi, store=False)
    assert 0.0 < r.t_measured <= r.t_analytic
    assert len(r.timed) == 4 and all(t > 0 for *_sig, t in r.timed)
    # Fused and unfused candidates both ran, the tail with each.
    assert {c.fuse for c in tuner.shortlist(tuner.gemm_candidates(
        *SHAPE, 2, 2, epi_ops=epi.num_ops), 4)} == {True, False}
    times = autotune.time_dense_plans(*SHAPE, [r.plan, r.analytic_plan],
                                      in_bytes=2, out_bytes=2, device="cpu",
                                      repeats=1, epilogue=epi)
    assert len(times) == 2 and all(t > 0 for t in times)


def test_unsupported_operand_width_rejected():
    with pytest.raises(ValueError, match="unsupported operand width"):
        autotune.autotune_gemm(64, 64, 64, 8, 4, device="cpu", store=False)
    with pytest.raises(ValueError, match="unsupported operand width"):
        autotune.autotune_gemm(64, 64, 64, 3, 4, device="cpu", store=False)
    # 1 byte is int8 (the quantized products), a width the harness takes.
    r = autotune.autotune_gemm(64, 64, 64, 1, 4, device="cpu", store=False)
    assert r.in_bytes == 1 and r.plan.body == "fma"


def test_unported_parts_raise_and_name_their_roadmap_item():
    """Once the parts of ROADMAP item 10 still to port, which raised: the
    placed search, ``calibrate_ici`` and the end-to-end placed timings are
    ported now and tested in ``tests/test_torch_placed.py``.  What stays is
    the int8 fraction: a 1-byte result is fitted apart."""
    r = _tune(store=False)
    import dataclasses
    cal = autotune.calibrate([r, dataclasses.replace(r, in_bytes=1)],
                             store=False)
    assert cal.flops_frac_int8 is not None and cal.flops_frac_int8 > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.autotune_gemm(64, 64, 64)


def test_estimate_of_the_measured_problem_is_the_plans():
    """With no scaling and no calibration, est_measured is the winner's own
    estimate: the autotuner prices a plan as the planner does."""
    kw = dict(top_k=4, repeats=1, device="cpu", store=False)
    for r in (_tune(top_k=4, store=False),
              autotune.autotune_gemm(4, 2048, 512, 2, 2, panels=2, **kw),
              autotune.autotune_batched_gemm(32, 4, 128, 96, 4, 4,
                                             trans="nt", **kw),
              autotune.autotune_ragged_gemm(16, 4, 256, 512, 2, 2, **kw),
              autotune.autotune_ragged_gemm(16, 256, 256, 512, 2, 2,
                                            ragged="k", **kw)):
        assert r.measured_dims == r.dims
        assert r.est_measured == r.plan.est


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

def _synthetic_samples(factor, shapes):
    out = []
    for m, k, n in shapes:
        p = tuner.argmin_plan(tuner.gemm_candidates(m, k, n, 2, 2))
        out.append((p.est, p.est.t_total * factor))
    return out


def test_calibration_tightens_prediction_on_heldout():
    shapes = [(20000, 999, 31), (4096, 4096, 128), (63, 4097, 130),
              (1 << 16, 64, 32), (32, 1 << 16, 32), (8192, 8192, 96)]
    fit = _synthetic_samples(3.0, shapes[::2])
    hold = _synthetic_samples(3.0, shapes[1::2])
    cal = autotune.fit_calibration(fit)
    before = autotune.prediction_error(hold)
    after = autotune.prediction_error(hold, cal.flops_frac, cal.bw_frac)
    assert after < before
    assert after < 1.5
    assert abs(autotune.geomean_ratio(hold, cal.flops_frac, cal.bw_frac)
               - 1.0) < 0.5


def test_calibration_flows_into_default_planning(tmp_path):
    cal = autotune.calibrate([_tune()])
    assert cal.base_spec == H100.name
    spec = tuner.effective_spec(H100)
    assert spec is not H100 and spec.name.endswith("+cal")
    assert spec.hbm_bw == pytest.approx(H100.hbm_bw * cal.bw_frac)
    path = tmp_path / "plans.json"
    autotune.save_plan_cache(str(path))
    autotune.clear_plan_store()
    assert tuner.effective_spec(H100) is H100
    autotune.load_plan_cache(str(path))
    assert tuner.effective_spec(H100).name.endswith("+cal")
    custom = H100.calibrated(1.0, 1.0)
    assert tuner.effective_spec(custom) is custom


def test_recalibration_composes_instead_of_collapsing():
    r1 = _tune()
    autotune.calibrate([r1])
    r2 = _tune()        # tuned with the calibration installed
    assert r2.est_measured.t_total == pytest.approx(
        r1.est_measured.t_total, rel=1e-6)
    cal2 = autotune.calibrate([r1, r2])
    assert plan_store.get_store().calibration is cal2
    # The CPU is nowhere near the card's rates: the fit stays far from 1.
    assert min(cal2.flops_frac, cal2.bw_frac) < 0.5


def test_calibrated_estimates_scale():
    e0 = estimate(4096, 4096, 128, bm=128, bn=128, bk=16)
    spec = H100.calibrated(0.5, 0.25)
    e1 = estimate(4096, 4096, 128, bm=128, bn=128, bk=16, spec=spec)
    assert e1.t_compute == pytest.approx(e0.t_compute / 0.5)
    assert e1.t_memory == pytest.approx(e0.t_memory / 0.25)
    assert spec.smem_per_block == H100.smem_per_block


def test_reset_store_does_not_rearm_env_autoload(tmp_path, monkeypatch):
    path = tmp_path / "plans.json"
    _tune()
    autotune.save_plan_cache(str(path))
    monkeypatch.setenv(plan_store.ENV_VAR, str(path))
    importlib.reload(plan_store)        # a fresh process: auto-load armed
    tuner.clear_planner_caches()
    try:
        assert tuner.plan_gemm(*SHAPE, 2, 2).mode == "cached"
        autotune.clear_plan_store()
        assert len(plan_store.get_store()) == 0
        assert tuner.plan_gemm(*SHAPE, 2, 2).mode == "analytic"
    finally:
        monkeypatch.delenv(plan_store.ENV_VAR)
        importlib.reload(plan_store)


# ---------------------------------------------------------------------------
# Telemetry, the one-entry-point reset, the shared enumeration
# ---------------------------------------------------------------------------

def test_plan_mode_stats_counts_cached_and_quarantined(tmp_path):
    _tune()
    a = torch.randn(SHAPE[0], SHAPE[1]).to(BF16)
    dispatch.matmul(a, torch.randn(SHAPE[1], SHAPE[2]).to(BF16))
    path = tmp_path / "plans.json"
    blob = {"schema": 1, "device_kind": "cpu", "entries": {
        "dense|64x64x64|ib4|ob4": {"bm": 128, "bn": 128, "bk": 512},
        "batched|2x64x64x64|ib4|ob4|shared:none": {"bm": 256, "bn": 128,
                                                   "bk": 128},
        "ragged|2x64x64x64|ib2|ob2|ragged:m": {"bm": 16, "bn": 32,
                                               "bk": 64}}}
    path.write_text(json.dumps(blob))
    assert autotune.load_plan_cache(str(path)) == 1
    stats = tuner.plan_mode_stats()
    assert stats["dense"] == {"cached": 1, "quarantined": 1}
    assert stats["batched"] == {"quarantined": 1}
    assert "ragged" not in stats


def test_clear_plan_cache_clears_every_layer():
    autotune.calibrate([_tune()])
    dispatch.matmul(torch.ones(8, 16), torch.ones(16, 8))
    assert tuner.plan_gemm.cache_info().currsize > 0
    assert len(plan_store.get_store()) > 0 and tuner.PLAN_MODE_COUNTS
    tuner.clear_plan_cache()
    for f in (tuner.plan_gemm, tuner.plan_batched_gemm,
              tuner.plan_ragged_gemm, tuner.plan_moe_dispatch):
        assert f.cache_info().currsize == 0
    st = plan_store.get_store()
    assert len(st) == 0 and st.calibration is None and not st.quarantined
    assert not tuner.PLAN_MODE_COUNTS and not tuner.EPILOGUE_COUNTS


def test_shortlist_leads_with_analytic_argmin():
    cands = tuner.gemm_candidates(4, 2048, 6144, 2, 2)
    sl = tuner.shortlist(cands, 4)
    best = tuner.argmin_plan(cands)
    assert sl[0] is best and len(sl) == 4
    sigs = [(c.body, c.bm, c.bn, c.bk, c.kslices, c.dim_order) for c in sl]
    assert len(sigs) == len(set(sigs))


@pytest.mark.parametrize("shape", [(1 << 20, 64, 32, 4), (32, 1 << 20, 32, 4),
                                   (4, 2048, 6144, 2), (1024, 2048, 2048, 2)])
def test_planners_agree_with_shared_enumeration(shape):
    m, k, n, w = shape
    p = tuner.plan_gemm(m, k, n, w, w)
    best = tuner.argmin_plan(tuner.gemm_candidates(m, k, n, w, w))
    assert p == best and p.mode == "analytic"


# ---------------------------------------------------------------------------
# Dispatch, serving and the launcher
# ---------------------------------------------------------------------------

def test_cached_unfused_plan_gives_the_fused_result():
    m, k, n = 64, 96, 80
    g = torch.Generator().manual_seed(0)
    a = torch.randn(m, k, generator=g).to(BF16)
    b = torch.randn(k, n, generator=g).to(BF16)
    bias = torch.randn(n, generator=g).to(BF16)
    res = torch.randn(m, n, generator=g).to(BF16)
    epi = Epilogue(bias=True, activation="gelu", residual=True, scale=0.5)
    fused = dispatch.matmul(a, b, epilogue=epi, bias=bias, residual=res)
    plan = tuner.plan_gemm(m, k, n, 2, 2)
    plan_store.get_store().put(tuner.dense_key(m, k, n, 2, 2), {
        "body": plan.body, "bm": plan.bm, "bn": plan.bn, "bk": plan.bk,
        "dim_order": plan.dim_order, "fuse": False}, "cpu")
    tuner.clear_planner_caches()
    tuner.EPILOGUE_COUNTS.clear()
    unfused = dispatch.matmul(a, b, epilogue=epi, bias=bias, residual=res)
    assert tuner.plan_gemm(m, k, n, 2, 2).fuse is False
    assert tuner.epilogue_stats() == {"dense": {"separate": 1}}
    err = (unfused.float() - fused.float()).abs().max().item()
    assert err <= 2e-2 * fused.float().abs().max().item()


def test_cached_split_k_record_reaches_the_split_k_kernel(monkeypatch):
    m, k, n = 256, 1024, 384        # op(A)^T . dy, a dW product ("tn")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(k, m, generator=g).to(BF16)
    dy = torch.randn(k, n, generator=g).to(BF16)
    plan_store.get_store().put(
        tuner.dense_key(m, k, n, 2, 2, trans="tn"),
        {"body": "tc", "bm": 128, "bn": 128, "bk": 64, "dim_order": "mn",
         "nsplit": 4}, "cpu")
    tuner.clear_planner_caches()
    calls = []
    real = K.ftimm_gemm_splitk
    monkeypatch.setattr(K, "ftimm_gemm_splitk", lambda *a, **kw: (
        calls.append(kw), real(*a, **kw))[1])
    got = dispatch.matmul(x, dy, trans="tn")
    assert [c["nsplit"] for c in calls] == [4] and calls[0]["body"] == "tc"
    want = K.ftimm_gemm_plain(x, dy, trans="tn", out_dtype=BF16)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item()
    assert tuner.plan_mode_stats()["dense"] == {"cached": 1}


def test_cost_model_counts_store_hits():
    from repro_torch.configs import get_config
    from repro_torch.serve.buckets import CostModel, gemm_signatures
    cfg = get_config("qwen3-1.7b-smoke")
    w = getattr(torch, cfg.compute_dtype).itemsize
    m, k, n = gemm_signatures(cfg, 2)[1]
    autotune.autotune_gemm(m, k, n, w, w, top_k=1, repeats=1, device="cpu")
    cm = CostModel(cfg, (8,), 2)
    assert cm.store_lookups > 0 and cm.store_hits >= 1
    snap = cm.snapshot()
    assert snap["store_hits"] == cm.store_hits


def test_launcher_loads_the_plan_cache_in_order(tmp_path, monkeypatch,
                                                capsys):
    from repro_torch.launch import serve
    _tune()
    explicit, env = tmp_path / "explicit.json", tmp_path / "env.json"
    autotune.save_plan_cache(str(explicit))
    env.write_text("{ torn")
    autotune.clear_plan_store()
    monkeypatch.setenv(plan_store.ENV_VAR, str(env))
    assert serve.load_plan_cache(str(explicit)) == 1
    assert "1 measured plans adopted" in capsys.readouterr().out
    autotune.clear_plan_store()
    assert serve.load_plan_cache(None) == 0     # the env file, torn
    assert str(env) in capsys.readouterr().out
    monkeypatch.delenv(plan_store.ENV_VAR)
    autotune.clear_plan_store()
    serve.load_plan_cache(None)                 # the repo's TPU file
    out = capsys.readouterr().out
    assert "0 measured plans adopted" in out and "quarantined" in out
    assert tuner.effective_spec(H100) is H100


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("dense", (20000, 999, 31), 4, 4, 1, "", None),
    ("dense", (128, 4096, 6144), 2, 2, 1, "", 1),
    ("batched", (8, 16, 4096, 14336), 2, 2, 1, "shared:none", None),
    ("batched", (32, 4, 128, 96), 4, 4, 1, "shared:a", None),
    ("ragged", (16, 1024, 5120, 8192), 2, 2, 1, "ragged:m", None),
    ("ragged", (16, 1024, 5120, 8192), 2, 2, 1, "ragged:k", 1),
    ("dense", (1 << 14, 64, 32), 4, 4, 4, "", None),
])
def test_shape_key_matches_the_reference(case):
    from repro.core.gemm import plan_store as jstore
    from repro.core.gemm import tuner as jtuner
    family, dims, ib, ob, shards, base, b_bytes = case
    extra = jtuner._dtype_extra(b_bytes, base)
    assert tuner.key_extra(base, in_bytes=ib, b_bytes=b_bytes) == extra
    assert plan_store.shape_key(family, dims, ib, ob, shards, extra) == \
        jstore.shape_key(family, dims, ib, ob, shards, extra)


def test_calibration_fit_matches_the_reference():
    from repro.core.gemm import autotune as jauto
    rng = np.random.default_rng(0)

    class Est:
        def __init__(self, tc, tm):
            self.t_compute, self.t_memory = tc, tm

    samples = [(Est(tc, tm), meas) for tc, tm, meas in
               10.0 ** rng.uniform(-6, -3, size=(12, 3))]
    for ff, bf in ((1.0, 1.0), (0.3, 0.7), (2.0, 0.05)):
        for name in ("prediction_error", "geomean_ratio"):
            got = getattr(autotune, name)(samples, ff, bf)
            want = getattr(jauto, name)(samples, ff, bf)
            assert got == pytest.approx(want, rel=1e-12)
    got, want = (autotune.fit_calibration(samples),
                 jauto.fit_calibration(samples))
    assert got.flops_frac == pytest.approx(want.flops_frac, rel=1e-12)
    assert got.bw_frac == pytest.approx(want.bw_frac, rel=1e-12)
    assert got.n_samples == want.n_samples == 12
    assert got.base_spec == H100.name


_EPILOGUES = [dict(bias=b, residual=r, scale_vec=v, activation=a, scale=s)
              for b, r, v, a, s in itertools.product(
                  (False, True), (False, True), (False, True),
                  ("none", "silu", "gelu"), (None, 0.5))]


@pytest.mark.parametrize("flags", _EPILOGUES,
                         ids=lambda f: "-".join(f"{k}={v}"
                                                for k, v in f.items()))
def test_epilogue_helpers_match_the_reference(flags):
    import jax.numpy as jnp
    from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue
    epi, jepi = Epilogue(**flags), JEpilogue(**flags)
    assert epi.num_ops == jepi.num_ops
    fields = ("bias", "residual", "scale_vec", "activation", "scale")
    assert [tuple(getattr(e, f) for f in fields) for e in epi.decompose()] \
        == [tuple(getattr(e, f) for f in fields) for e in jepi.decompose()]
    extras = tuple(name for name, on in (("b", flags["bias"]),
                                         ("r", flags["residual"]),
                                         ("s", flags["scale_vec"])) if on)
    assert epi.unpack(extras) == jepi.unpack(extras)
    rng = np.random.default_rng(3)
    acc = rng.standard_normal((5, 7)).astype(np.float32)
    bias, scale = (rng.standard_normal(7).astype(np.float32)
                   for _ in range(2))
    res = rng.standard_normal((5, 7)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (acc, bias, res, scale)]
    z = t[0]
    for op in epi.decompose():
        z = op.apply(z, bias=t[1], residual=t[2], scale=t[3])
    whole = epi.apply(t[0], bias=t[1], residual=t[2], scale=t[3])
    assert torch.allclose(z, whole, rtol=0, atol=1e-6)
    want = np.asarray(jepi.apply(jnp.asarray(acc), bias=jnp.asarray(bias),
                                 residual=jnp.asarray(res),
                                 scale=jnp.asarray(scale)))
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-5, atol=1e-5)


def test_a_store_written_by_the_reference_loads_in_the_port(tmp_path):
    from repro.core.gemm import plan_store as jstore
    JCal = jstore.Calibration
    st = jstore.PlanStore()
    st.put("dense|128x4096x6144|ib4|ob4",
           {"bm": 128, "bn": 128, "bk": 4096, "dim_order": "mn"})
    st.put("dense|64x64x64|ib4|ob4",
           {"bm": 128, "bn": 128, "bk": 128, "edge": "padded"})
    st.put("dense|300x200x96|ib4|ob4",
           {"bm": 16, "bn": 32, "bk": 64, "dim_order": "nm"})
    st.calibration = JCal(flops_frac=0.01, bw_frac=0.02, n_samples=3,
                          engine="xla", base_spec="tpu_v5e")
    path = str(tmp_path / "jax_plans.json")
    st.save(path)
    assert json.loads(pathlib.Path(path).read_text())["device_kind"] == "cpu"
    assert autotune.load_plan_cache(path) == 1
    store = plan_store.get_store()
    assert store.quarantined == {
        "dense|128x4096x6144|ib4|ob4": ["tile_not_compiled",
                                        "smem_over_budget"],
        "dense|64x64x64|ib4|ob4": ["edge_padded", "tile_not_compiled"]}
    assert store.calibration.base_spec == "tpu_v5e"
    assert tuner.effective_spec(H100) is H100     # not applied
    p = tuner.plan_gemm(300, 200, 96, 4, 4)
    assert (p.mode, p.body, p.bm, p.bn, p.bk, p.dim_order) == \
        ("cached", "fma", 16, 32, 64, "nm")
    assert tuner.plan_gemm(128, 4096, 6144, 4, 4).mode == "analytic"


def test_a_candidate_replaces_the_analytic_plan_only_beyond_the_tie_band(
        monkeypatch):
    sl = tuner.shortlist(tuner.gemm_candidates(4, 2048, 6144, 2, 2), 3)
    for times, want in (([1.0, 0.99, 1.2], 0), ([1.0, 0.97, 0.975], 1),
                        ([1.0, 1.0, 1.0], 0), ([1.0, 2.0, 0.5], 2)):
        it = iter(times)
        monkeypatch.setattr(autotune, "_time", lambda *a: next(it))
        got = autotune._measure_shortlist(
            sl, lambda c: ((c.body, c.bm, c.bk, c.kslices), None), [], 1)
        assert (got, autotune._winner(got)) == (times, want)


def test_the_card_times_and_stores_the_served_shape_only():
    """No default budget on the card: a scaled K or M changes the bodies
    and K slices a shape allows, so a winner timed at another shape is
    never stored for the served one."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    dims = (4, 6144, 2048)
    assert autotune._scale_dense(*dims, autotune._budget(cuda, None)) == dims
    scaled = autotune._scale_dense(*dims, autotune._budget(cpu, None))
    assert scaled == (4, 4096, 2048)
    autotune._check_served(cpu, True, "k", dims, scaled)
    autotune._check_served(cuda, False, "k", dims, scaled)
    with pytest.raises(ValueError, match="not stored"):
        autotune._check_served(cuda, True, "k", dims, scaled)
    autotune._check_served(cuda, True, "k", dims, dims)
