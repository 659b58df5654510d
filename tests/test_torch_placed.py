"""The placed side of the planner on the CPU, held against the JAX package:

  * the perf model's expert-parallel terms: ``step_perf(ep_shards=)``'s
    ``moe_a2a`` bucket equals the reference's for both MoE archs, train and
    decode; ``plan_moe_dispatch(num_shards=, axis=)`` attaches the
    expert-parallel placement of two H100 ``estimate_ep`` legs;
  * the measured placed search: ``_placed_total`` and the margin choice
    against the reference's on fixed inputs; a placed
    ``autotune_gemm(num_shards=4)`` (and the batched and ragged ones)
    stored, saved, loaded and served as "cached"; ``effective_spec``
    applying a fitted ``ici_frac``;
  * ``calibrate_ici`` with and without ``store`` and both
    ``time_placed_*_e2e`` on a 2-rank gloo world of CPU ranks.
"""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.gemm import autotune as jautotune  # noqa: E402
from repro.core.gemm import tuner as jtuner  # noqa: E402
from repro.roofline import perf_model as jperf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.gemm import autotune, plan_store, tuner  # noqa: E402
from repro_torch.core.gemm.cmr import H100, estimate_ep  # noqa: E402
from repro_torch.roofline import step_perf  # noqa: E402
from repro_torch.roofline import __main__ as roofline_main  # noqa: E402
from torch_world import World  # noqa: E402

MOE_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
SHAPES = (("train", 4096, 8), ("decode", 80, 4))


@pytest.fixture(autouse=True)
def _clean_store(monkeypatch):
    monkeypatch.delenv(plan_store.ENV_VAR, raising=False)
    tuner.clear_plan_cache()
    yield
    tuner.clear_plan_cache()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world"), timeout=180)
    yield w
    w.close()


# ---------------------------------------------------------------------------
# The perf model's expert-parallel terms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kind,seq,batch", SHAPES)
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_moe_a2a_bytes_match_jax(arch, kind, seq, batch, shards):
    """The ``moe_a2a`` interconnect bytes of a whole step (the train
    multiplier included) equal the reference's, and stay out of the
    device-memory totals."""
    got = step_perf(get_config(arch), ShapeConfig("s", seq, batch, kind),
                    ep_shards=shards)
    want = jperf.step_perf(jget_config(arch), JShape("s", seq, batch, kind),
                           ep_shards=shards)
    g, w = got.breakdown["moe_a2a"], want.breakdown["moe_a2a"]
    assert g[2] > 0 and g[2] == pytest.approx(w[2], rel=1e-12)
    assert g[0] == 0 and g[1] == 0
    assert got.bytes_ici == pytest.approx(want.bytes_ici, rel=1e-12)
    one = step_perf(get_config(arch), ShapeConfig("s", seq, batch, kind))
    assert "moe_a2a" not in one.breakdown and one.bytes_ici == 0
    assert got.bytes_hbm == one.bytes_hbm and got.flops == one.flops


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("shards", [2, 8])
def test_plan_moe_dispatch_attaches_the_ep_placement(dispatch, shards):
    """Two ``estimate_ep`` legs at d_model width over NVLink; one device
    attaches none; the rows are the unplaced ones."""
    args = (1024, 8, 2, 4096, 14336)
    plan = tuner.plan_moe_dispatch(*args, dispatch=dispatch,
                                   num_shards=shards, axis="data")
    leg = estimate_ep(plan.rows, 4096, shards, elt_bytes=2, spec=H100)
    p = plan.placement
    assert (p.strategy, p.num_shards, p.axis) == ("expert_parallel", shards,
                                                  "data")
    assert p.t_collective == pytest.approx(2 * leg.t_exchange, rel=1e-12)
    assert p.link_bytes == pytest.approx(2 * leg.link_bytes, rel=1e-12)
    flat = tuner.plan_moe_dispatch(*args, dispatch=dispatch)
    assert flat.placement is None and flat.rows == plan.rows


def test_roofline_cli_carries_ep_shards(capsys):
    roofline_main.main(["--arch", "llama4-scout-17b-a16e", "--layers", "2",
                        "--ep-shards", "2"])
    out = capsys.readouterr().out
    assert "moe_a2a" in out and "interconnect" in out
    want = step_perf(dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                                         num_layers=2),
                     ShapeConfig("d", 80, 4, "decode"), ep_shards=2)
    assert f'"bytes_per_device_ici": {want.bytes_ici}' in out
    assert '"t_collective": 0.0' in out


# ---------------------------------------------------------------------------
# The measured placed search
# ---------------------------------------------------------------------------

def _placement(strategy="m_parallel", schedule="gather", t_coll=0.0,
               waste=1.0):
    return types.SimpleNamespace(strategy=strategy, schedule=schedule,
                                 t_collective=t_coll, waste=waste)


@pytest.mark.parametrize("schedule", ["gather", "ring"])
@pytest.mark.parametrize("t_local,t_coll,waste", [
    (1e-3, 2e-4, 1.0), (1e-4, 5e-4, 1.25), (3e-5, 3e-5, 2.0)])
def test_placed_total_matches_jax(schedule, t_local, t_coll, waste):
    p = _placement(schedule=schedule, t_coll=t_coll, waste=waste)
    assert autotune._placed_total(t_local, p) == pytest.approx(
        jautotune._placed_total(t_local, p), rel=0)


@pytest.mark.parametrize("totals,margins", [
    ((1.0, 0.9, 0.8), (1.0, 1.15, 1.15)),
    ((1.0, 0.85, 0.95), (1.0, 1.15, 1.15)),
    ((1.0, 0.5, 0.6), (1.0, 1.1, 1.1)),
    ((2.0, 2.5, 1.0), (1.0, 1.1, 1.1)),
    ((1.0, 0.95, 0.92), (1.0, 1.15, 1.15))])
def test_margin_choice_matches_the_analytic_placer(totals, margins):
    """The option ``tuner.pick_placed`` takes is the one the reference's
    ``_select_placed`` takes from the same (option, plan) pairs."""
    opts = [types.SimpleNamespace(margin=m) for m in margins]
    plans = [types.SimpleNamespace(t_total=t) for t in totals]
    want = jtuner._select_placed(list(zip(opts, plans)))
    got = tuner.pick_placed(list(zip(opts, totals)))
    assert plans[got] is want


def test_placed_measured_roundtrip(tmp_path):
    """As the reference's ``test_placed_measured_roundtrip``: a placed
    search on the CPU, stored, saved, reloaded into a fresh store and
    served as "cached" with the winner's strategy and schedule."""
    r = autotune.autotune_gemm(1 << 14, 64, 32, num_shards=4, top_k=2,
                               repeats=1, device="cpu", max_elements=1 << 14)
    assert r.plan.mode == "measured" and r.plan.placement is not None
    assert r.key.endswith("|shards4")
    assert r.t_measured > 0 and r.t_analytic > 0
    rec = plan_store.get_store().lookup(r.key)
    assert rec["strategy"] == r.plan.placement.strategy
    assert rec["schedule"] == r.plan.placement.schedule
    path = str(tmp_path / "plans.json")
    autotune.save_plan_cache(path)
    autotune.clear_plan_store()
    assert tuner.plan_gemm(1 << 14, 64, 32, num_shards=4).mode == "analytic"
    assert autotune.load_plan_cache(path) >= 1
    served = tuner.plan_gemm(1 << 14, 64, 32, num_shards=4)
    assert served.mode == "cached"
    assert served.placement.strategy == r.plan.placement.strategy
    assert served.placement.schedule == r.plan.placement.schedule
    assert (served.bm, served.bn, served.bk) == (r.plan.bm, r.plan.bn,
                                                 r.plan.bk)


@pytest.mark.parametrize("family", ["batched", "ragged"])
def test_batched_and_ragged_placed_roundtrip(family):
    kw = dict(num_shards=2, top_k=2, repeats=1, device="cpu",
              max_elements=1 << 16)
    if family == "batched":
        r = autotune.autotune_batched_gemm(8, 64, 64, 128, **kw)
        served = tuner.plan_batched_gemm(8, 64, 64, 128, num_shards=2)
    else:
        r = autotune.autotune_ragged_gemm(8, 1024, 64, 128, **kw)
        served = tuner.plan_ragged_gemm(8, 1024, 64, 128, num_shards=2)
    assert r.plan.placement is not None and served.mode == "cached"
    assert served.placement.strategy == r.plan.placement.strategy
    assert served.placement.schedule == r.plan.placement.schedule


def test_store_false_leaves_no_placed_record():
    r = autotune.autotune_gemm(512, 256, 64, num_shards=2, top_k=2,
                               repeats=1, device="cpu", store=False)
    assert plan_store.get_store().lookup(r.key) is None
    assert tuner.plan_gemm(512, 256, 64, num_shards=2).mode == "analytic"


def test_effective_spec_applies_a_fitted_ici_frac():
    st = plan_store.get_store()
    st.calibration = plan_store.Calibration(
        flops_frac=0.5, bw_frac=0.8, ici_frac=0.25, base_spec=H100.name)
    tuner.clear_planner_caches()
    spec = tuner.effective_spec(H100)
    assert spec.nvlink_bw_per_link == pytest.approx(
        H100.nvlink_bw_per_link * 0.25)
    assert spec.link_bw == pytest.approx(H100.link_bw * 0.25)
    assert spec.hbm_bw == pytest.approx(H100.hbm_bw * 0.8)
    placed = tuner.plan_moe_dispatch(1024, 8, 2, 4096, 14336, num_shards=2)
    st.calibration = None
    tuner.clear_planner_caches()
    nominal = tuner.plan_moe_dispatch(1024, 8, 2, 4096, 14336, num_shards=2)
    assert placed.placement.t_collective == pytest.approx(
        4 * nominal.placement.t_collective)


# ---------------------------------------------------------------------------
# On a 2-rank mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", [False, True])
def test_calibrate_ici_on_two_ranks(world, store):
    """The fitted fraction is finite and positive and the same on both
    ranks' terms; ``store`` installs it (the link rate scaled by it),
    ``store=False`` leaves the store without a calibration."""
    got = world.run("placed", "ici", store=store)
    for r in got:
        frac = r["cal"]["ici_frac"]
        assert math.isfinite(frac) and frac > 0
        assert r["cal"]["n_samples"] == 2
        if store:
            assert r["stored"]["ici_frac"] == frac
            assert r["link_bw"] == pytest.approx(H100.link_bw * frac)
        else:
            assert r["stored"] is None
            assert r["link_bw"] == H100.link_bw


@pytest.mark.parametrize("kind,rows", [
    ("ragged", [("single", "gather"), ("expert_parallel", "gather"),
                ("expert_parallel", "ring")]),
    ("dense", [("m_parallel", "gather"), ("k_parallel", "gather"),
               ("k_parallel", "ring")])])
def test_time_placed_e2e_row_layout(world, kind, rows):
    """The reference's rows, in its order: strategy, schedule, a measured
    time and the planner's modeled one, on every rank."""
    for got in world.run("placed", kind):
        assert [(r["strategy"], r["schedule"]) for r in got] == rows
        for r in got:
            assert set(r) == {"strategy", "schedule", "t_measured",
                              "t_model"}
            assert math.isfinite(r["t_measured"]) and r["t_measured"] > 0
            assert math.isfinite(r["t_model"]) and r["t_model"] > 0
