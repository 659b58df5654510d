"""The port's mesh executors, collectives, placement planner and placement
contracts, held against the JAX package on the CPU.

The executors run on a gloo world of 2 (and 4) CPU ranks (``torch_world``),
started once for this module on a ``file://`` store under the test's
temporary directory, every call with a timeout.  One H100 cannot test NCCL
across GPUs: these tests run the host transport, and the card's own checks
(``tests/test_torch_cuda.py -k dist``, ``chip_smoke.py`` [dist]) run gloo
with CUDA tensors and a one-rank NCCL world.

  * exchanges round-trip bitwise (identity panels) under the reference's
    distributions -- skewed, all rows on one expert, balanced, and the
    probe's -- T not a multiple of the rank count, both realizations and
    both schedules; ring equals gather (1e-5 forward, 1e-4 gradients);
  * ``ep_ragged_matmul`` / ``_swiglu`` / ``_moe`` forward and gradients
    against JAX's single-device ``ragged_matmul`` / ``ragged_swiglu``, and
    ``dist_matmul`` (its three modes, with an epilogue) and
    ``dist_batched_matmul`` against JAX's ``matmul`` / ``batched_matmul``,
    fp32 within 1e-5;
  * the ladder with a fault armed on every rank and on one rank only: the
    same rung everywhere, counted on every rank, no hang;
  * the planner's properties (reference ``tests/test_collective.py``,
    ``tests/test_placement.py``) on the port's H100 spec, and
    ``check_placement`` / ``check_record`` against the reference's codes.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import contracts as jcontracts  # noqa: E402
from repro.core.gemm import batched_matmul as j_batched  # noqa: E402
from repro.core.gemm import collective as jcollective  # noqa: E402
from repro.core.gemm import matmul as j_matmul  # noqa: E402
from repro.core.gemm import ragged_matmul as j_ragged  # noqa: E402
from repro.core.gemm import ragged_swiglu as j_swiglu  # noqa: E402
from repro.core.gemm import tuner as jtuner  # noqa: E402
from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro_torch.analysis import contracts  # noqa: E402
from repro_torch.core.gemm import (DistPlan, Placement, collective,  # noqa: E402
                                   plan_batched_gemm, plan_distributed,
                                   plan_gemm, plan_ragged_gemm, plan_store,
                                   preferred_ep_schedule, tuner)
from repro_torch.core.gemm.cmr import H100, estimate_ep  # noqa: E402
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh  # noqa: E402
from torch_world import World  # noqa: E402

SEED = 11


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    made = {}

    def get(n):
        w = made.get(n)
        if w is None or not w.alive:
            w = made[n] = World(n, tmp_path_factory.mktemp(f"world{n}"))
        return w

    yield get
    for w in made.values():
        w.close()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _offsets(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def _distributions(g, nc):
    """The reference's skewed / one-expert / balanced zoo
    (``tests/test_collective.py``) and the exchange probe's offsets."""
    skew = [0] * g
    skew[0] = 37
    for i in range(1, g):
        skew[i] = i % 3
    one = [0] * g
    one[g // 2] = 29
    probe = [0] * g
    for j, rows in enumerate(np.diff(collective._probe_offsets(nc, 3))):
        probe[j * (g // nc)] = int(rows)
    return {"skewed": skew, "one_expert": one, "balanced": [3] * g,
            "probe": probe}


def _rng(*key):
    return np.random.default_rng([SEED, *key])


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The planner and the contracts (no world)
# ---------------------------------------------------------------------------

def test_nvlink_term_is_the_data_sheet():
    assert H100.nvlink_links == 18
    assert H100.link_bw == pytest.approx(450e9)     # 900 GB/s both ways
    assert H100.calibrated(0.5, 0.5).link_bw == H100.link_bw


def test_estimate_ep_prices_bottleneck_shard():
    even = estimate_ep(1024, 64, 8)
    skew = estimate_ep(1024, 64, 8, max_shard_rows=1024)
    assert even.imbalance == 1.0
    assert skew.imbalance == pytest.approx(8.0)
    assert skew.link_bytes == even.link_bytes
    assert skew.t_exchange == pytest.approx(8 * even.t_exchange)
    both = even + skew
    assert both.imbalance == pytest.approx(8.0)
    assert both.t_exchange == pytest.approx(even.t_exchange
                                            + skew.t_exchange)


@pytest.mark.parametrize("rows,width,nc", [(4096, 1024, 4), (1024, 64, 8),
                                           (37, 5120, 2)])
def test_estimate_ep_bytes_match_reference(rows, width, nc):
    """The same bytes as the reference's ICI term; only the link rate
    differs (NVLink, not ICI)."""
    from repro.core.gemm.cmr import estimate_ep as jestimate_ep
    mine = estimate_ep(rows, width, nc, elt_bytes=2)
    ref = jestimate_ep(rows, width, nc, elt_bytes=2)
    assert mine.link_bytes == pytest.approx(ref.ici_bytes)
    assert mine.t_exchange == pytest.approx(
        mine.link_bytes / nc / H100.link_bw)
    assert estimate_ep(rows, width, 1).t_exchange == 0.0


def test_plan_t_total_schedule_composition():
    plan = plan_ragged_gemm(8, 512, 64, 64)
    local = plan.est.t_total

    def mk(s):
        return replace(plan, placement=Placement(
            "expert_parallel", 8, t_collective=5 * local, schedule=s))

    assert mk("gather").t_total == pytest.approx(local + 5 * local)
    assert mk("ring").t_total == pytest.approx(5 * local)
    assert mk("gather").strategy == "expert_parallel"
    assert plan.strategy == "single"


def test_unplaced_plans_carry_no_placement():
    for p in (plan_gemm(4096, 512, 64), plan_batched_gemm(8, 256, 64, 128),
              plan_ragged_gemm(8, 1024, 64, 128)):
        assert p.placement is None and p.strategy == "single"
        assert p.t_total == p.est.t_total
    assert plan_gemm(4096, 512, 64) == plan_gemm(4096, 512, 64, num_shards=1)


def test_placed_plan_decomposes_per_schedule():
    p = plan_ragged_gemm(64, 512, 2048, 2048, 2, 2, num_shards=8)
    pl = p.placement
    if pl.schedule == "ring":
        assert p.t_total == pytest.approx(
            max(p.est.t_total * pl.waste, pl.t_collective))
    else:
        assert p.t_total == pytest.approx(
            p.est.t_total * pl.waste + pl.t_collective)


def test_dense_placed_strategy_crossover():
    """K-parallel iff M and N are small and K large (paper Sec. IV-C); on a
    boundary shape only the ring schedule may take the win from m_parallel
    -- the reference's cases."""
    assert plan_gemm(2**20, 64, 32,
                     num_shards=8).placement.strategy == "m_parallel"
    p = plan_gemm(32, 2**20, 32, num_shards=8)
    assert p.placement.strategy == "k_parallel"
    assert p.placement.t_collective > 0 and p.placement.link_bytes > 0
    b = plan_gemm(20480, 20480, 32, num_shards=8).placement
    assert (b.strategy, b.schedule) in (("m_parallel", "gather"),
                                        ("k_parallel", "ring"))


def test_plan_distributed_is_the_placed_plan():
    d = plan_distributed(32, 2**20, 32, 8)
    p = plan_gemm(32, 2**20, 32, num_shards=8)
    assert isinstance(d, DistPlan)
    assert d.strategy == p.placement.strategy == "k_parallel"
    assert d.t_total == p.t_total
    assert d.t_collective == p.placement.t_collective
    assert d.num_cores == 8
    assert d.local.kernel_kwargs() == p.kernel_kwargs()
    one = plan_distributed(64, 64, 64, 1)
    assert one.strategy == "m_parallel" and one.num_cores == 1


def test_ep_only_when_exchange_amortized():
    p = plan_ragged_gemm(64, 512, 2048, 2048, 2, 2, num_shards=8)
    assert p.placement.strategy == "expert_parallel"
    assert p.placement.t_collective > 0 and p.placement.link_bytes > 0
    p = plan_ragged_gemm(8, 1 << 20, 256, 256, 2, 2, num_shards=8)
    assert p.placement.strategy == "m_parallel"
    assert p.placement.t_collective == 0.0
    p = plan_batched_gemm(64, 64, 2048, 2048, 2, 2, "none", num_shards=8)
    assert p.placement.strategy == "expert_parallel"
    p = plan_batched_gemm(4, 1 << 18, 256, 256, 2, 2, "none", num_shards=8)
    assert p.placement.strategy == "m_parallel"


def test_kernel_kwargs_unchanged_by_placement():
    p = plan_ragged_gemm(64, 512, 2048, 2048, 2, 2, num_shards=8)
    g, total = (8, 128) if p.placement.schedule == "ring" else (8, 512)
    assert p.kernel_kwargs() == plan_ragged_gemm(g, total, 2048, 2048, 2,
                                                 2).kernel_kwargs()


def test_preferred_ep_schedule_serial_evaluation():
    """One shard is gather; ranks that share one device (``serial`` = nc)
    flip the reference's MoE shape to ring, whose product covers only the
    owned rows."""
    tuner.clear_planner_caches()
    assert preferred_ep_schedule(8, 1024, 128, 256, num_shards=1) == "gather"
    assert preferred_ep_schedule(8, 1024, 128, 256, 4, 4, num_shards=8,
                                 serial=8) == "ring"
    assert preferred_ep_schedule(8, 1024, 128, 256, 4, 4,
                                 num_shards=8) in ("gather", "ring")


def test_ragged_placement_offers_both_schedules():
    opts = tuner.ragged_placement_options(8, 1024, 128, 256, 8)
    scheds = {(o.placement.strategy, o.placement.schedule) for o in opts}
    assert ("expert_parallel", "ring") in scheds
    assert ("expert_parallel", "gather") in scheds
    dw = tuner.ragged_placement_options(8, 1024, 128, 256, 8, ragged="k")
    assert [o.placement.strategy for o in dw] == ["expert_parallel"]


def test_placed_record_served_from_the_store():
    """A measured placed record (strategy, schedule, local tile) under the
    ``|shardsN`` key is served as ``cached``; one naming no option's
    candidate is not."""
    tuner.clear_plan_cache()
    analytic = plan_gemm(32, 1 << 16, 32, num_shards=4)
    local = analytic.placement
    key = plan_store.shape_key("dense", (32, 1 << 16, 32), 4, 4,
                               num_shards=4)
    rec = {"bm": analytic.bm, "bn": analytic.bn, "bk": analytic.bk,
           "body": analytic.body, "kslices": analytic.kslices,
           "strategy": "k_parallel", "schedule": "gather"}
    plan_store.get_store().put(key, rec)
    tuner.clear_planner_caches()
    try:
        p = plan_gemm(32, 1 << 16, 32, num_shards=4)
        assert p.mode == "cached"
        assert (p.placement.strategy, p.placement.schedule) == (
            "k_parallel", "gather")
        assert p.placement.num_shards == local.num_shards
    finally:
        tuner.clear_plan_cache()


CONTRACT_CASES = [
    ("ragged", (8, 512, 64, 64), "expert_parallel", 4, "ring"),
    ("ragged", (8, 512, 64, 64), "m_parallel", 4, "ring"),
    ("dense", (512, 512, 512), "k_parallel", 4, "spiral"),
    ("ragged", (8, 1024, 256, 256), "expert_parallel", 3, "gather"),
    ("ragged", (8, 1024, 256, 256), "expert_parallel", 4, "gather"),
    ("dense", (512, 512, 512), "expert_parallel", 4, "gather"),
    ("batched", (6, 64, 64, 64), "k_parallel", 2, "gather"),
    ("dense", (512, 4096, 512), "k_parallel", 8, "ring"),
    ("dense", (512, 512, 512), "bogus", 2, "gather"),
    ("batched", (6, 64, 64, 64), "expert_parallel", 4, "gather"),
]


@pytest.mark.parametrize("case", CONTRACT_CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}-{c[4]}"
                              for c in CONTRACT_CASES])
def test_check_placement_matches_reference(case):
    family, dims, strategy, nshards, schedule = case
    mine = contracts.check_placement(
        family, dims, Placement(strategy, nshards, schedule=schedule))
    ref = jcontracts.check_placement(
        family, dims, jtuner.Placement(strategy, nshards, schedule=schedule))
    assert ([v.code for v in contracts.errors(mine)]
            == [v.code for v in jcontracts.errors(ref)])


def test_kparallel_overshard_warns():
    v = contracts.check_placement("dense", (512, 128, 512),
                                  Placement("k_parallel", 8))
    assert [x.code for x in v] == ["kparallel_overshard"]
    assert not contracts.errors(v)


def test_placed_plans_pass_check_plan():
    for fam, dims, p in (
            ("dense", (32, 1 << 20, 32), plan_gemm(32, 1 << 20, 32,
                                                   num_shards=8)),
            ("ragged", (64, 512, 2048, 2048),
             plan_ragged_gemm(64, 512, 2048, 2048, 2, 2, num_shards=8))):
        assert p.placement.num_shards == 8
        assert not contracts.errors(contracts.check_placement(
            fam, dims, p.placement))
    bad = replace(plan_ragged_gemm(8, 512, 64, 64),
                  placement=Placement("expert_parallel", 3))
    assert "ep_indivisible" in [v.code for v in contracts.check_plan(
        "ragged", (8, 512, 64, 64), bad)]


RECORD_CASES = [
    ({"strategy": "k_parallel", "schedule": "ring"}, "dense", (512, 1024, 512)),
    ({"strategy": "k_parallel", "schedule": "spiral"}, "dense",
     (512, 1024, 512)),
    ({"strategy": "m_parallel", "schedule": "ring"}, "dense", (512, 1024, 512)),
    ({"strategy": "expert_parallel"}, "ragged", (6, 512, 64, 64)),
    ({"strategy": "expert_parallel", "schedule": "ring"}, "ragged",
     (8, 512, 64, 64)),
    ({}, "dense", (512, 1024, 512)),
]


@pytest.mark.parametrize("i", range(len(RECORD_CASES)))
def test_sharded_record_rules_match_reference(i):
    extra, family, dims = RECORD_CASES[i]
    key = plan_store.shape_key(family, dims, 4, 4, num_shards=4,
                               extra="ragged:m" if family == "ragged" else "")
    tile = K.GROUP_TC_TILE if family == "ragged" else K.TC_TILES[0]
    rec = {"bm": tile[0], "bn": tile[1], "bk": tile[2], "body": "tc", **extra}
    mine = [v.code for v in contracts.errors(contracts.check_record(key, rec))]
    ref = [v.code for v in jcontracts.errors(jcontracts.check_record(
        key, {**rec, "bm": 128, "bn": 128, "bk": 128}))]
    assert mine == ref
    st = plan_store.PlanStore()
    st.put(key, rec)
    assert st.entries[key].get("schedule") == rec.get("schedule")


def test_probe_offsets_end_at_t_with_an_empty_window():
    """The reference's construction for nc >= 3; on two ranks the
    reference's leaves row T - 1 unowned (ROADMAP Queue 3), the port's
    ends at T with the second window empty."""
    for nc in (3, 4, 8):
        np.testing.assert_array_equal(collective._probe_offsets(nc, 2),
                                      jcollective._probe_offsets(nc, 2))
    for nc in (2, 3, 4, 8):
        off = collective._probe_offsets(nc, 2)
        assert off[-1] == 2 * nc and (np.diff(off) == 0).any()
    assert jcollective._probe_offsets(2, 2)[-1] == 3


def test_meshes_without_a_world():
    m = Mesh.abstract((1, 2), ("data", "model"))
    assert m.shape == {"data": 1, "model": 2} and m.size == 2
    assert m.axis_size(("data", "model")) == 2 and m.backend is None
    with pytest.raises(RuntimeError, match="abstract"):
        m.group("model")
    with pytest.raises(ValueError, match="mesh order"):
        m.axes(("model", "data"))
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((2,), ("x",), backend="gloo", device="cpu")


# ---------------------------------------------------------------------------
# The mesh and the collectives on a world
# ---------------------------------------------------------------------------

def test_mesh_on_a_2x2_world(worlds):
    """Ranks map row-major onto (data, model); each axis's group gathers
    only along it; the transport is the host's."""
    w = worlds(4)
    info = w.run("info")
    assert [i["coords"] for i in info] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert {i["transport"] for i in info} == {"host"}
    x = np.zeros((1, 2), np.float32)
    got = w.run("gather_along", x, (2, 2), ("data", "model"), "model")
    assert [g[:, 0].tolist() for g in got] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    got = w.run("gather_along", x, (2, 2), ("data", "model"), "data")
    assert [g[:, 0].tolist() for g in got] == [[0, 2], [1, 3], [0, 2], [1, 3]]


ROUNDTRIP = [(nc, sched, a2a, dist) for nc in (2, 4)
             for sched in ("gather", "ring") for a2a in ("dense", "primitive")
             for dist in ("skewed", "one_expert", "balanced", "probe")]


@pytest.mark.parametrize("nc,schedule,a2a,dist", ROUNDTRIP,
                         ids=[f"{n}r-{s}-{a}-{d}" for n, s, a, d in ROUNDTRIP])
def test_exchange_roundtrips_bitwise(worlds, nc, schedule, a2a, dist):
    """Identity panels make the product exact, so the output equals the
    input iff every row crossed dispatch and combine bit for bit -- under
    skew, all rows on one expert (most ranks own none), balance and the
    probe's windows; T is not a multiple of nc in the first two."""
    d, g = 16, 2 * nc
    sizes = _distributions(g, nc)[dist]
    t = int(sum(sizes))
    x = _normal(_rng(t, nc), (t, d))
    eye = np.broadcast_to(np.eye(d, dtype=np.float32), (g, d, d)).copy()
    out = worlds(nc).run("ep", "matmul", x, [eye], _offsets(sizes),
                         schedule=schedule, a2a=a2a)
    for r in out:
        np.testing.assert_array_equal(r["y"], x)
        assert r["method"] == a2a


def _jax_ep(kind, x, panels, offs, ct):
    o = jnp.asarray(offs)

    def f(x, *ws):
        if kind == "matmul":
            return j_ragged(x, ws[0], o)
        h = j_swiglu(x, ws[0], ws[1], o)
        return h if kind == "swiglu" else j_ragged(h, ws[2], o)

    args = [jnp.asarray(a) for a in (x, *panels)]
    y, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(ct))
    return np.asarray(y), [np.asarray(gr) for gr in grads]


def _panels(kind, g, d, f, rng):
    if kind == "matmul":
        return [_normal(rng, (g, d, f), d ** -0.5)]
    ws = [_normal(rng, (g, d, f), d ** -0.5), _normal(rng, (g, d, f),
                                                       d ** -0.5)]
    if kind == "moe":
        ws.append(_normal(rng, (g, f, d), f ** -0.5))
    return ws


EP_CASES = [(k, s) for k in ("matmul", "swiglu", "moe")
            for s in ("gather", "ring")]


@pytest.mark.parametrize("kind,schedule", EP_CASES,
                         ids=[f"{k}-{s}" for k, s in EP_CASES])
def test_ep_matches_jax_forward_and_gradients(worlds, kind, schedule):
    """The EP executors on 2 ranks against JAX's single-device ragged
    products on the same numpy inputs, fp32 within 1e-5: the output and
    dX replicated on every rank, each rank's dW its own experts' block."""
    d, f, g, nc = 16, 24, 4, 2
    sizes = _distributions(g, nc)["skewed"]
    offs = _offsets(sizes)
    rng = _rng(7, g)
    t = int(offs[-1])
    x = _normal(rng, (t, d))
    panels = _panels(kind, g, d, f, rng)
    out_w = d if kind == "moe" else f
    ct = _normal(rng, (t, out_w))
    y, grads = _jax_ep(kind, x, panels, offs, ct)
    out = worlds(nc).run("ep", kind, x, panels, offs, schedule=schedule,
                         ct=ct)
    for s, r in enumerate(out):
        _close(r["y"], y)
        _close(r["dx"], grads[0])
        for dw, want in zip(r["dw"], grads[1:]):
            _close(dw, want[s * g // nc:(s + 1) * g // nc])


MESH_AXES = [("data", "model"), "model", "data"]


@pytest.mark.parametrize("axis", MESH_AXES, ids=["data+model", "model",
                                                "data"])
@pytest.mark.parametrize("a2a", ["dense", "primitive"])
def test_ep_on_a_2x2_mesh_matches_jax(worlds, axis, a2a):
    """EP over one axis of a (data 2, model 2) mesh (two groups side by
    side) and over both axes as one (a 4-rank group, row-major; the ring
    rotates one axis, so it runs the gather schedule): ``ep_ragged_moe``
    forward and gradients against JAX's single-device products."""
    d, f, g = 16, 24, 8
    sizes = _distributions(g, 4)["skewed"]
    offs = _offsets(sizes)
    rng = _rng(17, len(str(axis)))
    t = int(offs[-1])
    x = _normal(rng, (t, d))
    panels = _panels("moe", g, d, f, rng)
    ct = _normal(rng, (t, d))
    y, grads = _jax_ep("moe", x, panels, offs, ct)
    out = worlds(4).run("ep", "moe", x, panels, offs, schedule="ring",
                        a2a=a2a, ct=ct, shape=(2, 2), axes=("data", "model"),
                        axis=axis)
    nc = 4 if isinstance(axis, tuple) else 2
    for rank, r in enumerate(out):
        s = {("data", "model"): rank, "model": rank % 2,
             "data": rank // 2}[axis]
        _close(r["y"], y)
        _close(r["dx"], grads[0])
        for dw, want in zip(r["dw"], grads[1:]):
            _close(dw, want[s * g // nc:(s + 1) * g // nc])
        assert r["method"] == a2a


@pytest.mark.parametrize("dist", ["skewed", "one_expert", "balanced"])
def test_ring_matches_gather(worlds, dist):
    """The same math over two communication patterns: outputs within 1e-5
    and gradients within 1e-4 on every distribution (4 ranks)."""
    d, f, nc = 16, 24, 4
    g = 2 * nc
    sizes = _distributions(g, nc)[dist]
    offs = _offsets(sizes)
    rng = _rng(3, sum(sizes))
    t = int(offs[-1])
    x = _normal(rng, (t, d))
    panels = _panels("moe", g, d, f, rng)
    ct = _normal(rng, (t, d))
    w = worlds(nc)
    ring = w.run("ep", "moe", x, panels, offs, schedule="ring", ct=ct)
    gath = w.run("ep", "moe", x, panels, offs, schedule="gather", ct=ct)
    for a, b in zip(ring, gath):
        _close(a["y"], b["y"], 1e-5)
        _close(a["dx"], b["dx"], 1e-4)
        for da, db in zip(a["dw"], b["dw"]):
            _close(da, db, 1e-4)


def test_primitive_exchange_counts_its_host_syncs(worlds):
    """The primitive realization reads the window bounds once a call (the
    return leg and the backward reuse them); dense and ring read none."""
    d, g = 16, 4
    sizes = [5, 0, 2, 6]
    offs = _offsets(sizes)
    x = _normal(_rng(5), (13, d))
    eye = np.broadcast_to(np.eye(d, dtype=np.float32), (g, d, d)).copy()
    w = worlds(2)
    w.run("ep", "matmul", x, [eye], offs, schedule="gather", a2a="primitive")
    prim = w.run("ep", "matmul", x, [eye], offs, schedule="gather",
                 a2a="primitive", ct=x)
    assert [r["counts"]["host_syncs"] for r in prim] == [1, 1]
    for sched, a2a in (("gather", "dense"), ("ring", "primitive")):
        r = w.run("ep", "matmul", x, [eye], offs, schedule=sched, a2a=a2a)
        assert [o["counts"]["host_syncs"] for o in r] == [0, 0]
        assert [o["counts"]["staged_bytes"] for o in r] == [0, 0]


def test_exchange_method_follows_the_setting(worlds):
    w = worlds(2)
    d, g = 8, 2
    x = _normal(_rng(9), (6, d))
    eye = np.broadcast_to(np.eye(d, dtype=np.float32), (g, d, d)).copy()
    for a2a, want in (("dense", "dense"), ("primitive", "primitive"),
                      (None, "primitive")):
        r = w.run("ep", "matmul", x, [eye], _offsets([4, 2]),
                  schedule="gather", a2a=a2a)
        assert [o["method"] for o in r] == [want, want]


LADDER = [("ring", "ep_ring@0", "ep_ring@0", {"ep:ring->gather": 1}),
          ("ring", "ep_ring@0", "", {"ep:ring->gather": 1}),
          ("gather", "ep_gather@0", "", {"ep:gather->single": 1}),
          ("ring", "", "ep_ring@0;ep_gather@0",
           {"ep:ring->gather": 1, "ep:gather->single": 1}),
          ("ring", "", "", {})]


@pytest.mark.parametrize("schedule,f0,f1,rungs", LADDER,
                         ids=["ring-both", "ring-rank0", "gather-rank0",
                              "both-sites-rank1", "clean"])
def test_ladder_takes_the_agreed_rung(worlds, schedule, f0, f1, rungs):
    """A fault armed on one rank sends EVERY rank to the next rung (the
    ranks agree first): the same counts on both, no hang, and the result
    of every rung equals the clean run's."""
    d, f, g = 16, 24, 4
    offs = _offsets([9, 0, 4, 6])
    rng = _rng(13)
    x = _normal(rng, (19, d))
    panels = _panels("moe", g, d, f, rng)
    w = worlds(2)
    clean = w.run("ladder", x, panels, offs, schedule, "")
    got = w.run("ladder", per_rank=[(x, panels, offs, schedule, f0),
                                    (x, panels, offs, schedule, f1)])
    for r, c in zip(got, clean):
        assert r["degraded"] == rungs
        _close(r["y"], c["y"], 1e-5)
    assert clean[0]["degraded"] == {}


DM_CASES = [("m_parallel", "gather"), ("k_parallel", "gather"),
            ("k_parallel", "ring")]


@pytest.mark.parametrize("strategy,schedule", DM_CASES,
                         ids=[f"{s}-{c}" for s, c in DM_CASES])
def test_dist_matmul_matches_jax(worlds, strategy, schedule):
    """Alg. 4 and Alg. 5 (both schedules) with a bias + silu + residual
    epilogue, on extents no rank count divides (M 13, K 37, N 21), forward
    and gradients against JAX's single-device ``matmul``."""
    rng = _rng(21)
    m, k, n = 13, 37, 21
    a, b = _normal(rng, (m, k)), _normal(rng, (k, n), k ** -0.5)
    bias, res = _normal(rng, (n,)), _normal(rng, (m, n))
    ct = _normal(rng, (m, n))
    epi = JEpilogue(bias=True, residual=True, activation="silu")

    def f(a, b, bias, res):
        return j_matmul(a, b, epilogue=epi, bias=bias, residual=res)

    y, vjp = jax.vjp(f, *(jnp.asarray(v) for v in (a, b, bias, res)))
    grads = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    out = worlds(2).run("dist_matmul", a, b, strategy=strategy,
                        schedule=schedule, act="silu", bias=bias,
                        residual=res, ct=ct)
    for r in out:
        _close(r["y"], y)
        for key, want in zip(("da", "db", "dbias", "dres"), grads):
            _close(r[key], want)


def test_dist_matmul_planned_strategy_matches_jax(worlds):
    rng = _rng(22)
    a, b = _normal(rng, (4, 96)), _normal(rng, (96, 8))
    out = worlds(2).run("dist_matmul", a, b)
    want = np.asarray(j_matmul(jnp.asarray(a), jnp.asarray(b)))
    for r in out:
        _close(r["y"], want)


def test_dist_matmul_raises_as_the_reference(worlds):
    w = worlds(2)
    a, b = np.ones((4, 8), np.float32), np.ones((8, 4), np.float32)
    msg = w.run("dist_matmul_raises", a, b, "m_parallel", "ring")
    assert all("ring schedule is undefined" in m for m in msg)
    msg = w.run("dist_matmul_raises", a, np.ones((6, 4), np.float32),
                "k_parallel", "gather")
    assert all("contraction mismatch" in m for m in msg)


BATCHED = [("nn", "none"), ("nt", "none"), ("tn", "none"), ("nn", "b"),
           ("nn", "a")]


@pytest.mark.parametrize("trans,shared", BATCHED,
                         ids=[f"{t}-{s}" for t, s in BATCHED])
def test_dist_batched_matmul_matches_jax(worlds, trans, shared):
    """The batch dim (5 entries: padded to the rank count) sharded, a
    shared 2-D operand replicated; forward and gradients against JAX's
    ``batched_matmul``."""
    rng = _rng(31, len(trans + shared))
    g, m, k, n = 5, 6, 12, 10
    shape_a = {"nn": (g, m, k), "nt": (g, m, k), "tn": (g, k, m)}[trans]
    shape_b = {"nn": (g, k, n), "nt": (g, n, k), "tn": (g, k, n)}[trans]
    if shared == "a":
        shape_a = shape_a[1:]
    if shared == "b":
        shape_b = shape_b[1:]
    a, b = _normal(rng, shape_a), _normal(rng, shape_b)
    ct = _normal(rng, (g, m, n))
    y, vjp = jax.vjp(lambda a, b: j_batched(a, b, trans=trans),
                     jnp.asarray(a), jnp.asarray(b))
    da, db = (np.asarray(v) for v in vjp(jnp.asarray(ct)))
    out = worlds(2).run("dist_batched", a, b, trans=trans, ct=ct)
    for r in out:
        _close(r["y"], y)
        _close(r["da"], da)
        _close(r["db"], db)


def test_ep_rejects_a_group_count_the_panels_do_not_make(worlds):
    w = worlds(2)
    x = np.ones((4, 8), np.float32)
    with pytest.raises(AssertionError, match="groups but"):
        w.run("ep", "matmul", x, [np.ones((4, 8, 8), np.float32)],
              _offsets([1, 1, 2]))
