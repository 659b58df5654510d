"""The paper's own yardsticks in the port, held against the JAX package:
the CMR equations (Eqs. 1-4), ``PlanEstimate.bound``, the TGEMM baseline
(``tgemm_plan``, paper Alg. 1), the per-shape utilization bound
(``upper_bound_fraction``, paper Sec. IV-A3), the M- / K-parallel choice
(``choose_strategy``, Alg. 4 / 5) and the quickstart's first three steps
through the port.  The planner at the paper's sizes; tensors only at a
small size."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.gemm import choose_strategy as ref_choose_strategy  # noqa: E402
from repro.core.gemm import classify as ref_classify  # noqa: E402
from repro.core.gemm import cmr as ref_cmr  # noqa: E402
from repro_torch.core.gemm import (autotune, choose_strategy,  # noqa: E402
                                   classify, plan_distributed, plan_gemm,
                                   tgemm_plan, tuner, upper_bound_fraction)
from repro_torch.core.gemm import cmr  # noqa: E402
from repro_torch.kernels.ftimm import ops  # noqa: E402

# benchmarks/single_core.py's CASES (name, M, K, N): the paper's three
# irregular types and a regular control.
SINGLE_CORE = [("t1_tall_small", 2**20, 32, 32),
               ("t1_tall_small_k64", 2**20, 64, 64),
               ("t2_skinny_tall", 32, 2**20, 32),
               ("t2_skinny_tall_n64", 64, 2**20, 64),
               ("t3_regular_tall", 20480, 20480, 32),
               ("t3_regular_tall_n96", 20480, 20480, 96),
               ("regular_control", 4096, 4096, 4096)]
# benchmarks/multi_core.py's CASES at its 8 cores, with the port's choice.
# Where the reference chooses otherwise (DIFFERS) the cause is the local
# product's model, not the reduction: at (16384, 16384, 64) the H100 model
# prices the M-parallel shard (2048, 16384, 64) at 248 us and the
# K-parallel one (16384, 2048, 64) at 84 us (the 2048-row shard fills
# fewer of 132 SMs and re-reads its panel per row tile), its NVLink ring
# all-reduce (16 us) hidden by the ring schedule; the TPU model prices
# them 186 / 175 us with a 37 us ICI reduction, inside the 1.15 margin
# K-parallel must clear.
MULTI_CORE = [("t1_M2^16", 2**16, 32, 32, "m_parallel"),
              ("t1_M2^20", 2**20, 32, 32, "m_parallel"),
              ("t1_M2^22", 2**22, 32, 32, "m_parallel"),
              ("t2_K2^16", 32, 2**16, 32, "k_parallel"),
              ("t2_K2^20", 32, 2**20, 32, "k_parallel"),
              ("t3_20480", 20480, 20480, 32, "k_parallel"),
              ("t3_16384", 16384, 16384, 64, "k_parallel")]
DIFFERS = {"t3_16384": "m_parallel"}
# examples/quickstart.py's three shapes, one per irregular type.
QUICKSTART = [(1_000_000, 64, 32), (32, 1_000_000, 32), (20480, 20480, 32)]
DTYPES = {"fp32": 4, "bf16": 2}


@pytest.fixture(autouse=True)
def _analytic():
    """Analytic against analytic: no measured record or calibration."""
    autotune.clear_plan_store()
    yield
    autotune.clear_plan_store()


def _grid(n: int, seed: int, lo: float = 0.0, hi: float = 21.0):
    """``n`` seeded (m, k, n) shapes, each extent log-uniform in
    [2^lo, 2^hi)."""
    rng = np.random.default_rng(seed)
    return [tuple(int(2 ** e) for e in rng.uniform(lo, hi, 3))
            for _ in range(n)]


@pytest.mark.parametrize("eq", ["paper_f1", "paper_f2", "paper_f3",
                                "paper_f4"])
def test_paper_equations_bitwise(eq):
    rng = np.random.default_rng(28)
    dims = 2.0 ** rng.uniform(0, 24, (200, 3))
    cores = rng.integers(1, 17, 200)
    port, ref = getattr(cmr, eq), getattr(ref_cmr, eq)
    for (a, b, c), nc in zip(dims.tolist(), cores.tolist()):
        assert port(a, b, c, nc) == ref(a, b, c, nc)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SINGLE_CORE, ids=[c[0] for c in SINGLE_CORE])
def test_plan_estimate_bound_follows_the_reference_rule(case, dtype):
    _, m, k, n = case
    for plan in (plan_gemm(m, k, n, DTYPES[dtype], DTYPES[dtype]),
                 tgemm_plan(m, k, n, DTYPES[dtype], DTYPES[dtype])):
        e = plan.est
        ref = ref_cmr.PlanEstimate(e.flops_useful, e.flops_padded,
                                   e.hbm_bytes, e.t_compute, e.t_memory, 0,
                                   0.0)
        assert e.bound == ref.bound == (
            "compute" if e.t_compute >= e.t_memory else "memory")


@pytest.mark.parametrize("in_bytes,body,tile", [
    (4, "fma", (128, 128, 16)), (2, "tc", (128, 128, 64)),
    (1, "fma", (64, 64, 32))], ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", SINGLE_CORE, ids=[c[0] for c in SINGLE_CORE])
def test_tgemm_is_one_fixed_blocking(case, in_bytes, body, tile):
    _, m, k, n = case
    t = tgemm_plan(m, k, n, in_bytes, in_bytes)
    assert (t.body, (t.bm, t.bn, t.bk)) == (body, tile)
    assert (t.dim_order, t.nsplit, t.kslices, t.mode) == ("mn", 1, 1,
                                                          "analytic")
    assert t.gemm_class == classify(m, k, n)
    assert t in tuner.gemm_candidates(m, k, n, in_bytes, in_bytes)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SINGLE_CORE, ids=[c[0] for c in SINGLE_CORE])
def test_adaptive_never_models_slower_than_tgemm_on_the_paper_shapes(
        case, dtype):
    _, m, k, n = case
    b = DTYPES[dtype]
    assert plan_gemm(m, k, n, b, b).est.t_total <= tgemm_plan(
        m, k, n, b, b).est.t_total


@pytest.mark.parametrize("dtype", DTYPES)
def test_adaptive_against_tgemm_on_a_seeded_grid(dtype):
    """TGEMM is one of the argmin's candidates, so it never wins under the
    planner's own order.  Within the argmin's tie window (``ARGMIN_TIE``)
    the paper's tie-break may keep a plan that models up to 2 % slower
    than TGEMM (a stream's longer K slice, a tile with less padding): the
    modeled time is then at most 1.02 x TGEMM's, never more."""
    b = DTYPES[dtype]
    for m, k, n in _grid(300, seed=1):
        ours, fixed = plan_gemm(m, k, n, b, b), tgemm_plan(m, k, n, b, b)
        t_ours, t_fixed = ours.est.t_total, fixed.est.t_total
        assert not tuner._better(fixed, ours), (m, k, n)
        assert t_ours <= t_fixed or (
            t_ours <= (1 + tuner.ARGMIN_TIE) * t_fixed
            and tuner._better(ours, fixed)), (m, k, n, ours, fixed)


def test_upper_bound_fraction_lies_in_zero_one():
    for m, k, n in _grid(100, seed=2):
        for b in (4, 2, 1):
            assert 0.0 < upper_bound_fraction(m, n, k, in_bytes=b) <= 1.0


def test_upper_bound_fraction_grows_with_n_to_the_full_card():
    """fp32 at m = 2^20, k = 4096: 0.4995 at n = 16 (the narrowest compiled
    tile is 32 wide), then the grid fills 132 SMs in whole waves up to
    0.99997; bf16 at n = 16 fills 16 of the tensor-core tile's 128
    columns."""
    fracs = [upper_bound_fraction(2**20, n, 4096) for n in (16, 32, 64, 128)]
    assert fracs == sorted(fracs)
    assert fracs[-1] > 0.9
    assert upper_bound_fraction(2**20, 16, 4096, in_bytes=2) <= 0.2


def test_choose_strategy_reads_plan_distributed():
    for m, k, n in _grid(40, seed=3, lo=3.0, hi=20.0):
        for cores in (1, 2, 4, 8):
            assert choose_strategy(m, k, n, cores) == plan_distributed(
                m, k, n, cores).strategy


@pytest.mark.parametrize("shape,want", [((1003, 64, 32, 8), "m_parallel"),
                                        ((32, 8192, 32, 8), "k_parallel")])
def test_choose_strategy_matches_the_reference_test(shape, want):
    assert choose_strategy(*shape) == ref_choose_strategy(*shape) == want


@pytest.mark.parametrize("case", MULTI_CORE, ids=[c[0] for c in MULTI_CORE])
def test_choose_strategy_on_the_multi_core_cases(case):
    name, m, k, n, want = case
    assert choose_strategy(m, k, n, 8) == want
    assert ref_choose_strategy(m, k, n, 8) == DIFFERS.get(name, want)


def test_quickstart_steps_one_to_three_through_the_port():
    for m, k, n in QUICKSTART:
        assert classify(m, k, n).value == ref_classify(m, k, n).value
        plan = plan_gemm(m, k, n)
        assert plan.est.bound in ("compute", "memory")
        assert tgemm_plan(m, k, n).est.t_total / plan.est.t_total >= 1.0
    for m, k, n in QUICKSTART[:2]:
        p = plan_gemm(m, k, n, num_shards=8)
        assert p.placement.strategy == plan_distributed(m, k, n, 8).strategy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_plans_run_through_ops_gemm_on_the_cpu(dtype):
    """Both plans' ``kernel_kwargs()`` through ``ops.gemm`` (TGEMM
    unclamped) on CPU tensors, which take the plain version: the product
    of the same operands in numpy."""
    rng = np.random.default_rng(5)
    m, k, n = 300, 40, 24
    a_np, b_np = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    a = torch.from_numpy(a_np).to(dtype)
    b = torch.from_numpy(b_np).to(dtype)
    want = a.double().numpy() @ b.double().numpy()
    w = a.element_size()
    for plan, clamp in ((plan_gemm(m, k, n, w, w), True),
                        (tgemm_plan(m, k, n, w, w), False)):
        got = ops.gemm(a, b, out_dtype=dtype, clamp=clamp,
                       **plan.kernel_kwargs())
        assert got.dtype == dtype
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(got.double().numpy(), want,
                                   atol=tol * np.abs(want).max())
