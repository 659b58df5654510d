"""The port's static contracts (``repro_torch.analysis``): every candidate
the port ships passes, every deliberately broken plan, grid, row
assignment, record or source is flagged with its code, the plan store
quarantines by the contracts, ``REPRO_VERIFY=1`` asserts them before a
launch, the tuner's pre-check moves no plan, and the sweep finds nothing.
Where a defect exists in both packages, the JAX package's contracts and
the port's give the same code for the same input."""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts as C
from repro_torch.analysis import sweep
from repro_torch.core.gemm import dispatch, plan_store, tuner
from repro_torch.core.gemm.shapes import PAPER_IRREGULAR_SHAPES
from repro_torch.kernels.ftimm import kernel as K
from repro_torch.kernels.ftimm import ops
from repro_torch.kernels.ftimm.epilogue import Epilogue

BF16 = torch.bfloat16


def _codes(violations):
    return {v.code for v in C.errors(violations)}


@pytest.fixture(autouse=True)
def clean_plans(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv(plan_store.ENV_VAR, raising=False)
    tuner.clear_plan_cache()
    yield
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    tuner.clear_plan_cache()


def _verify_on(monkeypatch):
    """``REPRO_VERIFY=1``, read as ``tuner.clear_plan_cache`` reads it."""
    monkeypatch.setenv("REPRO_VERIFY", "1")
    dispatch.reset_verify()


# ---------------------------------------------------------------------------
# Every candidate the port ships passes
# ---------------------------------------------------------------------------

DENSE_SHAPES = [s[1:] for s in PAPER_IRREGULAR_SHAPES[::5]] + [
    (4, 2048, 6144),        # qwen3-1.7b decode: the register stream
    (128, 2048, 6144),      # its bucket prefill: the tensor cores
    (4097, 999, 31)]        # every edge unaligned
WIDTHS = [(4, 4, None), (2, 2, None), (2, 4, 4), (1, 4, None), (2, 2, 1)]


@pytest.mark.parametrize("width", WIDTHS, ids=lambda w: "ib{}ob{}bb{}".format(
    *w))
@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_shipped_dense_candidates_pass(m, k, n, width):
    ib, ob, bb = width
    for panels, epi_ops in ((1, 0), (1, 2), (2, 0)):
        if panels == 2 and (bb or ib == 1):
            continue        # the pairs take no mixed or 1-byte operands
        cands = tuner.gemm_candidates(m, k, n, ib, ob, panels=panels,
                                      b_bytes=bb, epi_ops=epi_ops)
        assert cands
        for p in cands:
            vs = C.check_plan("dense", (m, k, n), p, in_bytes=ib,
                              out_bytes=ob, b_bytes=bb, swiglu=panels == 2,
                              coverage=True)
            assert not C.errors(vs), (p, [str(v) for v in vs])


def test_shipped_batched_and_ragged_candidates_pass():
    for g, m, k, n in [(8, 16, 4096, 14336), (8, 320, 4096, 1000),
                       (32, 1, 64, 96), (16, 96, 1000, 31)]:
        for panels in (1, 2):
            for width in (2, 4):
                for p in tuner.batched_candidates(g, m, k, n, width, width,
                                                  panels=panels):
                    vs = C.check_plan("batched", (g, m, k, n), p,
                                      in_bytes=width, out_bytes=width,
                                      swiglu=panels == 2, coverage=True)
                    assert not C.errors(vs), (p, [str(v) for v in vs])
    for g, t, k, n in [(16, 4, 5120, 8192), (8, 1024, 4096, 1436),
                       (64, 0, 4096, 1024), (16, 100, 64, 31)]:
        for ragged, panels in (("m", 1), ("m", 2), ("k", 1)):
            for p in tuner.ragged_candidates(g, t, k, n, 2, 2, ragged,
                                             panels=panels):
                vs = C.check_plan("ragged", (g, t, k, n), p, in_bytes=2,
                                  out_bytes=2, ragged=ragged,
                                  swiglu=panels == 2, coverage=True)
                assert not C.errors(vs), (p, [str(v) for v in vs])


def test_every_body_masks_every_operand():
    assert C.check_contraction_masking() == []
    masked = C.masked_operands()
    assert set(masked) == {(k, b) for k, bodies in K._BODY_KERNELS.items()
                           for b in bodies}
    for (kernel, body), (got, need) in masked.items():
        assert got == need == (3 if "swiglu" in kernel else 2), (kernel,
                                                                 body)


@pytest.mark.parametrize("label", [d[0] for d in C.RAGGED_DISTS])
@pytest.mark.parametrize("kernel,body,tile,kslices", [
    ("ftimm_gemm_ragged", "fma", K.TILES[0], 1),
    ("ftimm_gemm_ragged", "fma", K.TILES[3], 1),
    ("ftimm_gemm_ragged", "tc", K.GROUP_TC_TILE, 1),
    ("ftimm_gemm_ragged_swiglu", "tc", K.GROUP_TC_TILE, 1),
    ("ftimm_gemm_ragged", "stream", (16, 128, 64), 3),
    ("ftimm_gemm_ragged_swiglu", "stream", (16, 128, 64), 1)])
def test_ragged_kernels_have_one_writer_per_row(label, kernel, body, tile,
                                                kslices):
    dist = dict(C.RAGGED_DISTS)[label]
    shapes = [(4, 16), (3, 13)] if body == "stream" else [
        (8, 300), (16, 1024), (5, 17)]
    for g, total in shapes:
        offsets, t = dist(g, total)
        assert C.check_ragged_rows(offsets, t, kernel=kernel, body=body,
                                   tile=tile, kslices=kslices) == []


# ---------------------------------------------------------------------------
# Mutations: each corruption is flagged with its code
# ---------------------------------------------------------------------------

@pytest.fixture()
def base_plan():
    return tuner.plan_gemm(4096, 4096, 4096, 2, 2)


def _plan(**kw):
    return tuner.GemmPlan(**{"bm": 64, "bn": 64, "bk": 32, **kw})


DIMS = (4096, 4096, 4096)


@pytest.mark.parametrize("plan,family,dims,kw,code", [
    (_plan(bm=100), "dense", DIMS, {}, "tile_not_compiled"),
    (_plan(body="tc"), "dense", DIMS, {}, "tile_not_compiled"),
    (_plan(bm=0), "dense", DIMS, {}, "nonpositive_block"),
    (_plan(dim_order="km"), "dense", DIMS, {}, "bad_dim_order"),
    (_plan(dim_order="nm"), "ragged", (8, 64, 64, 64), {}, "bad_dim_order"),
    (_plan(body="warp"), "dense", DIMS, {}, "unknown_body"),
    (_plan(body="stream", bm=4, bn=128, bk=64), "ragged", (8, 64, 64, 64),
     {"ragged": "k"}, "unknown_body"),
    (_plan(nsplit=2), "batched", (4,) + DIMS, {}, "nsplit_invalid"),
    (_plan(nsplit=2, body="stream", bm=4, bn=128, bk=64), "dense",
     (4, 4096, 4096), {}, "nsplit_invalid"),
    (_plan(nsplit=200), "dense", (64, 1024, 64), {}, "unclamped_nsplit"),
    (_plan(body="tc", bm=128, bn=128, bk=64), "dense", DIMS,
     {"in_bytes": 1, "out_bytes": 4}, "narrow_operand_body"),
    (_plan(body="stream", bm=4, bn=128, bk=4096), "dense", (4, 8192, 4096),
     {}, "smem_over_budget"),
    (_plan(body="stream", bm=16, bn=128, bk=64), "dense", (32, 4096, 4096),
     {}, "stream_rows_exceeded"),
    (_plan(body="stream", bm=4, bn=128, bk=64, kslices=70000), "dense",
     (4, 64 * 70000, 128), {}, "stream_slices_over_grid"),
], ids=lambda x: x if isinstance(x, str) else None)
def test_mutation_plan_invariants(plan, family, dims, kw, code):
    assert code in _codes(C.check_plan(family, dims, plan, **kw))


def test_mutation_padded_edge():
    rec = {"bm": 64, "bn": 64, "bk": 32, "edge": "padded"}
    assert "edge_padded" in _codes(C.check_record("dense|64x64x64|ib4|ob4",
                                                  rec))


def test_mutation_splitk_nonlinear_epilogue(base_plan):
    p = dataclasses.replace(base_plan, nsplit=2, fuse=True)
    silu = C.check_plan("dense", DIMS, p, in_bytes=2, out_bytes=2,
                        epilogue=Epilogue(activation="silu"))
    assert "splitk_nonlinear_epilogue" in _codes(silu)
    # A linear tail stays legal: it is applied after the ordered sum.
    bias = C.check_plan("dense", DIMS, p, in_bytes=2, out_bytes=2,
                        epilogue=Epilogue(bias=True))
    assert "splitk_nonlinear_epilogue" not in _codes(bias)


def _stream_contract():
    p = tuner.plan_gemm(4, 2048, 6144, 2, 2)
    assert p.body == "stream" and p.kslices > 1
    return C.variant_contract("dense", (4, 2048, 6144), p)


def _tc_contract():
    p = tuner.plan_gemm(1000, 4096, 1000, 2, 2)
    assert p.body == "tc"
    return C.variant_contract("dense", (1000, 4096, 1000), p)


def test_the_real_grids_verify():
    for c in (_stream_contract(), _tc_contract(),
              C.variant_contract("dense", (300, 4096, 600),
                                 _plan(nsplit=4, body="tc", bm=128, bn=128,
                                       bk=64, dim_order="nm"))):
        assert C.verify_contract(c) == [], c.name


def test_mutation_store_moves_with_reduction():
    c = _stream_contract()      # K slices on grid y, one counter a strip
    strips = c.out_extent[1]
    bad = dataclasses.replace(
        c, out_index_map=lambda x, y, z: (0 * x, (x + y) % strips))
    assert "store_moves_with_reduction" in _codes(C.verify_contract(bad))


def test_mutation_overlapping_grid_map():
    c = _tc_contract()
    gm = c.out_extent[0]
    bad = dataclasses.replace(
        c, out_index_map=lambda x, y, z: ((x // 2) % gm, 0 * x))
    codes = _codes(C.verify_contract(bad))
    assert "write_race" in codes and "coverage_gap" in codes


def test_mutation_out_of_range_store():
    c = _tc_contract()
    bad = dataclasses.replace(
        c, out_index_map=lambda x, y, z: tuple(
            o + 1 for o in c.out_index_map(x, y, z)))
    assert "out_of_range_store" in _codes(C.verify_contract(bad))


def test_mutation_coverage_gap():
    c = _tc_contract()
    bad = dataclasses.replace(c, grid=(c.grid[0] - 3, 1, 1))
    assert _codes(C.verify_contract(bad)) == {"coverage_gap"}


def test_mutation_splitk_counter_short_of_its_slices():
    c = C.variant_contract("dense", (300, 4096, 600),
                           _plan(nsplit=4, body="tc", bm=128, bn=128, bk=64))
    bad = dataclasses.replace(c, grid=(c.grid[0] - 1, 1, 1))
    assert "coverage_gap" in _codes(C.verify_contract(bad))


def _mutated(lg: K.LaunchGrid, edit) -> K.LaunchGrid:
    """``lg`` with its row decode passed through ``edit``."""
    return dataclasses.replace(lg, rows=lambda x, y, z, offsets: edit(
        x, y, z, offsets, lg.rows))


def test_mutation_shuffled_ragged_row_assignment():
    offsets, t = [0, 5, 40, 41, 100], 100
    lg = K.launch_grid("ftimm_gemm_ragged", "fma", (4, t, 64, 1), K.TILES[0])
    g = len(offsets) - 1
    assert C.check_ragged_rows(offsets, t, grid=lg) == []

    def shuffled(x, y, z, offs, rows):
        # Each group's CTAs take the rows of the next group.
        moved = np.where(y < g, (y + 1) % g, y)
        return (y,) + tuple(rows(x, moved, z, offs)[1:])

    assert "ragged_extra_visit" in _codes(C.check_ragged_rows(
        offsets, t, grid=_mutated(lg, shuffled)))

    def early(x, y, z, offs, rows):
        # Chunks start one row early: the previous group's last row again.
        grp, lo, hi, s0, s1 = rows(x, y, z, offs)
        return grp, np.where(grp < g, np.maximum(lo - 1, 0), lo), hi, s0, s1

    assert {"write_race", "ragged_extra_visit"} <= _codes(
        C.check_ragged_rows(offsets, t, grid=_mutated(lg, early)))

    def short(x, y, z, offs, rows):
        grp, lo, hi, s0, s1 = rows(x, y, z, offs)
        return grp, lo, np.where(grp < g, np.maximum(hi - 1, lo), hi), s0, s1

    assert "ragged_row_uncovered" in _codes(C.check_ragged_rows(
        offsets, t, grid=_mutated(lg, short)))

    def no_skip(x, y, z, offs, rows):
        # The zero-fill slot overwriting the rows the groups own.
        grp, lo, hi, _, _ = rows(x, y, z, offs)
        return grp, lo, hi, 0 * x, 0 * x

    assert "write_race" in _codes(C.check_ragged_rows(
        [0, 50, 90], 100, grid=_mutated(K.launch_grid(
            "ftimm_gemm_ragged", "fma", (2, 100, 64, 1), K.TILES[0]),
            no_skip)))


def test_mutation_bad_offsets():
    assert _codes(C.check_ragged_rows([0, 10, 5, 12], 12)) == {"bad_offsets"}


def test_a_stream_group_past_its_rows_is_uncovered():
    # The group stream holds 16 rows a group: a ragged call of more rows
    # than that loses the rest (the planner never plans one).
    assert "ragged_row_uncovered" in _codes(C.check_ragged_rows(
        [0, 20, 24], 24, kernel="ftimm_gemm_ragged", body="stream",
        tile=(16, 128, 64)))


def test_mutation_bad_vector_shapes():
    epi = Epilogue(bias=True, scale_vec=True)
    assert _codes(C.check_epilogue_vectors(
        "dense", (8, 16, 32), epi, bias_shape=(31,), scale_shape=(32,))) \
        == {"bad_bias_shape"}
    assert _codes(C.check_epilogue_vectors(
        "ragged", (4, 8, 16, 32), epi, bias_shape=(4, 32),
        scale_shape=(3, 32))) == {"bad_scale_shape"}
    assert C.check_epilogue_vectors("batched", (4, 8, 16, 32), epi,
                                    bias_shape=(32,),
                                    scale_shape=(4, 32)) == []
    # The kernels' own rule holds every call, on the CPU too, before any
    # plan (the dense product in dispatch, ahead of its fused -> unfused
    # rung; the grouped and ragged ones in their launchers).
    x, w = torch.randn(8, 16), torch.randn(16, 32)
    with pytest.raises(ValueError, match=r"\(31,\) is not \(32,\)$"):
        dispatch.matmul(x, w, epilogue=Epilogue(bias=True),
                        bias=torch.randn(31))
    with pytest.raises(ValueError, match=r"\(3, 32\) is not \(32,\) nor"):
        dispatch.ragged_matmul(x, torch.randn(2, 16, 32),
                               torch.tensor([0, 3, 8]),
                               bias=torch.randn(3, 32))
    with pytest.raises(ValueError, match=r"\(2, 31\) is not"):
        dispatch.batched_matmul(torch.randn(2, 8, 16), torch.randn(2, 16, 32),
                                bias=torch.randn(2, 31))
    assert tuner.degraded_stats() == {}


def test_mutation_removed_guard_in_a_copy_of_the_sources(tmp_path):
    src = tmp_path / "csrc"
    shutil.copytree(K.CSRC, src)
    cases = [
        # The FMA panel load: every kernel's FMA body, the dW's K being
        # its group's rows.
        ("ftimm_common.cuh", "(gr < rows && gk < K)", "(gr < rows)",
         {(k, "fma") for k in K._BODY_KERNELS},
         {"missing_k_mask", "missing_input_mask"}),
        ("ftimm_gemm.cu", "(m < p.M && kk < kl)", "(m < p.M)",
         {("ftimm_gemm", "stream")}, {"missing_k_mask"}),
        ("ftimm_gemm.cu", "(k < kl && n < p.N) ? load8",
         "(n < p.N) ? load8", {("ftimm_gemm", "stream")},
         {"missing_k_mask"}),
        ("ftimm_gemm_ragged_dw.cu", "lo, hi, true", "lo, hi, false",
         {("ftimm_gemm_ragged_dw", "tc")}, {"missing_input_mask"}),
        ("ftimm_gemm_ragged_dw.cu", "p.F, hi - lo, m0", "p.F, p.T, m0",
         {("ftimm_gemm_ragged_dw", "fma")}, {"missing_input_mask"}),
        ("ftimm_tc.cuh", "BLOCKS = 2 + T::BN / 64", "BLOCKS = T::BN / 64",
         {("ftimm_gemm_ragged_dw", "tc")}, {"missing_input_mask"}),
        ("ftimm_gstream.cuh", "k_hi = min(p.K, k_lo + p.slice)",
         "k_hi = k_lo + p.slice",
         {(k, "stream") for k in K._GROUP_STREAM}, {"missing_k_mask"}),
    ]
    for name, old, new, broken, codes in cases:
        path = src / name
        text = (K.CSRC / name).read_text()
        assert old in text, (name, old)
        path.write_text(text.replace(old, new))
        found = C.check_contraction_masking(src)
        assert {v.code for v in found} == codes, (name, found)
        got = {key for key, (n, need) in C.masked_operands(src).items()
               if n < need}
        assert got == broken, (name, got)
        path.write_text(text)
    assert C.check_contraction_masking(src) == []


@pytest.mark.parametrize("old,new", [
    # B: the copies past the K bound ("nt": elements, "nn": rows) read
    # their bytes instead of zero-filling them.
    ("? tail_bytes(e, e_hi) : 0;", "? 16 : 0;"),
    ("make_stream<LPR, J>(p, g, k_lo, k_hi, n0, p.N,",
     "make_stream<LPR, J>(p, g, k_lo, p.K, n0, p.N,"),
    ("make_stream<LPR, J>(p, g, r_lo, r_hi, k_lo, k_hi,",
     "make_stream<LPR, J>(p, g, r_lo, r_hi, k_lo, p.K,"),
    # A: the loads past k_hi.
    ("= k < k_hi ? ga[", "= k < p.K ? ga["),
    ("= r < k_hi ? ga[", "= r < p.K ? ga["),
])
def test_mutation_rows_guards_in_a_copy_of_the_sources(tmp_path, old, new):
    """The rows body masks the K remainder of both operands: a copy of the
    sources with either guard removed fails the masking contract, for that
    body only."""
    src = tmp_path / "csrc"
    shutil.copytree(K.CSRC, src)
    name = "ftimm_rows.cuh"
    text = (K.CSRC / name).read_text()
    assert text.count(old) == 1, old
    assert C.masked_operands(src)[("ftimm_gemm_grouped", "rows")] == (2, 2)
    (src / name).write_text(text.replace(old, new))
    found = C.check_contraction_masking(src)
    assert {v.code for v in found} == {"missing_k_mask"}, found
    got = {key for key, (n, need) in C.masked_operands(src).items()
           if n < need}
    assert got == {("ftimm_gemm_grouped", "rows")}


def test_rows_plans_meet_the_contracts():
    """The rows body's cut of every decode attention shape, both trans,
    passes the plan invariants, the budget and its launch's store
    coverage (K slices arrive on one counter a (group, strip)); a tile
    the body does not take (one cut for "nt" is not one for "nn"), bf16
    operands and more than ROWS_MAX rows are violations."""
    for g, m, hd, s in ((32, 2, 128, 96), (128, 1, 112, 320),
                        (32, 1, 64, 1024), (32, 7, 128, 896),
                        (16, 2, 256, 1120), (3, 8, 600, 257)):
        for trans, k, n in (("nt", hd, s), ("nn", s, hd)):
            plan = tuner.plan_batched_gemm(g, m, k, n, 4, 4, "none",
                                           trans=trans)
            assert plan.body == "rows"
            assert C.check_plan("batched", (g, m, k, n), plan,
                                coverage=True, trans=trans) == []
    bad = tuner.GemmPlan(bm=K.ROWS_MAX, bn=100, bk=100, body="rows")
    codes = {v.code for v in C.check_plan("batched", (4, 2, 96, 128), bad)}
    assert "tile_not_compiled" in codes
    strip = tuner.GemmPlan(bm=K.ROWS_MAX, bn=100, bk=64, body="rows")
    assert C.check_plan("batched", (4, 2, 64, 300), strip, trans="nt") == []
    codes = {v.code for v in C.check_plan("batched", (4, 2, 64, 300), strip,
                                          trans="nn")}
    assert "tile_not_compiled" in codes
    ok = tuner.GemmPlan(bm=K.ROWS_MAX, bn=128, bk=96, body="rows")
    codes = {v.code for v in C.check_plan("batched", (4, 9, 96, 128), ok,
                                          in_bytes=2, out_bytes=2)}
    assert {"rows_body_types", "rows_exceeded"} <= codes


def test_stored_rows_record_is_checked_in_its_layout():
    """A stored rows record is held to the cut of the layout its key names:
    an "nt" strip of 100 cache rows passes under ``trans:nt`` and is
    quarantined under the "nn" key of the same shape."""
    rec = {"body": "rows", "bm": K.ROWS_MAX, "bn": 100, "bk": 64}
    nt = tuner.batched_key(4, 2, 64, 300, 4, 4, "none", trans="nt")
    assert "trans:nt" in nt and C.check_record(nt, rec) == []
    nn = tuner.batched_key(4, 2, 64, 300, 4, 4, "none")
    assert "tile_not_compiled" in _codes(C.check_record(nn, rec))


# ---------------------------------------------------------------------------
# The plan store's quarantine asks the contracts
# ---------------------------------------------------------------------------

def _store_file(tmp_path, entries):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"schema": plan_store.SCHEMA_VERSION,
                                "device_kind": plan_store.device_kind(),
                                "entries": entries}))
    return str(path)


def test_plan_store_quarantines_with_the_contracts_codes(tmp_path):
    good = "dense|4x2048x6144|ib2|ob2"
    entries = {
        good: {"body": "stream", "bm": 4, "bn": 128, "bk": 512,
               "kslices": 4},
        "dense|4x6144x2048|ib2|ob2": {"body": "stream", "bm": 4, "bn": 128,
                                      "bk": 4096},
        "dense|4x2048x6144|ib2|ob2|pair": {"bm": 16, "bn": 32, "bk": 64,
                                           "nsplit": 2},
        "dense|128x2048x6144|ib2|ob2": {"bm": 100, "bn": 32, "bk": 64},
        "dense|128x2048x6144|ib2|ob2|shards4": {"bm": 100, "bn": 32,
                                                "bk": 64,
                                                "strategy": "m_parallel"},
        "dense|128x2048x6144|ib2|ob2|shards2": {"bm": 128, "bn": 128,
                                                "bk": 64},
        "dense|12xab|ib4|ob4": {"bm": 16, "bn": 32, "bk": 64},
        "ragged|4x16x64x64|ib2|ob2|ragged:m": {"bm": 16, "bn": "x",
                                               "bk": 64},
    }
    st = plan_store.PlanStore()
    assert st.load(_store_file(tmp_path, entries)) == 1
    assert st.quarantined == {
        "dense|4x6144x2048|ib2|ob2": ["smem_over_budget"],
        "dense|4x2048x6144|ib2|ob2|pair": ["nsplit_invalid",
                                           "splitk_nonlinear_epilogue",
                                           "splitk_unsupported"],
        "dense|128x2048x6144|ib2|ob2": ["tile_not_compiled"],
        "dense|128x2048x6144|ib2|ob2|shards4": ["tile_not_compiled"],
        "dense|128x2048x6144|ib2|ob2|shards2": ["bad_strategy"],
        "dense|12xab|ib4|ob4": ["malformed_key"],
        "ragged|4x16x64x64|ib2|ob2|ragged:m": ["malformed_record"]}
    assert st.lookup(good) is not None


def test_quarantine_counted_in_plan_mode_stats(tmp_path):
    path = _store_file(tmp_path, {
        "dense|512x64x512|ib4|ob4": {"bm": 128, "bn": 128, "bk": 1024},
        "ragged|8x64x64x64|ib4|ob4|ragged:k": {"bm": 16, "bn": 32, "bk": 64,
                                               "body": "stream"}})
    plan_store.get_store().load(path)
    stats = tuner.plan_mode_stats()
    assert stats["dense"]["quarantined"] == 1
    assert stats["ragged"]["quarantined"] == 1
    assert plan_store.get_store().quarantined[
        "ragged|8x64x64x64|ib4|ob4|ragged:k"] == ["unknown_body"]


# ---------------------------------------------------------------------------
# REPRO_VERIFY=1
# ---------------------------------------------------------------------------

def test_repro_verify_accepts_planned_calls(monkeypatch):
    _verify_on(monkeypatch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100, 70, generator=g)
    y = dispatch.matmul(x, torch.ones(70, 50), epilogue=Epilogue(bias=True),
                        bias=torch.ones(50))
    assert y.shape == (100, 50)
    dispatch.matmul_swiglu(x.to(BF16), torch.randn(70, 96).to(BF16),
                           torch.randn(70, 96).to(BF16))
    dispatch.batched_matmul(torch.randn(4, 3, 70), torch.randn(4, 70, 20))
    dispatch.grouped_swiglu(torch.randn(4, 3, 70), torch.randn(4, 70, 20),
                            torch.randn(4, 70, 20))
    w = torch.randn(3, 70, 40, requires_grad=True)
    xr = torch.randn(10, 70, requires_grad=True)
    offs = torch.tensor([0, 4, 4, 10])
    dispatch.ragged_matmul(xr, w, offs).sum().backward()
    dispatch.ragged_swiglu(xr.detach(), w.detach(), w.detach(), offs)
    stats = dispatch.verify_stats()
    for kernel in ("ftimm_gemm", "ftimm_gemm_swiglu", "ftimm_gemm_grouped",
                   "ftimm_gemm_grouped_swiglu", "ftimm_gemm_ragged",
                   "ftimm_gemm_ragged_swiglu", "ftimm_gemm_ragged_dw"):
        assert stats.get(kernel, 0) > 0, (kernel, stats)
    before = dict(stats)
    dispatch.matmul(x, torch.ones(70, 50), epilogue=Epilogue(bias=True),
                    bias=torch.ones(50))
    assert dispatch.verify_stats() == before     # memoized per (shape, plan)


def _corrupt_plan(monkeypatch):
    good = tuner.plan_gemm(96, 64, 48, 4, 4)
    corrupt = dataclasses.replace(good, bm=100)     # no compiled tile
    monkeypatch.setattr(dispatch, "plan_gemm", lambda *a, **kw: corrupt)
    launched = []
    real = ops.gemm
    monkeypatch.setattr(ops, "gemm", lambda *a, **kw: launched.append(1)
                        or real(*a, **kw))
    return launched


def test_repro_verify_rejects_a_corrupt_plan_before_any_launch(monkeypatch):
    _verify_on(monkeypatch)
    launched = _corrupt_plan(monkeypatch)
    with pytest.raises(C.ContractError, match="tile_not_compiled"):
        dispatch.matmul(torch.ones(96, 64), torch.ones(64, 48))
    assert launched == []


def test_repro_verify_off_checks_nothing(monkeypatch):
    launched = _corrupt_plan(monkeypatch)
    y = dispatch.matmul(torch.ones(96, 64), torch.ones(64, 48))
    assert y.shape == (96, 48) and launched == [1]
    assert dispatch.verify_stats() == {}


def test_repro_verify_is_read_when_the_plan_cache_is_cleared(monkeypatch):
    launched = _corrupt_plan(monkeypatch)
    monkeypatch.setenv("REPRO_VERIFY", "1")
    dispatch.matmul(torch.ones(96, 64), torch.ones(64, 48))
    assert launched == [1] and dispatch.verify_stats() == {}
    tuner.clear_plan_cache()
    with pytest.raises(C.ContractError, match="tile_not_compiled"):
        dispatch.matmul(torch.ones(96, 64), torch.ones(64, 48))
    assert launched == [1]


def test_a_splitk_record_is_verified_as_the_splitk_kernel(monkeypatch):
    _verify_on(monkeypatch)
    a, b = torch.randn(256, 128).to(BF16), torch.randn(256, 384).to(BF16)
    key = tuner.dense_key(128, 256, 384, 2, 2, b_bytes=2, trans="tn")
    store = plan_store.get_store()
    store.put(key, {"body": "fma", "bm": 64, "bn": 64, "bk": 32,
                    "nsplit": 4})
    tuner.clear_planner_caches()
    y = dispatch.matmul(a, b, trans="tn")
    assert torch.allclose(y.float(), a.float().T @ b.float(), rtol=1e-2,
                          atol=0.1)
    assert dispatch.verify_stats() == {"ftimm_gemm_splitk": 1}


# ---------------------------------------------------------------------------
# The candidate generators and the sweep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,dims,kw", [
    ("dense", (4, 2048, 6144), {}),
    ("dense", (128, 2048, 6144), {"epi_ops": 2}),
    ("dense", (16, 1024, 4096), {"panels": 2}),
    ("dense", (4097, 999, 31), {}),
    ("batched", (8, 16, 4096, 1436), {"panels": 2}),
    ("batched", (32, 1, 64, 96), {}),
    ("ragged", (16, 4, 5120, 8192), {}),
    ("ragged", (16, 1024, 5120, 8192), {"panels": 2}),
    ("ragged", (16, 1024, 5120, 8192), {"ragged": "k"}),
])
def test_every_generated_candidate_meets_the_contracts(family, dims, kw):
    """The generators emit only compiled tiles within the shared-memory
    budget: ``check_blocks`` and ``check_budget`` pass every candidate."""
    gen = {"dense": tuner.gemm_candidates,
           "batched": tuner.batched_candidates,
           "ragged": tuner.ragged_candidates}[family]
    ragged = kw.get("ragged", "m")
    rest = {k: v for k, v in kw.items() if k != "ragged"}
    panels = rest.get("panels", 1)
    kernel = C.plan_kernel(family, panels=panels, ragged=ragged)
    for width in (2, 4):
        cands = (gen(*dims, width, width, ragged, **rest)
                 if family == "ragged" else gen(*dims, width, width, **rest))
        assert cands
        for p in cands:
            found = C.check_blocks(
                family, dims, bm=p.bm, bn=p.bn, bk=p.bk,
                dim_order=p.dim_order, in_bytes=width, out_bytes=width,
                ragged=ragged, body=p.body, kslices=p.kslices,
                panels=panels) + C.check_budget(
                    kernel, p.body, bm=p.bm, bn=p.bn, bk=p.bk, panels=panels)
            assert C.errors(found) == [], (p, found)


def test_run_sweep_quick_zero_violations(tmp_path):
    cache = _store_file(tmp_path, {
        "dense|4x2048x6144|ib2|ob2": {"body": "stream", "bm": 4, "bn": 128,
                                      "bk": 512, "kslices": 4},
        "ragged|16x1024x5120x8192|ib2|ob2|ragged:k": {
            "body": "tc", "bm": 128, "bn": 128, "bk": 64}})
    report = sweep.run_sweep(shapes=PAPER_IRREGULAR_SHAPES[:3],
                             archs=["qwen3-1.7b", "llama4-scout-17b-a16e"],
                             cache_path=cache)
    assert report["violations"] == [], report["violations"][:5]
    assert report["candidates_checked"] > 1000
    assert report["coverage_contracts"] > 50
    assert report["ragged_row_proofs"] > 10
    assert report["plan_cache"] == {"path": cache, "entries": 2,
                                    "quarantine_candidates": 0}
    budget = tuner.H100.smem_per_block
    assert 0 < max(report["smem_admitted"].values()) <= budget


def test_sweep_cli_writes_its_report(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert sweep.main(["--quick", "--arch", "mixtral-8x7b", "--out",
                       str(out)]) == 0
    assert "PASS" in capsys.readouterr().out
    assert json.loads(out.read_text())["violations"] == []


# ---------------------------------------------------------------------------
# Parity with the JAX package where a defect exists in both
# ---------------------------------------------------------------------------

# The port keeps its plan store's reason codes where the reference's
# contracts name the same defect otherwise.
REFERENCE_CODES = {"malformed_key": "bad_key",
                   "malformed_record": "bad_record"}


def _as_reference(codes):
    return {REFERENCE_CODES.get(c, c) for c in codes}


RECORD_CASES = [
    ("dense|12xab|ib4|ob4", {"bm": 128, "bn": 128, "bk": 128}),
    ("dense|64x64|ib4|ob4", {"bm": 128, "bn": 128, "bk": 128}),
    ("dense|4096x4096x4096|ib4|ob4", {"bm": 128, "bn": 128}),
    ("dense|4096x4096x4096|ib4|ob4", ["not", "a", "mapping"]),
    ("dense|4096x4096x128|ib2|ob2|bb1", {"bm": 64, "bn": 128, "bk": 128,
                                         "nsplit": 2}),
]


@pytest.mark.parametrize("key,rec", RECORD_CASES)
def test_record_codes_match_the_reference(key, rec):
    from repro.analysis import contracts as JC
    want = {v.code for v in JC.errors(JC.check_record(key, rec))}
    got = _codes(C.check_record(key, rec))
    assert want and _as_reference(got) == want, (got, want)


def test_splitk_nonlinear_tail_flagged_by_both():
    from repro.analysis import contracts as JC
    from repro.core.gemm import tuner as jtuner
    from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue
    jplan = dataclasses.replace(jtuner.plan_gemm(4096, 4096, 4096), nsplit=2,
                                bk=128, fuse=True)
    plan = dataclasses.replace(tuner.plan_gemm(4096, 4096, 4096, 2, 2),
                               nsplit=2, fuse=True)
    for act, flagged in (("silu", True), ("none", False)):
        want = {v.code for v in JC.errors(JC.check_plan(
            "dense", DIMS, jplan, epilogue=JEpilogue(activation=act,
                                                     bias=True)))}
        got = _codes(C.check_plan("dense", DIMS, plan, in_bytes=2,
                                  out_bytes=2,
                                  epilogue=Epilogue(activation=act,
                                                    bias=True)))
        assert ("splitk_nonlinear_epilogue" in want) == flagged, want
        assert ("splitk_nonlinear_epilogue" in got) == flagged, got


@pytest.mark.parametrize("family,dims,bias,scale", [
    ("dense", (8, 16, 32), (31,), None),
    ("batched", (4, 8, 16, 32), (3, 32), (32,)),
    ("ragged", (4, 8, 16, 32), (4, 32), (4, 31)),
    ("ragged", (4, 8, 16, 32), (32,), (4, 32)),
])
def test_vector_codes_match_the_reference(family, dims, bias, scale):
    from repro.analysis import contracts as JC
    from repro.kernels.ftimm.epilogue import Epilogue as JEpilogue
    kw = dict(bias_shape=bias, scale_shape=scale)
    want = [v.code for v in JC.check_epilogue_vectors(
        family, dims, JEpilogue(bias=True, scale_vec=True), **kw)]
    got = [v.code for v in C.check_epilogue_vectors(
        family, dims, Epilogue(bias=True, scale_vec=True), **kw)]
    assert got == want
