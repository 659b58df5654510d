"""The body-selection rule of the ftIMM GEMM kernels and the planner's
choice among the bodies (CPU: the rule and the planner are plain Python).

``ftimm_gemm`` has an FMA body (any types and strides), a tensor-core body
(bf16 x bf16, both operands TMA-readable) and a K-parallel weight stream
(bf16 x bf16, at most 16 rows, B vector-readable); ``ftimm_gemm_grouped``
and ``ftimm_gemm_ragged`` and the three SwiGLU pairs the same three (their
stream: at most 16 rows a group, or in all for the ragged kernels, A
K-major; the grouped and ragged panels through 3-D tensor maps; the dense
pair is the grouped pair's rule with one group), and ``ftimm_gemm_grouped``
a fourth, the few-rows fp32 stream (fp32 x fp32, at most 8 rows a group,
"nn" / "nt", B's rows unit-stride and 16-byte aligned: the decode
attention products); ``ftimm_gemm_ragged_dw`` and ``ftimm_gemm_splitk``
the first two.  ``plan_gemm`` /
``plan_batched_gemm`` / ``plan_ragged_gemm`` pick the body from the CMR
model among those the rule allows; the split-K kernel stays off every
model path (``nsplit`` 1, as in the reference).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.gemm import (H100, estimate_rows, estimate_stream,  # noqa: E402
                                   plan_batched_gemm, plan_gemm,
                                   plan_ragged_gemm)
from repro_torch.core.gemm.cmr import STREAM_CTAS_PER_SM  # noqa: E402
from repro_torch.kernels.ftimm import kernel as K  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
MODELS = ("qwen3-1.7b", "mixtral-8x7b", "llama4-scout-17b-a16e")


def _widths(arch):
    c = get_config(arch)
    hq, hkv = c.num_heads * c.head_dim_, c.num_kv_heads * c.head_dim_
    return c, c.d_model, hq, hkv, c.d_ff


def _decode_shapes(arch, rows=4):
    """(m, k, n, out_bytes) of every ftimm_gemm of one decode step."""
    c, d, hq, hkv, f = _widths(arch)
    shapes = [(rows, d, hq, 2), (rows, d, hkv, 2), (rows, hq, d, 2),
              (rows, d, c.vocab_padded, 4)]
    if c.family == "moe":
        shapes.append((rows, d, c.num_experts, 4))       # the router
    else:
        shapes.append((rows, f, d, 2))                   # the dense down
    return shapes


@pytest.mark.parametrize("a,b,m,a_ok,b_ok,panels,want", [
    (2, 2, 4, True, True, 1, ("fma", "tc", "stream")),
    (2, 2, 16, True, True, 1, ("fma", "tc", "stream")),
    (2, 2, 17, True, True, 1, ("fma", "tc")),
    (2, 2, 1024, True, True, 1, ("fma", "tc")),
    (2, 2, 4, False, True, 1, ("fma", "stream")),     # A is staged, not TMA'd
    (2, 2, 4, True, False, 1, ("fma",)),
    (2, 2, 200, False, True, 1, ("fma",)),
    (2, 4, 1024, True, True, 1, ("fma",)),             # bf16 x fp32
    (4, 2, 4, True, True, 1, ("fma",)),                # fp32 x bf16
    (4, 4, 4, True, True, 1, ("fma",)),                # fp32 x fp32
    (2, 2, 4, True, True, 2, ("fma", "tc", "stream")),  # the SwiGLU pair
    (2, 2, 16, True, True, 2, ("fma", "tc", "stream")),
    (2, 2, 17, True, True, 2, ("fma", "tc")),
    (2, 2, 1024, True, True, 2, ("fma", "tc")),
    (2, 2, 4, False, True, 2, ("fma",)),               # x not K-major
    (2, 2, 4, True, False, 2, ("fma",)),               # a panel TMA can't read
    (4, 4, 4, True, True, 2, ("fma",)),                # the fp32 pair
    (2, 4, 4, True, True, 2, ("fma",)),
])
def test_gemm_body_rule(a, b, m, a_ok, b_ok, panels, want):
    assert K.gemm_bodies(a, b, m, a_ok, b_ok, panels) == want


@pytest.mark.parametrize("ptr,rows,k,s_rows,s_k,want", [
    (0, 4, 2048, 2048, 1, "k"),          # A (M, K) row-major
    (0, 2048, 1024, 1, 2048, "mn"),      # tn: A (K, M) row-major
    (0, 1, 72, 999, 1, "k"),             # one row: any row stride
    (0, 33, 264, 1, 33, None),           # K stride 66 bytes
    (2, 64, 64, 64, 1, None),            # base not 16-byte aligned
    (0, 64, 64, 8, 8, None),             # no unit-stride dimension
    (0, 64, 128, 64, 1, None),           # rows overlap (stride < extent)
    (0, 0, 64, 64, 1, None),             # empty
    (0, 64, 0, 64, 1, None),
])
def test_tma_major_rule(ptr, rows, k, s_rows, s_k, want):
    assert K.tma_major(ptr, rows, k, s_rows, s_k) == want


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
def test_operand_rule_follows_layout_and_alignment(trans):
    m, k, n = 64, 256, 128
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    a, b = torch.zeros(sa, dtype=BF16), torch.zeros(sb, dtype=BF16)
    assert K.gemm_operands_ok(a, b, trans) == (True, True)
    # A transposed view keeps a unit-stride dimension: still readable.
    assert K.gemm_operands_ok(a.t().contiguous().t(), b, trans)[0]
    # A view 2 bytes off a 16-byte boundary is not.
    big = torch.zeros((sa[0], sa[1] + 8), dtype=BF16)
    off = big[:, 1:sa[1] + 1]
    assert off.data_ptr() % 16 == 2
    assert K.gemm_operands_ok(off, b, trans)[0] is False
    x, dy = torch.zeros(100, 64, dtype=BF16), torch.zeros(100, 96, dtype=BF16)
    assert K.ragged_dw_operands_mn(x, dy) == (True, True)
    assert K.ragged_dw_operands_mn(x.t().contiguous().t(), dy) == (False, True)
    assert K.ragged_dw_bodies(2, 2, True, True) == ("fma", "tc")
    assert K.ragged_dw_bodies(2, 4, True, True) == ("fma",)
    assert K.ragged_dw_bodies(2, 2, False, True) == ("fma",)


@pytest.mark.parametrize("arch", MODELS)
def test_plan_streams_every_decode_shape(arch):
    for m, k, n, out in _decode_shapes(arch):
        plan = plan_gemm(m, k, n, 2, out)
        assert plan.body == "stream", (arch, m, k, n, plan)
        assert plan.nsplit == 1
        assert plan.bm == K.stream_rows(m) and plan.bn == K.STREAM_STRIP
        sl, slices = K.stream_slice(k, plan.kslices)
        assert (sl, slices) == (plan.bk, plan.kslices)
        assert plan.bm * plan.bk * 2 <= K.STREAM_SMEM


@pytest.mark.parametrize("arch", MODELS)
def test_stream_slices_fill_the_card(arch):
    """The K slice count puts at least one CTA in every slot of the card
    where N and K leave room for it: else the slices are as many as the
    planner offers (64) or as short as a slice can be (64 rows)."""
    for m, k, n, out in _decode_shapes(arch):
        plan = plan_gemm(m, k, n, 2, out)
        ctas = -(-n // K.STREAM_STRIP) * plan.kslices
        filled = ctas >= 0.9 * H100.sms * STREAM_CTAS_PER_SM
        assert filled or plan.kslices >= 40 or plan.bk == K.STREAM_SLICE_STEP, (
            arch, m, k, n, plan.kslices, ctas)
        # and no more slices than it takes: one fewer halving would not fill
        if plan.kslices > 1 and filled:
            fewer = estimate_stream(m, k, n, kslices=max(plan.kslices // 2, 1),
                                    in_bytes=2, out_bytes=out)
            assert fewer.t_total >= 0.98 * plan.est.t_total


@pytest.mark.parametrize("arch", MODELS)
def test_plan_takes_tensor_cores_for_bf16_large_m(arch):
    """Training (8 x 128 tokens) and the bucket prefills (4 slots x 32 or
    64 rows): every projection, its dX ("nt") and dW ("tn": M = the weight's
    rows, K = the tokens) and the unembed forward plan the tensor cores."""
    c, d, hq, hkv, f = _widths(arch)
    for t in (128, 256, 1024):
        for (m, k, n) in ((t, d, hq), (t, d, hkv), (t, hq, d), (t, f, d),
                          (t, d, f)):
            for shape in ((m, k, n), (m, n, k), (k, m, n)):   # fwd, dX, dW
                plan = plan_gemm(*shape, 2, 2)
                assert plan.body == "tc", (arch, shape, plan)
                assert (plan.bm, plan.bn, plan.bk) in K.TC_TILES
        plan = plan_gemm(t, d, c.vocab_padded, 2, 4)
        assert plan.body == "tc" and plan.nsplit == 1


@pytest.mark.parametrize("arch", MODELS)
def test_plan_keeps_fp32_and_mixed_pairs_on_fma(arch):
    """The fp32 references and the fp32 cotangents of the logits and the
    router (a bf16 x fp32 pair, in either order) stay on the FMA body."""
    c, d, hq, hkv, f = _widths(arch)
    for m, k, n in ((1024, d, hq), (4, d, hq), (1024, c.vocab_padded, d),
                    (d, 1024, c.vocab_padded)):
        for a, b in ((4, 4), (2, 4), (4, 2)):
            plan = plan_gemm(m, k, n, a, 4, b_bytes=b)
            assert plan.body == "fma" and (plan.bm, plan.bn, plan.bk) in K.TILES
    # Operands TMA cannot read also plan the FMA body.
    assert plan_gemm(1024, d, hq, 2, 2, a_ok=False).body == "fma"
    assert plan_gemm(4, d, hq, 2, 2, b_ok=False).body == "fma"


def test_ragged_dw_plans_tensor_cores_and_nsplit_stays_1():
    l4 = get_config("llama4-scout-17b-a16e")
    e, d, f = l4.num_experts, l4.d_model, l4.d_ff
    for (k, n) in ((d, f), (f, d)):
        plan = plan_ragged_gemm(e, 1024, k, n, 2, 2, ragged="k")
        assert plan.body == "tc" and (plan.bm, plan.bn, plan.bk) in K.TC_TILES
        assert plan.nsplit == 1
        assert plan_ragged_gemm(e, 1024, k, n, 2, 2, ragged="k",
                                a_ok=False).body == "fma"
        assert plan_ragged_gemm(e, 1024, k, n, 4, 4, ragged="k").body == "fma"
        assert plan_ragged_gemm(e, 1024, k, n, 2, 4, ragged="k",
                                b_bytes=4).body == "fma"


@pytest.mark.parametrize("arch", MODELS)
def test_nsplit_stays_1_on_every_model_plan(arch):
    c, d, hq, hkv, f = _widths(arch)
    for t in (4, 128, 256, 1024):
        for (m, k, n) in ((t, d, hq), (t, hq, d), (t, f, d), (t, d, f),
                          (d, t, hq), (t, d, c.vocab_padded)):
            for a, out in ((2, 2), (2, 4), (4, 4)):
                assert plan_gemm(m, k, n, a, out).nsplit == 1


@pytest.mark.parametrize("tile", K.TC_TILES)
@pytest.mark.parametrize("stages", sorted(set(K.TC_STAGES.values())))
def test_tc_tiles_fit_shared_memory(tile, stages):
    bm, bn, bk = tile
    ring = stages * (bm + bn) * bk * 2
    got = K.smem_bytes(bm, bn, bk, body="tc", stages=stages)
    assert max(ring, bm * (bn + 8) * 4) < got <= H100.smem_per_block
    assert got > 48 * 1024                  # needs the dynamic-smem attribute


@pytest.mark.parametrize("rows", K.STREAM_ROWS)
def test_stream_slices_fit_shared_memory(rows):
    """The largest slice the planner offers for each row count fits the
    48 KB a block gets without the dynamic-smem attribute."""
    sl = K.STREAM_SMEM // (rows * 2) // K.STREAM_SLICE_STEP * K.STREAM_SLICE_STEP
    assert K.smem_bytes(rows, K.STREAM_STRIP, sl, body="stream") <= 48 * 1024


@pytest.mark.parametrize("k,kslices", [(2048, 8), (1032, 3), (6144, 12),
                                       (64, 8), (1, 1), (5120, 40)])
def test_stream_slice_cuts_k_without_empty_slices(k, kslices):
    sl, slices = K.stream_slice(k, kslices)
    assert sl % K.STREAM_SLICE_STEP == 0 and slices <= max(kslices, 1)
    assert (slices - 1) * sl < k <= slices * sl


def test_stream_rows_menu():
    assert [K.stream_rows(m) for m in (1, 4, 5, 8, 9, 16)] == [4, 4, 8, 8, 16, 16]
    with pytest.raises(ValueError):
        K.stream_rows(17)


@pytest.mark.parametrize("body", ["tc", "stream"])
def test_cpu_tensors_take_the_plain_version_whatever_the_body(body):
    """The device decides: on the CPU every body is the plain version."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 96, generator=g).to(BF16)
    b = torch.randn(96, 40, generator=g).to(BF16)
    K.reset_launch_counts()
    got = K.ftimm_gemm(a, b, bm=128, bn=128, bk=64, body=body, kslices=3)
    assert torch.equal(got, K.ftimm_gemm_plain(a, b))
    assert K.launch_counts()["ftimm_gemm"] == 0
    assert sum(K.body_counts()["ftimm_gemm"].values()) == 0


# ---------------------------------------------------------------------------
# The grouped and ragged kernels' bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a,b,m,a_major,b_ok,panels,want", [
    (2, 2, 16, "k", True, 1, ("fma", "tc", "stream")),   # mixtral decode
    (2, 2, 1, "k", True, 1, ("fma", "tc", "stream")),
    (2, 2, 17, "k", True, 1, ("fma", "tc")),
    (2, 2, 320, "k", True, 1, ("fma", "tc")),             # mixtral train
    (2, 2, 16, "mn", True, 1, ("fma", "tc")),             # tn: A MN-major
    (2, 2, 16, None, True, 1, ("fma",)),
    (2, 2, 16, "k", False, 1, ("fma",)),
    (4, 4, 2, "k", True, 1, ("fma",)),                    # fp32 attention
    (2, 4, 320, "k", True, 1, ("fma",)),                  # bf16 x fp32
    (4, 2, 320, "k", True, 1, ("fma",)),                  # fp32 x bf16
    (2, 2, 16, "k", True, 2, ("fma", "tc", "stream")),   # the SwiGLU pair
])
def test_grouped_body_rule(a, b, m, a_major, b_ok, panels, want):
    """The SwiGLU pair (``panels`` 2, each panel as op(B)) takes the rule
    of one panel."""
    assert K.grouped_bodies(a, b, m, a_major, b_ok) == want


@pytest.mark.parametrize("x,w,total,x_k,w_ok,panels,want", [
    (2, 2, 4, True, True, 1, ("fma", "tc", "stream")),    # llama4 decode
    (2, 2, 16, True, True, 1, ("fma", "tc", "stream")),
    (2, 2, 17, True, True, 1, ("fma", "tc")),
    (2, 2, 1024, True, True, 1, ("fma", "tc")),           # llama4 train
    (2, 2, 4, False, True, 1, ("fma",)),                  # x not K-major
    (2, 2, 4, True, False, 1, ("fma",)),
    (4, 2, 1024, True, True, 1, ("fma",)),                # fp32 cotangent
    (4, 4, 4, True, True, 1, ("fma",)),
    (2, 2, 4, True, True, 2, ("fma", "tc", "stream")),   # the SwiGLU pair
])
def test_ragged_body_rule(x, w, total, x_k, w_ok, panels, want):
    """The SwiGLU pair (``panels`` 2, each panel as W) takes the rule of
    one panel."""
    assert K.ragged_bodies(x, w, total, x_k, w_ok) == want


@pytest.mark.parametrize("g,rows,k,s_g,s_rows,s_k,want", [
    (8, 16, 14336, 16 * 14336, 14336, 1, "k"),      # A (G, M, K)
    (8, 4096, 14336, 14336 * 4096, 1, 4096, "mn"),  # B (G, K, N): N unit
    (8, 16, 14336, 0, 14336, 1, "k"),               # shared: a 2-D map
    (1, 16, 64, 3, 64, 1, "k"),                     # one group: 2-D
    (8, 16, 64, 16 * 64 + 4, 64, 1, None),          # group stride 8 bytes off
    (8, 16, 64, 15 * 64, 64, 1, None),              # panels overlap
    (8, 1, 72, 72, 999, 1, "k"),                    # one row: K padded to 72
    (8, 1, 70, 70, 999, 1, None),                   # ... 70 is not 16 bytes
])
def test_tma_major3_rule(g, rows, k, s_g, s_rows, s_k, want):
    assert K.tma_major3(0, g, rows, k, s_g, s_rows, s_k) == want


@pytest.mark.parametrize("trans", ["nn", "tn", "nt"])
@pytest.mark.parametrize("shared", ["none", "a", "b"])
def test_grouped_operands_follow_layout(trans, shared):
    g, m, k, n = 4, 16, 256, 128
    sa = {"nn": (m, k), "tn": (k, m), "nt": (m, k)}[trans]
    sb = {"nn": (k, n), "tn": (k, n), "nt": (n, k)}[trans]
    a = torch.zeros(sa if shared == "a" else (g,) + sa, dtype=BF16)
    b = torch.zeros(sb if shared == "b" else (g,) + sb, dtype=BF16)
    major, b_ok = K.grouped_operands(a, b, trans)
    assert (major, b_ok) == ("mn" if trans == "tn" else "k", True)
    # a group stride that is not a whole number of 16 bytes
    big = torch.zeros(g * (m * k + 4), dtype=BF16)
    a_odd = big.as_strided((g, m, k), (m * k + 4, k, 1))
    assert K.grouped_operands(a_odd, b if b.ndim == 3 else b.expand(
        (g,) + sb), "nn" if trans == "tn" else trans)[0] is None


def _grouped_b(trans, width, aligned, g=3, k=96, n=128):
    """op(B) of a grouped "nn" / "nt" / "tn" call of ``width`` bytes, laid
    out as the attention products lay it out (rows of the last dimension
    contiguous); misaligned: the same layout one element past a 16-byte
    boundary."""
    dtype = F32 if width == 4 else BF16
    shape = (g, n, k) if trans == "nt" else (g, k, n)
    numel = g * k * n
    base = torch.zeros(numel + 1, dtype=dtype)
    flat = base[:numel] if aligned else base[1:]
    return flat.view(shape)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("trans", ["nn", "nt", "tn"])
@pytest.mark.parametrize("m", [1, 7, 8, 9])
@pytest.mark.parametrize("a,b", [(4, 4), (2, 4), (4, 2), (2, 2)])
def test_grouped_rows_rule(a, b, m, trans, aligned):
    """The rows body is offered exactly for fp32 x fp32 of at most ROWS_MAX
    rows a group, trans "nn" or "nt", with B's rows as it reads them; every
    other call keeps the bodies it had."""
    b_rows = K.rows_operand(_grouped_b(trans, b, aligned))
    assert b_rows == aligned
    got = K.grouped_bodies(a, b, m, "k", True, trans=trans, b_rows=b_rows)
    want_rows = (a == b == 4 and m <= K.ROWS_MAX and trans != "tn"
                 and aligned)
    assert ("rows" in got) == want_rows, got
    assert tuple(x for x in got if x != "rows") == K.grouped_bodies(
        a, b, m, "k", True)
    # The SwiGLU pair passes no trans: never the rows body.
    assert "rows" not in K.grouped_bodies(a, b, m, "k", True, b_rows=b_rows)


def test_rows_operand_rule():
    """Unit stride along a row, the base 16-byte aligned, the row and group
    strides multiples of 4 elements; an extent of 1 takes any stride."""
    kv = torch.zeros(4, 96, 8, 128)                # (B, S, KVH, D) cache
    assert K.rows_operand(kv.permute(0, 2, 1, 3).reshape(32, 96, 128))
    assert K.rows_operand(kv[0].permute(1, 0, 2))  # a strided view
    assert K.rows_operand(torch.zeros(96, 128))    # shared 2-D
    assert not K.rows_operand(torch.zeros(4, 128, 96).transpose(1, 2))
    assert not K.rows_operand(torch.zeros(4, 96, 130)[:, :, :128])
    assert not K.rows_operand(torch.zeros(4 * 96 * 128 + 2)[2:].view(
        4, 96, 128))                               # base 8 bytes off
    odd_group = torch.zeros(3 * (96 * 128 + 2)).as_strided(
        (3, 96, 128), (96 * 128 + 2, 128, 1))
    assert not K.rows_operand(odd_group)
    assert K.rows_operand(torch.zeros(4, 1, 128).as_strided(
        (4, 1, 128), (128, 7, 1)))                 # one row: any row stride


def _decode_attention():
    """(label, G, M, head_dim, cache rows) of the decode attention products
    at 4 slots: PERF.md's rows 2 (qwen3-1.7b, 96 rows), 2r (zamba2's shared
    block, its 320-row slot cache), 2e (whisper-base, self over 320 rows
    and cross over a 1024-row block), 2v (llava-next-34b, the 896-row paged
    view), 2g (gemma3-4b, 1,120 rows), minitron-4b and qwen3-8b (96)."""
    rows = {"qwen3-1.7b": (96,), "zamba2-7b": (320,),
            "whisper-base": (320, 1024), "llava-next-34b": (896,),
            "gemma3-4b": (1120,), "minitron-4b": (96,), "qwen3-8b": (96,)}
    out = []
    for arch, views in rows.items():
        c = get_config(arch)
        for s in views:
            out.append((f"{arch} {s}", 4 * c.num_kv_heads,
                        c.num_heads // c.num_kv_heads, c.head_dim_, s))
    return out


@pytest.mark.parametrize("label,g,m,hd,s", _decode_attention())
def test_plan_takes_rows_at_decode_attention(label, g, m, hd, s):
    """QK^T ("nt", K = head_dim) and PV ("nn", K = the cache rows) of every
    decode attention product plan the rows body at its cut, priced within
    a few percent of the bytes bound; with B's rows misaligned they keep
    the FMA body."""
    assert 1 <= m <= K.ROWS_MAX, label
    for trans, k, n in (("nt", hd, s), ("nn", s, hd)):
        plan = plan_batched_gemm(g, m, k, n, 4, 4, "none", trans=trans)
        assert plan.body == "rows", (label, trans, plan)
        assert (plan.bm, plan.bn, plan.bk) == K.rows_tile(g, k, n, trans)
        bound = (g * k * n + g * m * k + g * m * n) * 4 / H100.hbm_bw
        assert plan.est.t_total <= 1.05 * bound, (
            label, trans, plan.est)
        assert plan.est.t_total == estimate_rows(
            g, m, k, n, bn=plan.bn, bk=plan.bk).t_total
        assert plan_batched_gemm(g, m, k, n, 4, 4, "none", trans=trans,
                                 b_rows=False).body == "fma"


def test_plan_keeps_fp32_training_attention_and_experts_on_fma():
    """fp32 products of more than ROWS_MAX rows a group keep the FMA body:
    qwen3-1.7b's training attention (32 groups of 128 rows, both trans) and
    mixtral's fp32 experts at decode capacity 16."""
    for trans in ("nt", "nn", "tn"):
        assert plan_batched_gemm(32, 128, 128, 128, 4, 4, "none",
                                 trans=trans).body == "fma"
    mix, e, d, f = _moe("mixtral-8x7b")
    for k, n in ((d, f), (f, d)):
        assert plan_batched_gemm(e, 16, k, n, 4, 4, "none").body == "fma"


def test_rows_tile_cuts_the_call_over_the_card():
    """"nt": strips of cache rows for about ROWS_CTAS CTAs, none under
    ROWS_MIN_STRIP rows nor over ROWS_STRIP_BYTES, K in slices of the row
    width; "nn": the narrowest column strips, K slices only past
    ROWS_SLICE_MIN_BYTES of a strip's cache rows, at most ROWS_SLICES_MAX
    of ROWS_SPAN_MAX rows or fewer."""
    for g, m, hd, s in ((32, 2, 128, 96), (16, 2, 256, 1120),
                        (128, 1, 112, 320), (32, 1, 64, 1024),
                        (32, 7, 128, 896)):
        bm, strip, width = K.rows_tile(g, hd, s, "nt")
        row = 4 * min(hd, width)
        assert bm == K.ROWS_MAX and width == K.rows_width(hd)
        assert K.ROWS_MIN_STRIP <= strip
        assert strip * row <= max(K.ROWS_STRIP_BYTES, K.ROWS_MIN_STRIP * row)
        strips = -(-s // strip)
        assert (g * strips >= min(K.ROWS_CTAS, g * -(-s // K.ROWS_MIN_STRIP))
                or strip * row > K.ROWS_STRIP_BYTES // 2)
        bm, width, span = K.rows_tile(g, s, hd, "nn")
        assert width == K.ROWS_WIDTHS[0]
        slices = -(-s // span)
        if 4 * s * min(hd, width) <= K.ROWS_SLICE_MIN_BYTES:
            assert slices == 1
        assert 1 <= slices <= K.ROWS_SLICES_MAX
        assert span <= K.ROWS_SPAN_MAX
    assert K.rows_tile(2, 600, 7, "nt")[2] == 256        # 3 K slices
    assert K.rows_tile(2, 40000, 7, "nn")[2] == K.ROWS_SPAN_MAX
    assert [K.rows_width(x) for x in (1, 64, 65, 128, 129, 256, 9999)] == [
        64, 64, 128, 128, 256, 256, 256]


def test_ragged_operands_follow_layout():
    x = torch.zeros(4, 512, dtype=BF16)
    w = torch.zeros(16, 512, 256, dtype=BF16)
    assert K.ragged_operands(x, w, "nn") == (True, True)
    assert K.ragged_operands(x, w.transpose(1, 2), "nt") == (True, True)
    assert K.ragged_operands(x.t().contiguous().t(), w, "nn")[0] is False
    assert K.ragged_operands(x[:, 1:257], w[:, :256], "nn")[0] is False


def _moe(arch):
    c = get_config(arch)
    return c, c.num_experts, c.d_model, c.d_ff


def _capacity(tokens, cfg):
    from repro_torch.models.moe import capacity
    return capacity(tokens, cfg.num_experts, cfg.top_k, cfg.capacity_factor,
                    dtype=BF16)


def test_plan_moe_decode_takes_the_stream():
    """mixtral's 16-row capacity buffers (4 decode slots) and llama4's 4
    routed rows: the expert-down product plans the grouped / ragged stream
    with its slices covering K, none empty."""
    mix, e, d, f = _moe("mixtral-8x7b")
    c = _capacity(4, mix)
    assert c == 16
    l4, e4, d4, f4 = _moe("llama4-scout-17b-a16e")
    plans = [(plan_batched_gemm(e, c, f, d, 2, 2, "none"), f),
             (plan_ragged_gemm(e4, 4, f4, d4, 2, 2), f4)]
    for plan, k in plans:
        assert plan.body == "stream" and plan.bm == K.GSTREAM_ROWS
        assert plan.bn == K.STREAM_STRIP and plan.nsplit == 1
        sl, slices = K.stream_slice(k, plan.kslices)
        assert (sl, slices) == (plan.bk, plan.kslices)
        assert (slices - 1) * sl < k <= slices * sl
        assert plan.est.smem_bytes == K.gstream_smem()


def test_plan_moe_prefill_and_train_take_tensor_cores():
    """mixtral's bucket-prefill and training capacities (48, 80, 320) and
    llama4's 256 / 1024 routed rows, bf16: forward, remat (fp32 out), dX
    ("nt") and the grouped dW ("tn") plan the tensor cores."""
    mix, e, d, f = _moe("mixtral-8x7b")
    for tokens in (128, 256, 1024):
        c = _capacity(tokens, mix)
        for (m, k, n), major in (((c, f, d), "k"), ((c, d, f), "k"),
                                 ((f, c, d), "mn")):
            for out in (2, 4):
                plan = plan_batched_gemm(e, m, k, n, 2, out, "none",
                                         a_major=major)
                assert plan.body == "tc", (tokens, m, k, n, plan)
                assert (plan.bm, plan.bn, plan.bk) == K.GROUP_TC_TILE
    l4, e4, d4, f4 = _moe("llama4-scout-17b-a16e")
    for t in (256, 1024):
        for k, n in ((f4, d4), (d4, f4)):
            for out in (2, 4):
                plan = plan_ragged_gemm(e4, t, k, n, 2, out)
                assert plan.body == "tc", (t, k, n, plan)
                assert (plan.bm, plan.bn, plan.bk) == K.GROUP_TC_TILE


def test_plan_keeps_attention_mixed_and_swiglu_on_fma():
    """fp32 attention of more than ROWS_MAX rows a group (QK^T and PV
    groups at prefill and training) and the mixed bf16 x fp32 pairs plan
    the FMA body at every MoE shape, and so does the fp32 dense SwiGLU pair
    at qwen's decode and training rows (its bf16 plans:
    ``test_plan_dense_swiglu_pair_takes_the_stream_and_tensor_cores``);
    qwen's decode PV, 2 rows a group, takes the rows body."""
    mix, e, d, f = _moe("mixtral-8x7b")
    l4, e4, d4, f4 = _moe("llama4-scout-17b-a16e")
    for g, m, k, n, body in ((32, 2, 128, 96, "rows"),
                             (32, 128, 128, 128, "fma"),
                             (32, 128, 128, 64, "fma")):
        assert plan_batched_gemm(g, m, k, n, 4, 4, "none").body == body
    for c in (16, 320):
        for a, b in ((2, 4), (4, 2), (4, 4)):
            plan = plan_batched_gemm(e, c, f, d, a, 4, "none", b_bytes=b)
            assert plan.body == "fma" and (plan.bm, plan.bn, plan.bk) in K.TILES
    for t in (4, 1024):
        for a, b in ((2, 4), (4, 2), (4, 4)):
            assert plan_ragged_gemm(e4, t, f4, d4, a, 4,
                                    b_bytes=b).body == "fma"
        assert plan_ragged_gemm(e4, t, f4, d4, 2, 2, a_ok=False).body == "fma"
    qwen, dq, fq = get_config("qwen3-1.7b"), 2048, 6144
    assert (qwen.d_model, qwen.d_ff) == (dq, fq)
    for m in (4, 1024):
        assert plan_gemm(m, dq, fq, 4, 4, panels=2).body == "fma"


def test_plan_dense_swiglu_pair_takes_the_stream_and_tensor_cores():
    """qwen's dense gate/up pair plans the group stream with one group at
    its 4 decode rows (the stream's shared memory: both panels' ring), the
    pair tile on the tensor cores at the 128 / 256-row bucket prefills and
    the 1024 training rows (both panels' 48 KB stages); fp32, an x TMA
    cannot read K-major and panels it cannot read plan the FMA body."""
    qwen, dq, fq = get_config("qwen3-1.7b"), 2048, 6144
    assert (qwen.d_model, qwen.d_ff) == (dq, fq)
    stream = plan_gemm(4, dq, fq, 2, 2, panels=2)
    assert stream.body == "stream" and stream.nsplit == 1
    assert (stream.bm, stream.bn) == (K.GSTREAM_ROWS, K.STREAM_STRIP)
    assert stream.est.smem_bytes == K.gstream_smem(2)
    assert K.stream_slice(dq, stream.kslices) == (stream.bk, stream.kslices)
    for m in (128, 256, 1024):
        tc = plan_gemm(m, dq, fq, 2, 2, panels=2)
        assert tc.body == "tc", (m, tc)
        assert (tc.bm, tc.bn, tc.bk) == K.GROUP_TC_TILE
        assert tc.est.smem_bytes == K.smem_bytes(*K.GROUP_TC_TILE, 2,
                                                 body="tc")
    for m in (4, 1024):
        assert plan_gemm(m, dq, fq, 4, 4, panels=2).body == "fma"
        assert plan_gemm(m, dq, fq, 2, 2, panels=2, a_ok=False).body == "fma"
        assert plan_gemm(m, dq, fq, 2, 2, panels=2, b_ok=False).body == "fma"


def test_plan_swiglu_pairs_take_the_new_bodies():
    """The grouped and ragged SwiGLU pairs plan the bodies of one panel:
    mixtral's 16-row decode capacity the stream (a shared 2-D x too), its
    bucket-prefill and training capacities (48, 80, 320) the tensor cores,
    fp32 the FMA body; llama4's 4 routed decode rows the stream, 256 and
    1024 the tensor cores.  Each plan prices both panels' shared memory."""
    mix, e, d, f = _moe("mixtral-8x7b")
    for tokens, body in ((4, "stream"), (128, "tc"), (256, "tc"),
                         (1024, "tc")):
        c = _capacity(tokens, mix)
        for shared in ("none", "a"):
            plan = plan_batched_gemm(e, c, d, f, 2, 2, shared, panels=2)
            assert plan.body == body, (c, shared, plan)
        assert plan_batched_gemm(e, c, d, f, 4, 4, "none",
                                 panels=2).body == "fma"
    assert [_capacity(t, mix) for t in (4, 128, 256, 1024)] == [16, 48, 80,
                                                                 320]
    stream = plan_batched_gemm(e, 16, d, f, 2, 2, "none", panels=2)
    assert stream.bm == K.GSTREAM_ROWS and stream.bn == K.STREAM_STRIP
    assert stream.est.smem_bytes == K.gstream_smem(2)
    tc = plan_batched_gemm(e, 320, d, f, 2, 2, "none", panels=2)
    assert (tc.bm, tc.bn, tc.bk) == K.GROUP_TC_TILE
    assert tc.est.smem_bytes == K.smem_bytes(*K.GROUP_TC_TILE, 2, body="tc")
    l4, e4, d4, f4 = _moe("llama4-scout-17b-a16e")
    for t, body in ((4, "stream"), (256, "tc"), (1024, "tc")):
        assert plan_ragged_gemm(e4, t, d4, f4, 2, 2,
                                panels=2).body == body, t
        assert plan_ragged_gemm(e4, t, d4, f4, 4, 4, panels=2).body == "fma"
        assert plan_ragged_gemm(e4, t, d4, f4, 2, 2, panels=2,
                                a_ok=False).body == "fma"


def test_swiglu_pair_shared_memory_fits_a_block():
    """The pair's stream CTA (a 34 KB stage: two weight boxes and the x
    box) and its tensor-core CTA (a 48 KB stage of x and both 128-column
    panel boxes) fit a block's 227 KB, and each stage stays 1 KB aligned."""
    stage = 2 * K.STREAM_STRIP * 64 * 2 + K.GSTREAM_ROWS * 64 * 2
    assert stage == 34 * 1024
    assert K.GSTREAM_STAGES * stage < K.gstream_smem(2) <= H100.smem_per_block
    assert K.gstream_smem(2) > 2 * K.gstream_smem(1) - 16 * 1024
    bm, bn, bk = K.GROUP_TC_TILE
    assert (bm * bk + 2 * bn * bk) * 2 == 48 * 1024
    pair = K.smem_bytes(bm, bn, bk, 2, body="tc",
                        stages=K.TC_STAGES["ftimm_gemm_grouped"])
    assert pair == K.smem_bytes(bm, 2 * bn, bk, body="tc")   # Tile<256, 4>
    assert pair <= H100.smem_per_block


@pytest.mark.parametrize("panels", [1, 2])
@pytest.mark.parametrize("k,kslices", [(4096, 1), (4096, 4), (1032, 3)])
def test_stream_workspace_holds_each_panels_partials(monkeypatch, panels, k,
                                                     kslices):
    """The grouped / ragged stream keeps each panel's fp32 partials (the
    SwiGLU pair: both, summed apart before silu): a (slices, panels x rows,
    N) workspace and a counter per (group, strip), none at one slice."""
    monkeypatch.setattr(K, "_counters",
                        lambda device, n: torch.zeros(n, dtype=torch.int32))
    rows, n, groups = 8 * 16, 264, 8
    sl, slices, ws, counters = K._stream_plan(
        "ftimm_gemm_grouped_swiglu", torch.device("cpu"), k, kslices, rows,
        n, groups, panels)
    assert (sl, slices) == K.stream_slice(k, kslices)
    if slices == 1:
        assert ws is None and counters is None
    else:
        assert tuple(ws.shape) == (slices, panels * rows, n)
        assert ws.dtype == torch.float32
        assert counters.numel() == groups * -(-n // K.STREAM_STRIP)


def test_group_stream_ring_fits_shared_memory():
    """The ring's shared memory (the stages, the staging tile, the
    barriers, the alignment slack) fits a block's 227 KB."""
    stage = K.STREAM_STRIP * 64 * 2 + K.GSTREAM_ROWS * 64 * 2
    assert stage % 1024 == 0                   # boxes stay 1 KB aligned
    got = K.gstream_smem()
    assert K.GSTREAM_STAGES * stage < got <= H100.smem_per_block


@pytest.mark.parametrize("k", [1032, 8192, 14336, 5120, 64, 65])
@pytest.mark.parametrize("kslices", [1, 2, 3, 4, 8, 16])
def test_group_stream_slices_cover_k(k, kslices):
    sl, slices = K.stream_slice(k, kslices)
    assert sl % K.STREAM_SLICE_STEP == 0 and 1 <= slices <= kslices
    assert (slices - 1) * sl < k <= slices * sl


def test_group_stream_slices_fill_the_card():
    """At the MoE decode shapes the planned grid (strips x slices x reached
    groups) fills the card's 132 SMs, and fewer slices win where it does."""
    from repro_torch.core.gemm import estimate_group_stream
    for groups, rows, k, n in ((8, 128, 14336, 4096), (4, 4, 8192, 5120)):
        if rows == 4:
            plan = plan_ragged_gemm(16, rows, k, n, 2, 2)
        else:
            plan = plan_batched_gemm(groups, rows // groups, k, n, 2, 2,
                                     "none")
        ctas = groups * -(-n // K.STREAM_STRIP) * plan.kslices
        assert ctas >= H100.sms
        more = estimate_group_stream(groups, rows, k, n,
                                     kslices=plan.kslices * 2)
        assert more.t_total >= plan.est.t_total


@pytest.mark.parametrize("body", ["tc", "stream"])
def test_grouped_and_ragged_cpu_tensors_take_the_plain_version(body):
    """The device decides: on the CPU every body of the grouped and ragged
    kernels is the plain version, and no launch is counted."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 4, 96, generator=g).to(BF16)
    b = torch.randn(3, 96, 40, generator=g).to(BF16)
    x = torch.randn(5, 96, generator=g).to(BF16)
    offs = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    K.reset_launch_counts()
    got = K.ftimm_gemm_grouped(a, b, bm=128, bn=128, bk=64, body=body,
                               kslices=3)
    assert torch.equal(got, K.ftimm_gemm_grouped_plain(a, b))
    got = K.ftimm_gemm_ragged(x, b, offs, bm=128, bn=128, bk=64, body=body,
                              kslices=3)
    assert torch.equal(got, K.ftimm_gemm_ragged_plain(x, b, offs))
    assert not got[4:].any()
    assert K.launch_counts()["ftimm_gemm_grouped"] == 0
    assert K.launch_counts()["ftimm_gemm_ragged"] == 0
    for kernel in ("ftimm_gemm_grouped", "ftimm_gemm_ragged"):
        assert sum(K.body_counts()[kernel].values()) == 0


@pytest.mark.parametrize("body", ["tc", "stream", "fma"])
def test_swiglu_pairs_cpu_tensors_take_the_plain_version(body):
    """The device decides for the pairs too: on the CPU every body of the
    three SwiGLU pairs, and the split-K kernel's "fma" and "tc", is the
    plain version, and no launch is counted."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 96, generator=g).to(BF16)
    wg = torch.randn(3, 96, 40, generator=g).to(BF16)
    wu = torch.randn(3, 96, 40, generator=g).to(BF16)
    xr = torch.randn(5, 96, generator=g).to(BF16)
    offs = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    K.reset_launch_counts()
    for xg in (x, x[0]):
        got = K.ftimm_gemm_grouped_swiglu(xg, wg, wu, bm=128, bn=128, bk=64,
                                          body=body, kslices=3)
        assert torch.equal(got, K.ftimm_gemm_grouped_swiglu_plain(xg, wg, wu))
    got = K.ftimm_gemm_ragged_swiglu(xr, wg, wu, offs, bm=128, bn=128,
                                     bk=64, body=body, kslices=3)
    assert torch.equal(got,
                       K.ftimm_gemm_ragged_swiglu_plain(xr, wg, wu, offs))
    assert not got[4:].any()
    got = K.ftimm_gemm_swiglu(x[0], wg[0], wu[0], bm=128, bn=128, bk=64,
                              body=body, kslices=3)
    assert torch.equal(got, K.ftimm_gemm_swiglu_plain(x[0], wg[0], wu[0]))
    kernels = ["ftimm_gemm_swiglu", "ftimm_gemm_grouped_swiglu",
               "ftimm_gemm_ragged_swiglu"]
    if body != "stream":
        a, b = x[0].t().contiguous(), wg[0]          # tn: a (K, M)
        got = K.ftimm_gemm_splitk(a, b, bm=128, bn=128, bk=64, nsplit=3,
                                  trans="tn", body=body)
        assert torch.equal(got, K.ftimm_gemm_splitk_plain(
            a, b, bk=64, nsplit=3, trans="tn"))
        kernels.append("ftimm_gemm_splitk")
    for kernel in kernels:
        assert K.launch_counts()[kernel] == 0
        assert sum(K.body_counts()[kernel].values()) == 0


def test_split_k_takes_the_fma_and_tc_bodies_not_the_stream():
    """``ops.gemm`` with nsplit > 1 passes its body to the split-K kernel
    -- the FMA tile clamped to the menu, the tensor-core tile as given, K
    cut at the tile's bk -- and raises for the stream body, which splits K
    its own way."""
    from repro_torch.kernels.ftimm import ops
    g = torch.Generator().manual_seed(2)
    a = torch.randn(256, 24, generator=g).to(BF16)
    b = torch.randn(256, 40, generator=g).to(BF16)
    with pytest.raises(ValueError, match="stream"):
        ops.gemm(a, b, trans="tn", nsplit=4, body="stream")
    calls, splitk = [], K.ftimm_gemm_splitk

    def spy(*args, **kw):
        calls.append((kw["body"], kw["bk"], kw["nsplit"]))
        return splitk(*args, **kw)

    K.ftimm_gemm_splitk = spy
    try:
        for body, bk in (("fma", 16), ("tc", 64)):
            got = ops.gemm(a, b, bm=128, bn=128, bk=bk, trans="tn", nsplit=8,
                           body=body)
            assert torch.equal(got, K.ftimm_gemm_splitk_plain(
                a, b, bk=calls[-1][1], nsplit=calls[-1][2], trans="tn"))
    finally:
        K.ftimm_gemm_splitk = splitk
    # The FMA tile for 24 x 40 is the 32 x 64 tile (bk 32): 8 K blocks;
    # the tensor-core tile's bk of 64 gives 4.
    assert calls == [("fma", 32, 8), ("tc", 64, 4)]


@pytest.mark.parametrize("symbol,group", [
    ("void ftimm::gs::group_stream_kernel<ftimm_gemm_grouped_swiglu_stream, "
     "true, __nv_bfloat16, 2>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, ftimm::gs::Args)", "ftimm_gemm_grouped_swiglu stream"),
    ("void ftimm_gemm_grouped_swiglu_tc_kernel<false, true, __nv_bfloat16>"
     "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, PairTcArgs)",
     "ftimm_gemm_grouped_swiglu tensor cores"),
    ("void ftimm_gemm_grouped_swiglu_kernel<ftimm::TileCfg<16, 32, 64, 2, 2>,"
     " float, float>(GroupedSwigluArgs)", "ftimm_gemm_grouped_swiglu"),
    ("void ftimm::gs::group_stream_kernel<ftimm_gemm_ragged_swiglu_stream, "
     "true, float, 2>(CUtensorMap_st)", "ftimm_gemm_ragged_swiglu stream"),
    ("void ftimm_gemm_ragged_swiglu_tc_kernel<true, __nv_bfloat16>"
     "(CUtensorMap_st)", "ftimm_gemm_ragged_swiglu tensor cores"),
    ("void ftimm::gs::group_stream_kernel<ftimm_gemm_grouped_stream, true, "
     "__nv_bfloat16, 1>(CUtensorMap_st)", "ftimm_gemm_grouped stream"),
    ("void ftimm::gs::group_stream_kernel<ftimm_gemm_ragged_stream, true, "
     "__nv_bfloat16, 1>(CUtensorMap_st)", "ftimm_gemm_ragged stream"),
    ("void ftimm::gs::group_stream_kernel<ftimm_gemm_swiglu_stream, true, "
     "__nv_bfloat16, 2>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "ftimm::gs::Args)", "ftimm_gemm_swiglu stream"),
    ("void ftimm_gemm_swiglu_tc_kernel<true, __nv_bfloat16>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, PairTcArgs)",
     "ftimm_gemm_swiglu tensor cores"),
    ("void ftimm_gemm_swiglu_kernel<ftimm::TileCfg<16, 32, 64, 2, 2>, "
     "__nv_bfloat16, __nv_bfloat16>(SwigluArgs)", "ftimm_gemm_swiglu"),
    ("void ftimm_gemm_splitk_tc_kernel<ftimm::tc::Tile<128, 4>, true, true, "
     "__nv_bfloat16>(CUtensorMap_st, CUtensorMap_st, SplitkTcArgs)",
     "ftimm_gemm_splitk tensor cores"),
    ("void ftimm_gemm_splitk_kernel<ftimm::TileCfg<128, 128, 16, 8, 8>, "
     "__nv_bfloat16, float>(SplitkArgs)", "ftimm_gemm_splitk"),
])
def test_profile_groups_name_each_body(symbol, group):
    """``profile_serve`` files each body's kernel symbol under its own
    kernel and body, the pairs' before the one-panel kernels'."""
    from repro_torch.launch.profile_serve import group_of
    assert group_of(symbol) == group


def _c_entries() -> dict[str, list]:
    """{entry key: ctypes of its parameters} from the ``extern "C"``
    signatures in csrc/*.cu."""
    import ctypes
    import re
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    entries = {}
    for src in sorted(K.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)_launch\((.*?)\)',
                                       src.read_text(), re.S):
            types = []
            for p in params.split(","):
                decl = " ".join(p.split()).rsplit(" ", 1)[0]
                types.append(ctypes.c_void_p if "*" in p
                             else ctype[decl.replace("const ", "")])
            entries[name] = types
    return entries


@pytest.mark.parametrize("key", sorted(K._ARGTYPES))
def test_ctypes_signatures_match_the_c_entries(key):
    """Each C entry's ctypes argument list (kernel._ARGTYPES) has the
    entry's parameters, in order: a mismatch would pass wrong values to the
    kernel without an error."""
    entries = _c_entries()
    assert sorted(entries) == sorted(K._ARGTYPES)
    assert entries[key] == K._ARGTYPES[key]
