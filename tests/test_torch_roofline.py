"""The port's analytic roofline (``repro_torch.roofline``) against the JAX
package's: train steps bucket by bucket equal, decode and prefill equal
but for the weights (the panels the reference counts twice, the hybrid's
shared block at each application, the encoder a decode step does not
read; pinned by value),
and the FLOPs of the port's own train step, counted on the CPU, inside the
reference's validation band."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.configs.base import ShapeConfig as JShape
from repro.roofline import analysis as janalysis
from repro.roofline.perf_model import step_perf as jstep_perf
from repro_torch.configs import SHAPES, ShapeConfig, applicable, get_config
from repro_torch.configs.registry import list_archs
from repro_torch.core.gemm.cmr import H100
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.roofline import (build_roofline, forward_perf,
                                  model_flops_estimate, step_perf)
from repro_torch.roofline import perf_model as P
from repro_torch.train import make_train_step

ARCHS = list_archs()
CONFIGS = ARCHS + [a + "-smoke" for a in ARCHS]
SMALL_TRAIN = ShapeConfig("small", seq_len=256, global_batch=4, kind="train")
SMALL_DECODE = ShapeConfig("d", seq_len=80, global_batch=4, kind="decode")
# The buckets whose weight panels the port counts once, in ``weights``.
PANEL_BUCKETS = ("mlp", "moe_mlp", "ssm_proj", "weights")


def _both(name, **kw):
    return (dataclasses.replace(get_config(name), **kw),
            dataclasses.replace(jget_config(name), **kw))


def _jshape(shape):
    return JShape(shape.name, shape.seq_len, shape.global_batch, shape.kind)


def _close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1.0)


def test_shapes_are_the_references():
    assert SHAPES.keys() == jshapes.SHAPES.keys()
    for name, shape in SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(
            jshapes.SHAPES[name])
        for arch in ARCHS:
            assert applicable(get_config(arch), shape) == jshapes.applicable(
                jget_config(arch), jshapes.SHAPES[name])


@pytest.mark.parametrize("shape", [SHAPES["train_4k"], SMALL_TRAIN],
                         ids=["train_4k", "small"])
@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_equals_the_reference(name, shape):
    cfg, jcfg = _both(name)
    got, want = step_perf(cfg, shape), jstep_perf(jcfg, _jshape(shape))
    assert got.breakdown.keys() == want.breakdown.keys()
    for key, (f, b, i) in got.breakdown.items():
        wf, wb, wi = want.breakdown[key]
        assert _close(f, wf) and _close(b, wb) and i == wi == 0, key
    assert _close(got.flops, want.flops)
    assert _close(got.bytes_hbm, want.bytes_hbm)


def _panel_bytes(cfg, bucket, kind):
    """What the reference's per-layer ``bucket`` adds for its weight panels
    in a step of ``kind`` (its perf_model.py: the MLP, expert and SSM
    projection panels; the encoder's MLPs run at prefill only)."""
    d, f = cfg.d_model, cfg.d_ff
    if bucket == "mlp":
        layers = (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid"
                  else cfg.num_layers)
        if cfg.family == "encdec" and kind != "decode":
            layers += cfg.encoder_layers
        return 3 * d * f * 2 * layers
    if bucket == "moe_mlp":
        return 3 * d * f * 2 * cfg.num_experts * cfg.num_layers
    di, hh, n = P.ssm_dims(d, cfg.ssm_state)
    return (d * (2 * di + 2 * n + hh) + di * d) * 4 * cfg.num_layers


@pytest.mark.parametrize("shape", [SHAPES["decode_32k"],
                                   SHAPES["prefill_32k"], SMALL_DECODE],
                         ids=["decode_32k", "prefill_32k", "decode_4x80"])
@pytest.mark.parametrize("name", ARCHS)
def test_serving_steps_differ_only_in_the_weight_panels(name, shape):
    cfg, jcfg = _both(name, param_dtype="bfloat16")
    got, want = step_perf(cfg, shape), jstep_perf(jcfg, _jshape(shape))
    assert got.breakdown.keys() == want.breakdown.keys()
    for key, (f, b, _) in got.breakdown.items():
        wf, wb, _ = want.breakdown[key]
        assert _close(f, wf), key
        if key not in PANEL_BUCKETS:
            assert _close(b, wb), key
        elif key != "weights":
            assert _close(b, wb - _panel_bytes(cfg, key, shape.kind)), key
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    reached = P.experts_reached(cfg, tokens)
    expert_params = (3 * cfg.d_model * cfg.d_ff * cfg.num_layers
                     * (cfg.num_experts - reached))
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_
    block = 2 * d * q + 2 * d * kv + 3 * d * f
    reads = cfg.param_count() - expert_params
    if cfg.family == "hybrid":
        reads += (cfg.num_layers // cfg.attn_every - 1) * block
    if cfg.family == "encdec" and shape.kind == "decode":
        reads -= cfg.encoder_layers * block + cfg.num_layers * 2 * d * kv
    assert got.breakdown["weights"][1] == 2 * reads


def test_qwen_decode_pinned_by_value():
    """qwen3-1.7b, bf16, 4 sequences over 80 cache rows: the reference
    prices 5.598 GB a step, 2.115 GB of it the MLP panels a second time."""
    cfg, jcfg = _both("qwen3-1.7b", param_dtype="bfloat16")
    got, want = step_perf(cfg, SMALL_DECODE), jstep_perf(
        jcfg, _jshape(SMALL_DECODE))
    assert want.bytes_hbm == 5_598_107_648
    assert want.breakdown["mlp"][1] == 2_114_846_720
    assert want.breakdown["mlp"][1] - got.breakdown["mlp"][1] == \
        3 * 2048 * 6144 * 2 * 28
    assert got.bytes_hbm == 3_484_178_432
    assert got.breakdown["weights"][1] == want.breakdown["weights"][1] \
        == 3_440_902_144
    assert got.bytes_hbm / H100.hbm_bw == pytest.approx(1.04005e-3, rel=1e-4)


def test_llama4_decode_reads_only_the_experts_its_rows_reach():
    """llama4-scout at 8 layers, 4 decode rows of top-1 routing: 4 of 16
    experts a layer (the reference counts all 16, twice)."""
    cfg, jcfg = _both("llama4-scout-17b-a16e", num_layers=8,
                      param_dtype="bfloat16")
    got, want = step_perf(cfg, SMALL_DECODE), jstep_perf(
        jcfg, _jshape(SMALL_DECODE))
    assert P.experts_reached(cfg, 4) == 4
    panel = 3 * cfg.d_model * cfg.d_ff * 2 * cfg.num_layers
    assert got.breakdown["weights"][1] == \
        want.breakdown["weights"][1] - 12 * panel
    assert got.bytes_hbm == pytest.approx(11.146e9, rel=1e-3)
    assert want.bytes_hbm == pytest.approx(67.518e9, rel=1e-3)
    # Capacity dispatch pads every expert's buffer: all E are read.
    mix = get_config("mixtral-8x7b")
    assert P.experts_reached(mix, 4) == mix.num_experts


def test_zamba2_reads_its_shared_block_at_each_application():
    """zamba2-7b, 4 decode rows: 81 // 6 = 13 applications of the one
    shared attention + MLP block, each a read of its panels."""
    cfg = get_config("zamba2-7b")
    block = 4 * 3584 * 3584 + 3 * 3584 * 14336
    assert cfg.param_count() * 2 == 13_265_158_144
    for shape in (SMALL_DECODE, dataclasses.replace(SMALL_DECODE,
                                                    kind="prefill")):
        weights = step_perf(cfg, shape).breakdown["weights"][1]
        assert weights == 13_265_158_144 + 12 * block * 2 == 18_197_659_648


def test_whisper_decode_reads_no_encoder_weights():
    """whisper-base, 4 decode rows: the decode step reads neither the
    6-layer encoder nor the cross K / V projections (its prefill cached
    their output); the prefill reads every parameter."""
    cfg = get_config("whisper-base")
    encoder = 6 * (4 * 512 * 512 + 3 * 512 * 2048)
    cross_kv = 6 * 2 * 512 * 512
    assert cfg.param_count() * 2 == 166_363_136
    decode = step_perf(cfg, SMALL_DECODE).breakdown["weights"][1]
    assert decode == 166_363_136 - 2 * (encoder + cross_kv) == 109_740_032
    prefill = step_perf(cfg, dataclasses.replace(
        SMALL_DECODE, kind="prefill")).breakdown["weights"][1]
    assert prefill == 166_363_136


@pytest.mark.parametrize("name", ARCHS)
def test_breakdown_covers_the_totals(name):
    cfg = get_config(name)
    for shape in (SHAPES["train_4k"], SHAPES["decode_32k"], SMALL_DECODE):
        p = step_perf(cfg, shape)
        assert sum(v[0] for v in p.breakdown.values()) == pytest.approx(
            p.flops, rel=1e-9)
        assert sum(v[1] for v in p.breakdown.values()) == pytest.approx(
            p.bytes_hbm, rel=1e-9)


def test_decode_bytes_are_weights_and_cache():
    p = step_perf(get_config("qwen3-8b"), SHAPES["decode_32k"])
    wk = p.breakdown["weights"][1] + p.breakdown["attn_score"][1]
    assert wk > 0.8 * p.bytes_hbm
    assert p.breakdown["kv_cache_write"][1] < 0.01 * p.bytes_hbm
    # MoE: top-1 llama4 far below a dense model of all its experts.
    m = get_config("llama4-scout-17b-a16e")
    assert step_perf(m, SHAPES["train_4k"]).flops < \
        0.5 * 6 * m.param_count() * SHAPES["train_4k"].tokens


def test_roofline_terms_on_the_h100():
    cfg = get_config("qwen3-1.7b")
    p = step_perf(cfg, SMALL_DECODE)
    mf = model_flops_estimate(cfg, SMALL_DECODE, "decode")
    r = build_roofline(arch=cfg.name, shape=SMALL_DECODE.name,
                       analytic_flops=p.flops, analytic_bytes=p.bytes_hbm,
                       model_flops=mf)
    assert r.t_compute == p.flops / 989e12
    assert r.t_memory == p.bytes_hbm / 3.35e12
    assert r.t_collective == 0.0 and r.coll_by_type == {}
    assert r.dominant == "memory" and r.t_bound == r.t_memory
    assert r.roofline_fraction == pytest.approx(mf / (989e12 * r.t_memory))
    assert r.to_dict()["roofline_fraction"] == r.roofline_fraction
    for name in ARCHS:
        for shape in (SHAPES["train_4k"], SHAPES["prefill_32k"],
                      SMALL_DECODE):
            c, jc = _both(name)
            assert model_flops_estimate(c, shape, shape.kind) == \
                janalysis.model_flops_estimate(jc, _jshape(shape), shape.kind)


def test_forward_perf_keeps_the_panels_only_in_train():
    cfg = get_config("qwen3-1.7b")
    train = forward_perf(cfg, 4, 80, "train").breakdown["mlp"][1]
    prefill = forward_perf(cfg, 4, 80, "prefill").breakdown["mlp"][1]
    assert train - prefill == _panel_bytes(cfg, "mlp", "prefill")


def _medium(name):
    """The reference test's medium config (tests/test_perf_model.py), in
    fp32 so that the CPU runs its train step in seconds."""
    c0 = get_config(name + "-smoke")
    return dataclasses.replace(
        c0, d_model=512, num_heads=8 if c0.num_heads else 0,
        num_kv_heads=4 if c0.num_kv_heads else 0,
        head_dim=64 if c0.num_heads else 0,
        d_ff=2048 if c0.d_ff else 0, vocab_size=32768, scan_unroll=True,
        remat="none", num_layers=2, attn_every=0, ssm_chunk=64,
        encoder_layers=2 if c0.encoder_layers else 0,
        encoder_seq=128 if c0.encoder_seq else 0,
        num_patches=32 if c0.num_patches else 0, compute_dtype="float32")


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b"])
def test_train_flops_validate_against_the_counted_step(arch):
    cfg = _medium(arch)
    shape = ShapeConfig("probe", seq_len=512, global_batch=2, kind="train")
    model = M.init_params(cfg, 0, device="cpu", dtype="float32")
    opt = init_opt_state(dict(model.named_parameters()))
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 512), generator=g)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as counter:
        make_train_step(cfg, OptConfig())(model, opt, batch)
    counted = counter.get_total_flops()
    analytic = step_perf(cfg, shape).flops
    assert 0.75 < analytic / counted < 1.15, (analytic, counted)
