"""The production-mesh dry run (``repro_torch.launch.dryrun``), the record
of collectives and ``roofline.dissect``, held against the JAX package on
the CPU.

  * ``argument_size`` -- rank 0's parameter, optimizer, batch, cache and
    ``pos`` bytes -- equals the per-device bytes of the reference's own
    ``param_specs`` / ``batch_specs`` / ``cache_specs`` over a
    ``jax.sharding.AbstractMesh`` (``NamedSharding.shard_shape`` of each
    leaf, no devices) for the two cells the reference committed
    (812,548 B and 4,797,494,308 B, also read from its artifacts) and for
    ``zero1``, ``serve_tp`` and ``l4_ep_model``; where the port's cache
    layout differs (the SSM state and conv window, the cross K / V), the
    stated byte difference is pinned;
  * the committed ``qwen3-1.7b-smoke__train_4k`` cell: its perf
    breakdown and model FLOPs equal the reference artifact's, and the
    port's committed cells hold the reference's argument sizes;
  * ``VARIANTS`` equals the reference's, dict for dict (read from its
    source: importing it would set ``XLA_FLAGS`` for the process);
  * ``make_production_mesh``'s shapes and axes;
  * one gloo world of 4 CPU ranks (``torch_world``), mesh (2, 2) at smoke
    size: a ZeRO-3 + TP train step, a TP decode step with its KV cache and
    an expert-parallel train step record the same collectives -- op,
    bytes and axes, call for call -- as the same cell lowered on
    ``Mesh.abstract((2, 2))``, and the same argument bytes;
  * the abstract mesh's collectives (twin results, the record, the dense
    exchange), ``collective_bytes``' wire convention and ``dissect``'s
    order and total.
"""
import ast
import dataclasses
import json
import math
import os
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim.adamw import init_opt_state as jinit_opt  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.gemm import collective as C  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.roofline.analysis import (build_roofline,  # noqa: E402
                                           collective_bytes)
from repro_torch.roofline.dissect import dissect, format_rows  # noqa: E402
from torch_world import World  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_RESULTS = os.path.join(ROOT, "results", "dryrun")
PORT_RESULTS = os.path.join(ROOT, "results", "torch_dryrun")
QWEN_CELL = "qwen3-1.7b-smoke__train_4k__pod16x16__baseline"
L4_CELL = "llama4-scout-17b-a16e__decode_32k__pod16x16__ep_moe"


def _ref_variants() -> dict:
    """The reference's ``VARIANTS``, read from its source."""
    src = open(os.path.join(ROOT, "src", "repro", "launch",
                            "dryrun.py")).read()
    for node in ast.parse(src).body:
        if isinstance(node, ast.AnnAssign) and node.target.id == "VARIANTS":
            return ast.literal_eval(node.value)
    raise AssertionError("no VARIANTS in the reference's dry run")


def _ref_bytes(arch, shape_name, variant, *, cache_fn=None) -> int:
    """The reference's per-device argument bytes of a cell: its specs over
    an ``AbstractMesh``, each leaf's ``NamedSharding.shard_shape``."""
    knobs = dict(_ref_variants()[variant])
    cfg = jget_config(arch)
    if "cfg" in knobs:
        cfg = dataclasses.replace(cfg, **knobs["cfg"])
    mesh = AbstractMesh(tuple(knobs.get("mesh", (16, 16))),
                        ("data", "model"))
    kw = dict(moe_ep=knobs.get("moe_ep", False),
              moe_ep_axis=knobs.get("moe_ep_axis", "dp"))
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    sds = jax.ShapeDtypeStruct
    params = jax.eval_shape(lambda k: jmodel.init_params(cfg, k),
                            sds((2,), jnp.uint32))

    def nbytes(tree, specs):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
        return sum(math.prod(NamedSharding(mesh, sp).shard_shape(x.shape))
                   * jnp.dtype(x.dtype).itemsize
                   for x, sp in zip(leaves, spec_leaves))

    total = nbytes(params, jsharding.param_specs(
        params, mesh, zero_stage=knobs.get("zero_stage", 3), **kw))
    if shape.kind == "train":
        opt = jax.eval_shape(jinit_opt, params)
        total += nbytes(opt, jsharding.param_specs(opt, mesh, zero_stage=3,
                                                   **kw))
        batch = {k: sds((b, s), dt) for k, dt in (
            ("tokens", jnp.int32), ("labels", jnp.int32),
            ("loss_mask", jnp.float32))}
    else:
        cache = jax.eval_shape(lambda: jmodel.make_cache(cfg, b, s))
        total += nbytes(cache, (cache_fn or jsharding.cache_specs)(
            cfg, cache, mesh))
        batch = {"tokens": sds((b, s if shape.kind == "prefill" else 1),
                               jnp.int32)}
    if shape.kind == "prefill" and cfg.family == "encdec":
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model),
                              jnp.bfloat16)
    if shape.kind == "prefill" and cfg.num_patches:
        batch["patch_embeds"] = sds((b, cfg.num_patches, cfg.d_model),
                                    jnp.bfloat16)
    total += nbytes(batch, jsharding.batch_specs(cfg, batch, mesh))
    return total + (4 if shape.kind == "decode" else 0)


def _port_bytes(arch, shape_name, variant) -> int:
    """The port's argument bytes of a cell (its state built on ``meta``,
    the step not run)."""
    knobs = D.VARIANTS[variant]
    cfg = get_config(arch)
    if "cfg" in knobs:
        cfg = dataclasses.replace(cfg, **knobs["cfg"])
    mesh = Mesh.abstract(tuple(knobs.get("mesh", (16, 16))),
                         ("data", "model"), device="meta")
    return D.build_cell(cfg, SHAPES[shape_name], mesh,
                        variant).argument_size


# ---------------------------------------------------------------------------
# Argument bytes against the reference's specs
# ---------------------------------------------------------------------------

def test_committed_cells_argument_bytes_are_the_references():
    assert _port_bytes("qwen3-1.7b-smoke", "train_4k", "baseline") == \
        _ref_bytes("qwen3-1.7b-smoke", "train_4k", "baseline") == 812_548
    assert _port_bytes("llama4-scout-17b-a16e", "decode_32k", "ep_moe") == \
        _ref_bytes("llama4-scout-17b-a16e", "decode_32k", "ep_moe") == \
        4_797_494_308
    for cell in (QWEN_CELL, L4_CELL):
        ref = json.load(open(os.path.join(REF_RESULTS, cell + ".json")))
        mine = json.load(open(os.path.join(PORT_RESULTS, cell + ".json")))
        assert mine["status"] == "ok"
        assert mine["memory"]["argument_size"] == \
            ref["memory"]["argument_size"]


ARG_CASES = [("qwen3-1.7b-smoke", "train_4k", "zero1"),
             ("qwen3-1.7b-smoke", "decode_32k", "serve_tp"),
             ("qwen3-1.7b-smoke", "prefill_32k", "serve_tp"),
             ("llama4-scout-17b-a16e-smoke", "train_4k", "l4_ep_model"),
             ("llama4-scout-17b-a16e-smoke", "decode_32k", "l4_ep_model"),
             ("mixtral-8x7b-smoke", "train_4k", "ep_moe"),
             ("gemma3-4b-smoke", "long_500k", "baseline")]


@pytest.mark.parametrize("arch,shape,variant", ARG_CASES,
                         ids=["-".join(c) for c in ARG_CASES])
def test_argument_bytes_match_reference_specs(arch, shape, variant):
    assert _port_bytes(arch, shape, variant) == _ref_bytes(arch, shape,
                                                           variant)


def _ssm_dims(cfg):
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // 64, cfg.ssm_state


def _ssm_cache_difference(cfg, shape, head_shard: bool) -> int:
    """The port's SSM cache bytes a rank minus the reference's, by the
    layouts ROADMAP Queue 3 states: the reference cuts the state's heads
    and the conv window's channels over the 16-wide model axis; the port
    holds both whole off ``ssm_head_shard`` and, on it, its heads' state
    and a window of its heads' ``x`` channels plus all of B and C."""
    d_inner, heads, n = _ssm_dims(cfg)
    rows = shape.global_batch // 16 or shape.global_batch
    layers = cfg.num_layers
    conv_ch = d_inner + 2 * n
    ref_conv = conv_ch // 16 if conv_ch % 16 == 0 else conv_ch
    ref_h = heads // 16
    if head_shard:
        port_conv, port_h = d_inner // 16 + 2 * n, heads // 16
    else:
        port_conv, port_h = conv_ch, heads
    conv = layers * rows * 3 * (port_conv - ref_conv) * 2     # bf16
    h = layers * rows * (port_h - ref_h) * 64 * n * 4         # fp32
    return conv + h


@pytest.mark.parametrize("variant", ["ssm_shard", "baseline"])
def test_ssm_cache_byte_difference_is_the_stated_one(variant):
    """mamba2-370m, decode_32k: the port's bytes are the reference's plus
    the stated difference (ROADMAP Queue 3: +382,464,000 B off head
    sharding, +552,960 B on it)."""
    arch = "mamba2-370m"
    diff = _port_bytes(arch, "decode_32k", variant) - _ref_bytes(
        arch, "decode_32k", variant)
    want = _ssm_cache_difference(get_config(arch), SHAPES["decode_32k"],
                                 variant == "ssm_shard")
    assert diff == want
    assert diff == {"ssm_shard": 552_960, "baseline": 382_464_000}[variant]


def test_cross_cache_difference_is_the_stated_one():
    """whisper-base-smoke's 16 encoder rows divide over a 16-wide model
    axis: the reference cuts its cross K / V's rows there, the port holds
    them whole (whisper-base's 1500 rows do not divide: no difference)."""
    arch = "whisper-base-smoke"
    cfg, shape = get_config(arch), SHAPES["decode_32k"]
    cross = (2 * cfg.num_layers * (shape.global_batch // 16)
             * cfg.encoder_seq * cfg.num_kv_heads * cfg.head_dim_ * 2)
    diff = _port_bytes(arch, "decode_32k", "baseline") - _ref_bytes(
        arch, "decode_32k", "baseline")
    assert diff == cross - cross // 16
    assert _port_bytes("whisper-base", "decode_32k", "baseline") == \
        _ref_bytes("whisper-base", "decode_32k", "baseline")


def test_committed_cell_perf_breakdown_is_the_references():
    ref = json.load(open(os.path.join(REF_RESULTS, QWEN_CELL + ".json")))
    got = D.run_cell("qwen3-1.7b-smoke", "train_4k", save=False)
    assert got["status"] == "ok"
    assert got["perf_breakdown"] == ref["perf_breakdown"]
    assert got["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    assert got["memory"]["argument_size"] == 812_548
    mem = got["memory"]
    assert mem["peak_memory"] == mem["argument_size"] + mem["temp_size"]
    assert mem["temp_size"] > 0 and got["roofline"]["raw_cost"]["flops"] > 0
    roof = got["roofline"]
    assert roof["t_collective"] > 0
    assert roof["coll_bytes_wire"] == pytest.approx(
        2 * roof["coll_by_type"]["all-reduce"]
        + roof["coll_by_type"]["all-gather"]
        + roof["coll_by_type"]["reduce-scatter"])


def test_variants_are_the_references():
    assert D.VARIANTS == _ref_variants()


def test_production_mesh_is_the_references():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.size == 512 and one.is_abstract and two.is_abstract
    assert one.device.type == "meta"
    assert S.dp_axes(two) == ("pod", "data")


def test_cli_skips_what_the_reference_skips(capsys):
    r = D.run_cell("qwen3-1.7b", "long_500k", save=False)
    assert r["status"] == "skipped" and "500k" in r["reason"]
    assert D.main(["--arch", "whisper-base", "--shape", "long_500k"]) == 0
    assert "done: 0 ok, 1 skipped, 0 failed" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Real steps against their abstract twins, on a gloo world of 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world"), timeout=240)
    yield w
    w.close()


TWIN_CASES = {
    "qwen-train-zero3-tp": ("qwen3-1.7b-smoke", (32, 4, "train"),
                            "baseline", {}),
    "qwen-decode-tp-cache": ("qwen3-1.7b-smoke", (32, 4, "decode"),
                             "baseline", {}),
    "llama4-train-ep": ("llama4-scout-17b-a16e-smoke", (32, 4, "train"),
                        "ep_moe", {"num_layers": 1}),
}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_real_step_records_what_its_abstract_twin_records(world, case):
    arch, (seq, batch, kind), variant, over = TWIN_CASES[case]
    ranks = world.run("dryrun_twin", arch, (seq, batch, kind), variant,
                      (2, 2), over)
    entries: list = []
    cfg = dataclasses.replace(get_config(arch), **over)
    mesh = Mesh.abstract((2, 2), ("data", "model"), device="meta",
                         shared_device=True)
    got = D.run_cell(arch, ShapeConfig("twin", seq, batch, kind),
                     variant=variant, save=False, cfg=cfg, mesh=mesh,
                     entries=entries, count_flops=False)
    abstract = Counter((e.op, e.bytes, e.axis) for e in entries)
    assert abstract
    for r in ranks:
        assert Counter(tuple(e) for e in r["record"]) == abstract
    assert ranks[0]["argument_size"] == got["memory"]["argument_size"]
    real = collective_bytes(
        [C.Collective(op, b, tuple(a), "") for op, b, a in ranks[0]["record"]])
    assert real == got["roofline"]["coll_by_type"]


# ---------------------------------------------------------------------------
# The abstract mesh's collectives, the wire convention, dissect
# ---------------------------------------------------------------------------

def test_abstract_collectives_record_and_return_twin_results():
    mesh = Mesh.abstract((2, 4), ("data", "model"))
    x = torch.arange(6.0).reshape(3, 2)
    with C.record() as rec:
        g = C.raw_all_gather(x, mesh, "model", 1)
        r = C.raw_all_reduce(x, mesh, "model")
        m = C.raw_all_reduce(x, mesh, ("data", "model"), "max")
        rs = C.raw_reduce_scatter(torch.ones(8, 2), mesh, "model")
        (p,) = C.raw_ppermute([x], mesh, "data")
        C.raw_all_reduce(x, Mesh.abstract((1, 2), ("data", "model")),
                         "data")            # one rank: not recorded
        assert C.agree_max(1, mesh, "data") == 1
    assert torch.equal(g, torch.cat([x] * 4, dim=1))
    assert torch.equal(r, 4 * x) and torch.equal(m, x)
    assert torch.equal(rs, torch.full((2, 2), 4.0)) and torch.equal(p, x)
    assert [(e.op, e.bytes, e.axis) for e in rec] == [
        ("all-gather", 96, ("model",)), ("all-reduce", 24, ("model",)),
        ("all-reduce", 24, ("data", "model")),
        ("reduce-scatter", 16, ("model",)),
        ("collective-permute", 24, ("data",)), ("all-reduce", 4, ("data",))]
    assert all(e.site.startswith("test_torch_dryrun") or e.site == "?"
               for e in rec)
    meta = torch.empty(5, 7, device="meta")
    out = C.raw_all_gather(meta, mesh, "data")
    assert out.device.type == "meta" and out.shape == (10, 7)
    assert C.exchange_method(mesh, "model") == "dense"


def test_zero_gather_backward_records_a_reduce_scatter():
    mesh = Mesh.abstract((4, 1), ("data", "model"))
    p = torch.ones(2, 3, requires_grad=True)
    with C.record() as rec:
        w = C.zero_gather(p, mesh, "data", 0, torch.float32)
        (w * 2).sum().backward()
    assert [(e.op, e.bytes) for e in rec] == [("all-gather", 96),
                                             ("reduce-scatter", 24)]
    assert rec[1].site.endswith(" bwd")
    assert torch.equal(p.grad, torch.full((2, 3), 8.0))   # 4 twins x 2


def test_wire_convention_and_dissect_order():
    e = [C.Collective("all-reduce", 100, ("model",), "a [layer 0]"),
         C.Collective("all-reduce", 100, ("model",), "a [layer 1]"),
         C.Collective("all-gather", 300, ("data",), "b"),
         C.Collective("collective-permute", 7, ("data",), "c")]
    coll = collective_bytes(e)
    assert coll["all-reduce"] == 200 and coll["n_all-reduce"] == 2
    assert coll["n_all-gather"] == 1 and coll["all-to-all"] == 0
    r = build_roofline(arch="x", shape="y", analytic_flops=1.0,
                       analytic_bytes=1.0, model_flops=1.0, chips=2,
                       coll=coll)
    assert r.coll_bytes_wire == 2 * 200 + 300 + 7
    assert r.t_collective == pytest.approx(707 / (25e9 * 18))
    rows = dissect(e, top=10)
    assert [row[0] for row in rows] == sorted((row[0] for row in rows),
                                              reverse=True)
    assert rows[0][1:] == ("all-gather", 300, 1, "b")
    assert rows[1][1:] == ("all-reduce", 100, 2, "a [layers 0-1]")
    lines = format_rows(rows, 10)
    assert lines[-1] == f"TOTAL(top 10): {507 / 2**30:.2f} GiB"
    assert sum(row[0] for row in rows) == 507      # result bytes
    assert np.isclose(sum(row[0] for row in dissect(e, top=2)), 500)
