"""Training on a mesh, held against the JAX package's single-device step
on the CPU: the port's ZeRO-3 / tensor-parallel layout is the reference's
GSPMD layout, whose result is the one-device step on the global batch.

  * ``make_train_step`` on this rank's blocks (``launch.sharding``:
    ``named_specs``, ``shard_params``, ``gathered``, ``cut_batch``) for 3
    steps on bridged fp32 parameters and the reference's batches:
    ``qwen3-1.7b-smoke`` on (data, model) = (2, 1), (1, 2) and (2, 2);
    ``llama4-scout-17b-a16e-smoke`` with its experts over data (2, 1) and
    over model (1, 2); qwen3 with 2 heads of 64 on (1, 4), the model axis
    cutting across a head (the panels gathered whole);
    ``mamba2-370m-smoke`` and the hybrid ``zamba2-7b-smoke`` (its shared
    block tensor-parallel) with their SSD heads over model (1, 2).  Loss,
    aux loss and gradient norm within 1e-5 relative a step, every
    parameter (gathered whole) within 1e-4 normwise after the 3 steps;
  * ranks whose loss masks differ (the global token count), and
    gradient accumulation over each rank's rows;
  * the head-cut SSM cache: prefill and 4 decode steps within 1e-5 of the
    JAX model's;
  * a checkpoint written by ``Trainer(mesh=(2, 1))``: restored onto (1, 2)
    and onto one device with the same next-step loss, and read by the JAX
    package's ``Checkpointer``;
  * ``compress_allreduce`` on 4 ranks against the reference's under
    ``jax.vmap(axis_name=...)``: the int8 codes bitwise, the mean and
    error within 1e-6, int8 on the wire, the reference test's accuracy
    bounds;
  * the launcher (``--mesh 2x1 --device cpu``) end to end.

One gloo world of 4 CPU ranks (``torch_world``) serves the module; a
2-rank mesh runs on its first two ranks.
"""
import dataclasses
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.quant import INT8_LEVELS, quantize, scale_from_absmax  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.compression import compress_allreduce as jcompress  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from torch_world import World  # noqa: E402

QWEN, LLAMA4, MAMBA, ZAMBA = (
    "qwen3-1.7b-smoke", "llama4-scout-17b-a16e-smoke", "mamba2-370m-smoke",
    "zamba2-7b-smoke")
SEQ, BATCH, STEPS = 32, 4, 3
METRIC_TOL, PARAM_TOL = 1e-5, 1e-4
CASES = {"qwen-2x1": (QWEN, (2, 1), {}),
         "qwen-1x2": (QWEN, (1, 2), {}),
         "qwen-2x2": (QWEN, (2, 2), {}),
         "llama4-ep-2x1": (LLAMA4, (2, 1), {"moe_ep": True}),
         "llama4-ep-model-1x2": (LLAMA4, (1, 2), {"moe_ep": True,
                                                  "moe_ep_axis": "model"}),
         # 2 heads of 64 over 4 ranks: the model axis cuts across a head
         "qwen-heads-cut-1x4": (QWEN, (1, 4), {"overrides": {
             "num_heads": 2, "num_kv_heads": 1, "head_dim": 64}}),
         "mamba2-heads-1x2": (MAMBA, (1, 2), {"ssm_head_shard": True}),
         "zamba2-heads-1x2": (ZAMBA, (1, 2), {"ssm_head_shard": True})}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world"), timeout=180)
    yield w
    w.close()


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _jcfg(arch, overrides=()):
    return dataclasses.replace(jget_config(arch), compute_dtype="float32",
                               **dict(overrides))


def _batches(arch, n=STEPS, overrides=()):
    ds = JSynthetic(_jcfg(arch, overrides), JShape("t", SEQ, BATCH, "train"),
                    seed=0)
    return [ds.host_batch(step) for step in range(n)]


def _jax_steps(arch, tree, batches, overrides=()):
    """The reference's single-device steps from ``tree`` on ``batches``:
    -> (metrics a step, the updated tree)."""
    jcfg = _jcfg(arch, overrides)
    params = jax.tree.map(jnp.asarray, tree)
    step = jax.jit(jmake_step(jcfg, jadamw.OptConfig()))
    opt, out = jadamw.init_opt_state(params), []
    for batch in batches:
        params, opt, m = step(params, opt, jax.tree.map(jnp.asarray, batch))
        out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def _init(arch, overrides=()):
    return jax.tree.map(np.asarray, jmodel.init_params(
        _jcfg(arch, overrides), jax.random.PRNGKey(0)))


_RUNS: dict = {}


def _run(world, case):
    """(reference metrics, reference params, the mesh run's rank-0 result,
    every rank's result) for one case, computed once."""
    if case not in _RUNS:
        arch, shape, kw = CASES[case]
        over = tuple(sorted(kw.get("overrides", {}).items()))
        tree, batches = _init(arch, over), _batches(arch, overrides=over)
        jm, jp = _jax_steps(arch, tree, batches, over)
        ranks = world.run("mesh_steps", arch, shape, tree, batches, **kw)
        _RUNS[case] = (jm, jp, ranks[0], ranks)
    return _RUNS[case]


def _check_metrics(got, want):
    for step, (t, j) in enumerate(zip(got, want)):
        for key in ("loss", "aux_loss", "total_loss", "grad_norm"):
            assert abs(t[key] - j[key]) <= METRIC_TOL * max(abs(j[key]),
                                                            1e-6), \
                (step, key, t[key], j[key])
        assert t["tokens"] == j["tokens"]


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_metrics_match_jax_single_device(world, case):
    jm, _, got, _ = _run(world, case)
    assert len(got["metrics"]) == STEPS
    _check_metrics(got["metrics"], jm)
    if CASES[case][0] == LLAMA4:
        assert all(m["aux_loss"] > 0 for m in got["metrics"])


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_step_params_match_jax_single_device(world, case):
    _, jp, got, _ = _run(world, case)
    mine = dict(_leaves(got["params"]))
    want = dict(_leaves(jp))
    assert sorted(mine) == sorted(want)
    for name, value in want.items():
        assert _err(mine[name], value) <= PARAM_TOL, name


@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_holds_its_blocks(world, case):
    """The blocks a rank trains on are the specs' cut: ZeRO-3 halves the
    data-cut dims, TP the model-cut ones, EP the expert dim."""
    arch, (dp, tp), kw = CASES[case]
    cfg = dataclasses.replace(get_config(arch), **kw.get("overrides", {}))
    _, _, _, ranks = _run(world, case)
    n = dp * tp
    assert all(r is None for r in ranks[n:])
    for r in ranks[:n]:
        shapes = r["shapes"]
        assert shapes["final_norm"] == (cfg.d_model,)
        assert shapes["embed"] == (cfg.vocab_padded // tp, cfg.d_model // dp)
        hd = cfg.head_dim_
        if arch in (MAMBA, ZAMBA):
            d_in = 2 * cfg.d_model
            width = 2 * d_in + 2 * cfg.ssm_state + d_in // 64
            assert shapes["layers.0.ssm.in_proj"] == (cfg.d_model // dp,
                                                      width // tp)
            assert shapes["layers.0.ssm.out_proj"] == (d_in // tp,
                                                       cfg.d_model // dp)
            if arch == ZAMBA:      # the shared block, tensor-parallel
                assert shapes["shared_attn.attn.wq"] == (
                    cfg.d_model // dp, cfg.num_heads * hd // tp)
                assert shapes["shared_attn.mlp.w_down"] == (
                    cfg.d_ff // tp, cfg.d_model // dp)
            continue
        assert shapes["layers.0.attn.wq"] == (cfg.d_model // dp,
                                              cfg.num_heads * hd // tp)
        assert shapes["layers.0.attn.wo"] == (cfg.num_heads * hd // tp,
                                              cfg.d_model // dp)
        if arch == LLAMA4:
            e = cfg.num_experts // (tp if kw.get("moe_ep_axis") == "model"
                                    else dp)
            assert shapes["layers.0.moe.w_gate"] == (e, cfg.d_model,
                                                     cfg.d_ff)
            assert shapes["layers.0.moe.w_down"] == (e, cfg.d_ff,
                                                     cfg.d_model)
        else:
            assert shapes["layers.0.mlp.w_down"] == (cfg.d_ff // tp,
                                                     cfg.d_model // dp)


def test_unequal_masks_use_the_global_token_count(world):
    """Rank 1's rows keep a quarter of their tokens, rank 0's all: the mesh
    step still equals the one-device step (the denominator is the global
    mask sum, not each rank's)."""
    tree = _init(QWEN)
    batches = _batches(QWEN)
    for b in batches:
        b["loss_mask"] = b["loss_mask"].copy()
        b["loss_mask"][BATCH // 2:, SEQ // 4:] = 0.0
    jm, jp = _jax_steps(QWEN, tree, batches)
    got = world.run("mesh_steps", QWEN, (2, 1), tree, batches)[0]
    assert got["metrics"][0]["tokens"] == BATCH * SEQ * 5 / 8
    _check_metrics(got["metrics"], jm)
    mine = dict(_leaves(got["params"]))
    for name, value in _leaves(jp):
        assert _err(mine[name], value) <= PARAM_TOL, name


def test_accum_steps_split_the_local_rows(world):
    """``accum_steps`` 2 on (2, 1): each rank runs its rows as two
    microbatches; the accumulated gradient is the global batch's, so the
    gradient norm and the updated parameters are the one-device step's on
    the whole batch (the loss logged is the last microbatch's)."""
    tree = _init(QWEN)
    batches = _batches(QWEN)
    jm, jp = _jax_steps(QWEN, tree, batches)
    got = world.run("mesh_steps", QWEN, (2, 1), tree, batches,
                    accum_steps=2)[0]
    for t, j in zip(got["metrics"], jm):
        assert abs(t["grad_norm"] - j["grad_norm"]) <= (
            METRIC_TOL * j["grad_norm"])
        assert t["tokens"] == j["tokens"] / 2
    mine = dict(_leaves(got["params"]))
    for name, value in _leaves(jp):
        assert _err(mine[name], value) <= PARAM_TOL, name


def test_head_cut_cache_decode_matches_jax(world):
    """mamba2 on (1, 2) under ``ssm_head_shard``: each rank's cache holds
    H / 2 heads and its scan's conv channels; prefill and 4 dense-slot
    decode steps give the JAX model's logits within 1e-5."""
    cfg, jcfg = get_config(MAMBA), _jcfg(MAMBA)
    tree = _init(MAMBA)
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, (2, 7)).astype(np.int32)
    steps = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
    max_len = 16
    params = jax.tree.map(jnp.asarray, tree)
    cache = jmodel.make_cache(jcfg, 2, max_len)
    logits, cache = jmodel.prefill(params, jcfg, {"tokens": prompt}, cache)
    want = [np.asarray(logits)]
    pos = prompt.shape[1]
    for i in range(steps.shape[1]):
        logits, cache = jmodel.decode_step(params, jcfg, steps[:, i:i + 1],
                                           cache, pos)
        want.append(np.asarray(logits))
        pos += 1
    ranks = world.run("head_cut_decode", MAMBA, tree, prompt, steps,
                      max_len)
    heads = 2 * cfg.d_model // 64
    d_in = 2 * cfg.d_model
    for r in ranks[:2]:
        assert r["cache"]["h"] == (cfg.num_layers, 2, heads // 2, 64,
                                   cfg.ssm_state)
        assert r["cache"]["conv"] == (cfg.num_layers, 2, 3,
                                      d_in // 2 + 2 * cfg.ssm_state)
        for got, w in zip(r["logits"], want):
            assert _err(got, w) <= 1e-5


def test_checkpoint_moves_across_meshes_and_packages(world, tmp_path):
    """A (2, 1) ``Trainer`` writes steps 0-1 whole; (1, 2), one device and
    an uninterrupted (2, 1) run give the same step-2 loss from it, and the
    JAX package's ``Checkpointer`` reads every leaf."""
    opt = {"lr": 1e-3, "warmup_steps": 1, "total_steps": 3}
    first, whole = tmp_path / "first", tmp_path / "whole"
    world.run("mesh_trainer", QWEN, (2, 1), 2, str(first), opt=opt)
    for name in ("onto_1x2", "onto_one"):
        shutil.copytree(first, tmp_path / name)
    onto = world.run("mesh_trainer", QWEN, (1, 2), 3,
                     str(tmp_path / "onto_1x2"), opt=opt)[0]
    straight = world.run("mesh_trainer", QWEN, (2, 1), 3, str(whole),
                         opt=opt)[0]
    cfg = dataclasses.replace(get_config(QWEN), compute_dtype="float32")
    one = Trainer(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                  adamw.OptConfig(**opt), seed=0, device="cpu",
                  ckpt_dir=str(tmp_path / "onto_one"), log_every=1)
    one.run(3)
    want = straight[-1]
    assert want["step"] == 2
    for got in (onto[-1], one.metrics_log[-1]):
        assert got["step"] == 2 and len(got) == len(want)
        assert abs(got["loss"] - want["loss"]) <= METRIC_TOL * want["loss"]
    # The reference reads the mesh's checkpoint leaf for leaf.
    template = {"params": _init(QWEN),
                "opt": {"m": _init(QWEN), "v": _init(QWEN),
                        "step": np.zeros((), np.int32)}}
    step, got = JCheckpointer(first).restore(template)
    assert step == 1 and int(got["opt"]["step"]) == 2
    leaves = dict(_leaves(got["params"]))
    for name, value in _leaves(template["params"]):
        assert np.asarray(leaves[name]).shape == value.shape, name
        assert np.isfinite(np.asarray(leaves[name])).all(), name


N_COMP = 4


def _jax_compress(g, err):
    """The reference's ``compress_allreduce`` over a vmap axis, and the
    codes its rounding gives (its own functions, in its order)."""
    def codes(gi, ei):
        gf = gi.astype(jnp.float32) + ei
        gm = jax.lax.pmax(jnp.max(jnp.abs(gf)), "dp")
        level = max(INT8_LEVELS // N_COMP, 1)
        return quantize(gf, scale_from_absmax(gm, level), level)
    mean, new_err = jax.vmap(lambda a, b: jcompress(a, b, "dp", N_COMP),
                             axis_name="dp")(g, err)
    q = jax.vmap(codes, axis_name="dp")(g, err)
    return np.asarray(mean), np.asarray(new_err), np.asarray(q)


def test_compress_allreduce_matches_reference_codes_bitwise(world):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal((N_COMP, 64, 32)) * 0.01).astype(np.float32)
    err = (rng.standard_normal((N_COMP, 64, 32)) * 1e-4).astype(np.float32)
    mean, new_err, q = _jax_compress(g, err)
    ranks = world.run("compress", g, err)
    for r, out in enumerate(ranks):
        assert out["wire"] == [("torch.float32", 1), ("torch.int8", 64 * 32)]
        assert np.array_equal(out["codes"][0], q[r])
        step = out["steps"][0]
        assert np.abs(step["mean"] - mean[r]).max() <= 1e-6
        assert np.abs(step["err"] - new_err[r]).max() <= 1e-6


def test_compress_allreduce_error_feedback_converges(world):
    """The reference test's bounds: one step within 0.2 of the true mean,
    the average of 20 error-feedback steps within 0.03."""
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((N_COMP, 64, 32)) * 0.01).astype(np.float32)
    true = g.mean(axis=0)
    out = world.run("compress", g, np.zeros_like(g), steps=20)[0]["steps"]
    scale = np.abs(true).max()
    assert np.abs(out[0]["mean"] - true).max() / scale < 0.2
    acc = sum(s["mean"] for s in out) / 20
    assert np.abs(acc - true).max() / scale < 0.03


def test_launcher_trains_on_a_cpu_mesh(tmp_path):
    """``python -m repro_torch.launch.train --mesh 2x1 --device cpu`` spawns
    its two ranks, trains and prints rank 0's steps."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", QWEN,
         "--mesh", "2x1", "--device", "cpu", "--steps", "2", "--seq", "32",
         "--batch", "4", "--ckpt", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(ln.startswith("step ") for ln in lines) == 2, out.stdout
    assert lines[-1] == "training done"
    assert (tmp_path / "ck" / "step_00000001" / "DONE").exists()


def test_launcher_mesh_needs_a_card_or_the_cpu_asked_for():
    """With no card and no ``--device cpu`` a mesh rank raises before it
    joins the world (the port never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the ranks would train on it")
    from repro_torch.launch import train as launch_train
    args = launch_train.argparse.Namespace(device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train._rank_device(args, 0)
    assert launch_train._rank_device(
        launch_train.argparse.Namespace(device="cpu"), 1).type == "cpu"
