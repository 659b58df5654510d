"""The port's training path against the JAX package, on the CPU.

* AdamW: ``schedule``, ``global_norm``, clipping and ``apply_updates`` on
  the same numpy trees (1e-6: the same fp32 arithmetic).
* Data: ``SyntheticLM.host_batch`` is bitwise the reference's; the
  prefetcher keeps its order and replays from ``start_step``.
* Checkpoints: each package restores the other's, leaf by leaf; the commit
  marker and the keep-N collection.
* The slice as a whole: ``make_train_step`` for 3 steps on bridged fp32
  params and identical batches, for the dense ``qwen3-1.7b-smoke``, the
  ragged-MoE ``llama4-scout-17b-a16e-smoke``, the capacity-MoE
  ``mixtral-8x7b-smoke``, the SSM ``mamba2-370m-smoke``, the hybrid
  ``zamba2-7b-smoke`` at 5 layers (2 groups and a remainder), the
  encoder-decoder ``whisper-base-smoke`` and the vision-language
  ``llava-next-34b-smoke``: loss, aux loss and gradient norm per step, and
  every gradient leaf of step 1 (1e-4 normwise: the same fp32 model summed
  in other orders); gradient accumulation; ``Trainer`` resuming from its
  checkpoint; the launcher.
"""
import contextlib
import dataclasses
import functools
import io
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import (from_numpy_params,  # noqa: E402
                                        to_numpy_params, to_numpy_tree)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, make_train_step  # noqa: E402

QWEN, LLAMA4, MIXTRAL = ("qwen3-1.7b-smoke", "llama4-scout-17b-a16e-smoke",
                         "mixtral-8x7b-smoke")
MAMBA, ZAMBA, WHISPER, LLAVA = ("mamba2-370m-smoke", "zamba2-7b-smoke",
                                "whisper-base-smoke", "llava-next-34b-smoke")
DEPTH = {ZAMBA: 5}      # 2 groups of 2 and a remainder of 1
SEQ, BATCH, STEPS = 32, 4, 3
TOL = 1e-4


def _err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT = adamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
JOPT = jadamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)


def test_schedule_matches_jax():
    for step in (0, 1, 2, 3, 7, 10, 25):
        want = float(jadamw.schedule(jnp.int32(step), JOPT))
        got = float(adamw.schedule(torch.tensor(step), OPT))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-8), step


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped",
                                                           "clipped"])
def test_adamw_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp, js = params, jadamw.init_opt_state(params)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = adamw.init_opt_state(tp)
    assert all(m.dtype == torch.float32 for m in ts["m"].values())
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
                 for k, s in shapes.items()}
        assert _err(adamw.global_norm(torch.tensor(g) for g in
                                      grads.values()),
                    jadamw.global_norm(grads)) <= 1e-6
        jp, js, jstats = jadamw.apply_updates(jp, grads, js, JOPT)
        _, ts, tstats = adamw.apply_updates(
            tp, {k: torch.tensor(v) for k, v in grads.items()}, ts, OPT)
        for k in shapes:
            assert _err(tp[k], jp[k]) <= 1e-6, k
            assert _err(ts["m"][k], js["m"][k]) <= 1e-6, k
            assert _err(ts["v"][k], js["v"][k]) <= 1e-6, k
        assert int(ts["step"]) == int(js["step"])
        for key in ("grad_norm", "lr"):
            assert _err(tstats[key], jstats[key]) <= 1e-6, key


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,seed", [
    pytest.param(QWEN, 0, id="0"), pytest.param(QWEN, 3, id="3"),
    pytest.param(WHISPER, 3, id=f"{WHISPER}-3"),
    pytest.param(LLAVA, 3, id=f"{LLAVA}-3")])
def test_synthetic_batches_are_bitwise_the_reference(arch, seed):
    """Tokens, labels and loss mask, and the stub frontends' ``frames``
    (whisper) and ``patch_embeds`` (llava)."""
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=BATCH, kind="train")
    ours = SyntheticLM(get_config(arch), shape, seed=seed)
    ref = JSynthetic(jget_config(arch), JShape("t", SEQ, BATCH, "train"),
                     seed=seed)
    for step in (0, 1, 7):
        got, want = ours.host_batch(step), ref.host_batch(step)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (step, k)


def test_prefetcher_keeps_order_and_replays_from_start_step():
    shape = ShapeConfig("t", seq_len=8, global_batch=2, kind="train")
    ds = SyntheticLM(get_config(QWEN), shape, seed=1)
    pf = Prefetcher(ds, depth=2, start_step=5)
    try:
        for want in (5, 6, 7):
            step, batch = pf.next()
            assert step == want
            assert np.array_equal(batch["tokens"],
                                  ds.host_batch(want)["tokens"])
    finally:
        pf.close()
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _small_state():
    cfg = dataclasses.replace(get_config(LLAMA4), compute_dtype="float32")
    tr = Trainer(cfg, ShapeConfig("t", 8, 2, "train"), device="cpu")
    model, opt = tr.init_state()
    with torch.no_grad():
        for m in opt["m"].values():
            m.normal_()
    opt["step"].fill_(4)
    return tr.state_tree(model, opt)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _small_state()
    Checkpointer(tmp_path).save(4, state, blocking=True)
    step, got = JCheckpointer(tmp_path).restore(state)
    assert step == 4
    want, restored = dict(_leaves(state)), dict(_leaves(got))
    assert sorted(want) == sorted(restored)
    assert "params/layers/moe/w_gate" in want and "opt/step" in want
    for name, value in want.items():
        value = np.asarray(value)
        assert restored[name].dtype == value.dtype, name
        assert np.array_equal(np.asarray(restored[name]), value), name


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = jax.tree.map(np.asarray, _small_state())
    JCheckpointer(tmp_path).save(7, state, blocking=True)
    step, got = Checkpointer(tmp_path).restore(device="cpu")
    assert step == 7
    want, restored = dict(_leaves(state)), dict(_leaves(got))
    assert sorted(want) == sorted(restored)
    for name, value in want.items():
        assert isinstance(restored[name], torch.Tensor)
        assert np.array_equal(restored[name].numpy(), value), name
    _, partial = Checkpointer(tmp_path).restore({"opt": {"step": None}})
    assert int(partial["opt"]["step"]) == int(state["opt"]["step"])


def test_async_save_is_a_snapshot_of_the_live_state(tmp_path):
    """On the CPU the trainer's tensors are updated in place after save()
    returns: the background write must see the state as it was at save()."""
    cfg = dataclasses.replace(get_config(LLAMA4), compute_dtype="float32")
    tr = Trainer(cfg, ShapeConfig("t", 8, 2, "train"), device="cpu")
    model, opt = tr.init_state()
    state = tr.state_tree(model, opt)
    want = {name: np.array(value) for name, value in _leaves(state)}
    ck = Checkpointer(tmp_path)
    gate, write = threading.Event(), ck._write_guarded
    ck._write_guarded = lambda *args: (gate.wait(), write(*args))
    ck.save(1, state)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for m in opt["m"].values():
            m.add_(1.0)
        opt["step"].add_(1)
    gate.set()
    ck.wait()
    _, got = ck.restore()
    restored = dict(_leaves(got))
    assert sorted(restored) == sorted(want)
    for name, value in want.items():
        assert np.array_equal(np.asarray(restored[name]), value), name


def test_checkpoint_commit_marker_and_gc(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for step in (1, 2, 3, 4):
        ck.save(step, {"x": np.full((2,), step, np.float32)})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    # A write that died before its marker is not a checkpoint.
    (tmp_path / ".tmp_step_00000009").mkdir()
    (tmp_path / "step_00000008").mkdir()
    assert ck.latest_step() == 4
    step, tree = ck.restore()
    assert step == 4 and tree["x"].tolist() == [4.0, 4.0]
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore()


# ---------------------------------------------------------------------------
# The train step against the reference
# ---------------------------------------------------------------------------

def _configs(arch):
    depth = {"num_layers": DEPTH[arch]} if arch in DEPTH else {}
    return (dataclasses.replace(jget_config(arch), compute_dtype="float32",
                                **depth),
            dataclasses.replace(get_config(arch), compute_dtype="float32",
                                **depth))


def _batches(jcfg, n):
    ds = JSynthetic(jcfg, JShape("t", SEQ, BATCH, "train"), seed=0)
    return [ds.host_batch(step) for step in range(n)]


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _runs(arch):
    """STEPS reference and port train steps from the same params and
    batches, the reference's step-1 gradients, and the initial params."""
    jcfg, tcfg = _configs(arch)
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    batches = _batches(jcfg, STEPS)
    jgrads, _ = jax.grad(jmodel.loss_fn, has_aux=True)(
        params, jcfg, jax.tree.map(jnp.asarray, batches[0]))
    jstep = jax.jit(jmake_step(jcfg, jadamw.OptConfig()))
    jopt, jmetrics = jadamw.init_opt_state(params), []
    for batch in batches:
        params, jopt, m = jstep(params, jopt, jax.tree.map(jnp.asarray, batch))
        jmetrics.append({k: float(v) for k, v in m.items()})

    model = from_numpy_params(tree, tcfg, "cpu", dtype=torch.float32)
    step = make_train_step(tcfg, adamw.OptConfig())
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    tmetrics, tgrads = [], None
    for batch in batches:
        model, opt, m = step(model, opt, _torch_batch(batch))
        tmetrics.append({k: float(v) for k, v in m.items()})
        if tgrads is None:
            tgrads = to_numpy_tree({n: p.grad for n, p in
                                    model.named_parameters()})
    return (jax.tree.map(np.asarray, jgrads), jmetrics, tgrads, tmetrics,
            jax.tree.map(np.asarray, params), to_numpy_params(model), tree)


ARCHS = [QWEN, LLAMA4, MIXTRAL, MAMBA, ZAMBA, WHISPER, LLAVA]
# The families added with the encoder-decoder and vision-language port.
# Their zero-initialised leaves (norm scales, the SSM's conv_b) hold after
# STEPS steps nothing but AdamW's per-element normalised steps, m / sqrt(v):
# an element whose gradient is 1e-5 of its leaf's largest moves by a whole
# step on a relative gradient difference that is 1e-7 normwise (zamba2 at 5
# layers: 2.1e-4 / 2.4e-4 on ssm conv_b / norm, 3.3e-3 at 3 layers).  Their
# step-1 gradients, every leaf, are held at TOL below, and every other leaf
# here.
ZERO_INIT_EXEMPT = (MAMBA, ZAMBA, WHISPER, LLAVA)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_metrics_match_jax(arch):
    _, jm, _, tm, jparams, tparams, init = _runs(arch)
    for step, (j, t) in enumerate(zip(jm, tm)):
        for key in ("loss", "aux_loss", "total_loss", "grad_norm", "lr"):
            denom = max(abs(j[key]), 1e-6)
            assert abs(t[key] - j[key]) <= TOL * denom, (step, key)
        assert t["tokens"] == j["tokens"] == SEQ * BATCH
    if arch in (LLAMA4, MIXTRAL):
        assert all(m["aux_loss"] > 0 for m in tm)
    init = dict(_leaves(init))
    for name, want in _leaves(jparams):
        if arch in ZERO_INIT_EXEMPT and not init[name].any():
            continue
        assert _err(dict(_leaves(tparams))[name], want) <= TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_gradients_match_jax(arch):
    jgrads, _, tgrads, _, _, _, _ = _runs(arch)
    want, got = dict(_leaves(jgrads)), dict(_leaves(tgrads))
    assert sorted(want) == sorted(got)
    for name in want:
        assert _err(got[name], want[name]) <= TOL, name


def test_accum_steps_equal_one_step_on_the_whole_batch():
    """Two microbatches' summed gradients / 2 are the whole batch's mean
    gradient (1e-5: the same fp32 sums split in two), and so is the update
    (1e-4, as elsewhere: AdamW's first step is sign-like, so a leaf whose
    gradient is near zero amplifies the last fp32 bits)."""
    jcfg, tcfg = _configs(QWEN)
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
    batch = _torch_batch(_batches(jcfg, 1)[0])
    results = []
    for accum in (1, 2):
        model = from_numpy_params(tree, tcfg, "cpu", dtype=torch.float32)
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        step = make_train_step(tcfg, adamw.OptConfig(), accum_steps=accum)
        model, opt, m = step(model, opt, batch)
        results.append((m, to_numpy_tree({n: p.grad for n, p in
                                          model.named_parameters()}),
                        to_numpy_params(model)))
    (m1, g1, p1), (m2, g2, p2) = results
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= \
        1e-5 * float(m1["grad_norm"])
    for (name, a), (_, b) in zip(_leaves(g1), _leaves(g2)):
        assert _err(b, a) <= 1e-5, name
    for (name, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        assert _err(b, a) <= TOL, name
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, adamw.OptConfig(), accum_steps=3)(
            model, opt, batch)


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    cfg = dataclasses.replace(get_config(MIXTRAL), compute_dtype="float32")
    shape = ShapeConfig("t", seq_len=16, global_batch=2, kind="train")
    opt_cfg = adamw.OptConfig(warmup_steps=1, total_steps=5)

    def trainer(ckpt):
        return Trainer(cfg, shape, opt_cfg, seed=0, ckpt_dir=ckpt,
                       ckpt_every=2, log_every=1, device="cpu")

    with contextlib.redirect_stdout(io.StringIO()):
        first = trainer(tmp_path)
        first.run(3)
        assert Checkpointer(tmp_path).all_steps() == [2]
        resumed = trainer(tmp_path)
        model, opt = resumed.run(5)
        straight = trainer(None)
        ref_model, _ = straight.run(5)
    assert [m["step"] for m in first.metrics_log] == [0, 1, 2]
    assert [m["step"] for m in resumed.metrics_log] == [3, 4]
    assert int(opt["step"]) == 5
    assert Checkpointer(tmp_path).all_steps() == [2, 4]
    for a, b in zip(resumed.metrics_log, straight.metrics_log[3:]):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"])
    for (name, a), (_, b) in zip(_leaves(to_numpy_params(model)),
                                 _leaves(to_numpy_params(ref_model))):
        assert _err(a, b) <= 1e-6, name
    losses = [m["loss"] for m in straight.metrics_log]
    assert all(np.isfinite(losses))


def test_launcher_trains_a_smoke_arch_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", QWEN, "--device", "cpu", "--steps", "2",
                           "--seq", "16", "--batch", "2"])
    lines = out.getvalue().splitlines()
    assert lines[-1] == "training done"
    assert [ln.split()[1] for ln in lines[:-1]] == ["0", "1"]


def test_init_params_dtype_makes_trainable_masters():
    cfg = get_config(QWEN)
    frozen = tmodel.init_params(cfg, 0, device="cpu")
    masters = tmodel.init_params(cfg, 0, device="cpu", dtype=cfg.param_dtype)
    assert frozen.embed.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in frozen.parameters())
    assert masters.embed.dtype == torch.float32
    assert all(p.requires_grad for p in masters.parameters())
    w = frozen.layers[0].attn.wq
    assert w.to(torch.bfloat16) is w      # serving casts copy nothing


# ---------------------------------------------------------------------------
# remat="dots"
# ---------------------------------------------------------------------------

def _grads(tcfg, tree, batch, remat):
    """The port's loss and gradient tree of one forward / backward under
    ``remat``, and the launches of each wrapper in the backward alone."""
    from repro_torch.kernels.ftimm import ops
    cfg = dataclasses.replace(tcfg, remat=remat)
    model = from_numpy_params(tree, cfg, "cpu", dtype=torch.float32)
    calls = {"forward": {}, "backward": {}}
    phase = ["forward"]
    saved = {name: getattr(ops, name) for name in
             ("gemm", "gemm_unfused", "gemm_swiglu", "batched_gemm")}

    def counted(name):
        def call(*args, **kwargs):
            seen = calls[phase[0]]
            seen[name] = seen.get(name, 0) + 1
            return saved[name](*args, **kwargs)
        return call

    try:
        for name in saved:
            setattr(ops, name, counted(name))
        loss, _ = tmodel.loss_fn(model, cfg, _torch_batch(batch))
        phase[0] = "backward"
        loss.backward()
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    grads = to_numpy_tree({n: p.grad for n, p in model.named_parameters()})
    return float(loss.detach()), grads, calls


def test_remat_dots_gradients_bitwise_full_and_match_jax():
    """``remat="dots"`` on qwen3-1.7b-smoke: the loss and every gradient
    leaf bitwise equal to ``"full"`` (and to ``"none"``), and within 1e-4
    of the reference's ``dots_with_no_batch_dims_saveable`` gradients."""
    jcfg, tcfg = _configs(QWEN)
    jcfg = dataclasses.replace(jcfg, remat="dots")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    tree = jax.tree.map(np.asarray, params)
    batch = _batches(jcfg, 1)[0]
    jgrads, _ = jax.grad(jmodel.loss_fn, has_aux=True)(
        params, jcfg, jax.tree.map(jnp.asarray, batch))
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    runs = {remat: _grads(tcfg, tree, batch, remat)
            for remat in ("dots", "full", "none")}
    dots = dict(_leaves(runs["dots"][1]))
    assert sorted(dots) == sorted(want)
    for remat in ("full", "none"):
        assert runs[remat][0] == runs["dots"][0]
        for name, g in _leaves(runs[remat][1]):
            np.testing.assert_array_equal(dots[name], g, err_msg=name)
    for name in want:
        assert _err(dots[name], want[name]) <= TOL, name


def test_remat_dots_launches_no_non_batched_product_again():
    """The recompute under ``"dots"`` launches no dense product and no
    dense SwiGLU pair: its backward launches exactly those of ``"none"``
    (no recompute at all), ``"full"``'s backward 5 ``gemm`` and one pair a
    layer more; the batched attention products are recomputed."""
    jcfg, tcfg = _configs(QWEN)
    tree = jax.tree.map(np.asarray,
                        jmodel.init_params(jcfg, jax.random.PRNGKey(2)))
    batch = _batches(jcfg, 1)[0]
    calls = {remat: _grads(tcfg, tree, batch, remat)[2]
             for remat in ("dots", "full", "none")}
    layers = tcfg.num_layers
    assert calls["dots"]["forward"] == calls["full"]["forward"] \
        == calls["none"]["forward"]
    full, dots, none = (calls[r]["backward"] for r in ("full", "dots",
                                                        "none"))
    assert full["gemm"] - dots["gemm"] == 5 * layers
    assert full["gemm_swiglu"] - dots.get("gemm_swiglu", 0) == layers
    assert dots["gemm"] == none["gemm"]
    assert "gemm_swiglu" not in dots and "gemm_swiglu" not in none
    assert dots["batched_gemm"] == full["batched_gemm"] \
        == none["batched_gemm"] + 2 * layers


def test_remat_unknown_mode_raises():
    _, tcfg = _configs(QWEN)
    cfg = dataclasses.replace(tcfg, remat="offload")
    model = tmodel.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="unknown remat"):
        tmodel.loss_fn(model, cfg, {"tokens": toks, "labels": toks})
