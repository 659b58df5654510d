"""What the ranks of ``torch_world.World`` run: the port's mesh executors,
flash-decode, the expert-parallel MoE and the model path on a gloo world
of CPU ranks.  Each task takes numpy inputs (the same on every rank, the
expert panels cut here) and returns numpy outputs; torch and the port
only."""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import dist as D
from repro_torch.core.gemm import collective as C
from repro_torch.core.gemm import distributed as X
from repro_torch.core.gemm import tuner
from repro_torch.kernels.ftimm import kernel as K
from repro_torch.kernels.ftimm.epilogue import Epilogue
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.weights import from_numpy_params, to_numpy_tree
from repro_torch.runtime import chaos

CPU = torch.device("cpu")
_MESHES: dict = {}
EP_FNS = {"matmul": X.ep_ragged_matmul, "swiglu": X.ep_ragged_swiglu,
          "moe": X.ep_ragged_moe}


def mesh(shape=None, axes=("x",), device="cpu"):
    """This rank's gloo mesh of ``shape`` (default: the whole world on one
    axis) with its tensors on ``device``, built once; over the first ranks
    when ``shape`` is smaller than the world (None on the others)."""
    if shape is None:
        shape = (torch.distributed.get_world_size(),)
    key = (tuple(shape), tuple(axes), str(device))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(tuple(shape), tuple(axes), backend="gloo",
                                 device=device, first_ranks=True)
    return _MESHES[key]


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _n(t):
    return None if t is None else t.detach().numpy().copy()


def _local(w, m, axis):
    nc, s = m.axis_size(axis), m.axis_index(axis)
    g_l = w.shape[0] // nc
    return w[s * g_l:(s + 1) * g_l]


def info():
    m = mesh((2, 2), ("data", "model")) if torch.distributed.get_world_size() \
        == 4 else mesh()
    return {"coords": dict(m.coords), "transport": m.transport,
            "backend": m.backend,
            "index": {a: m.axis_index(a) for a in m.axis_names}}


def gather_along(x, shape, axes, axis):
    """Each rank contributes ``x + rank``; the gather along ``axis``."""
    m = mesh(shape, axes)
    r = torch.distributed.get_rank()
    return _n(C.raw_all_gather(_t(x) + r, m, axis))


def ep(kind, x, panels, offsets, *, schedule=None, a2a=None, ct=None,
       shape=None, axes=("x",), axis="x", device="cpu"):
    """One ``ep_ragged_<kind>`` call with this rank's panels, its tensors
    on ``device``; with ``ct``, its backward too.  -> y, dx, the local
    dW's, the exchange counters, the realization taken and the kernel
    launches."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    m = mesh(shape, axes, dev)
    grad = ct is not None

    def on(a):
        return _t(a).to(dev).requires_grad_(grad)

    xt = on(x)
    local = [on(_local(w, m, axis)) for w in panels]
    C.reset_counts()
    K.reset_launch_counts()
    with _env(C.ENV_A2A, a2a):
        y = EP_FNS[kind](xt, *local, _t(offsets).to(dev), mesh=m, axis=axis,
                         schedule=schedule)
        method = C.exchange_method(m, axis)
        if grad:
            y.backward(_t(ct).to(dev))

    def host(t):
        return None if t is None else _n(t.float().cpu())

    return {"y": host(y), "dx": host(xt.grad) if grad else None,
            "dw": [host(w.grad) for w in local] if grad else None,
            "counts": C.counts(), "method": method,
            "launches": {k: v for k, v in K.launch_counts().items() if v}}


def dist_matmul(a, b, *, strategy=None, schedule=None, act="none",
                bias=None, residual=None, ct=None):
    m = mesh()
    grad = ct is not None
    at, bt = _t(a, grad), _t(b, grad)
    bias_t = None if bias is None else _t(bias, grad)
    res_t = None if residual is None else _t(residual, grad)
    epi = Epilogue(bias=bias is not None, residual=residual is not None,
                   activation=act)
    y = X.dist_matmul(at, bt, mesh=m, axis="x", strategy=strategy,
                      schedule=schedule, epilogue=epi, bias=bias_t,
                      residual=res_t)
    out = {"y": _n(y)}
    if grad:
        y.backward(_t(ct))
        out.update(da=_n(at.grad), db=_n(bt.grad),
                   dbias=_n(None if bias_t is None else bias_t.grad),
                   dres=_n(None if res_t is None else res_t.grad))
    return out


def dist_matmul_raises(a, b, strategy, schedule):
    try:
        X.dist_matmul(_t(a), _t(b), mesh=mesh(), axis="x",
                      strategy=strategy, schedule=schedule)
    except ValueError as e:
        return str(e)
    return None


def dist_batched(a, b, *, trans="nn", ct=None):
    m = mesh()
    grad = ct is not None
    at, bt = _t(a, grad), _t(b, grad)
    y = X.dist_batched_matmul(at, bt, mesh=m, axis="x", trans=trans)
    out = {"y": _n(y)}
    if grad:
        y.backward(_t(ct))
        out.update(da=_n(at.grad), db=_n(bt.grad))
    return out


def ladder(x, panels, offsets, schedule, faults):
    """``ep_ragged_moe`` with ``faults`` (a ``REPRO_CHAOS`` spec, or "")
    armed on this rank only: -> y and the degraded counts."""
    m = mesh()
    local = [_t(_local(w, m, "x")) for w in panels]
    tuner.DEGRADED_COUNTS.clear()
    plan = chaos.parse_env(faults) if faults else None
    with chaos.chaos(plan):
        y = X.ep_ragged_moe(_t(x), *local, _t(offsets), mesh=m, axis="x",
                            schedule=schedule)
    return {"y": _n(y), "degraded": tuner.degraded_stats()}


def flash_decode(q, ck, cv, pos, window):
    """flash-decode over this rank's block of the cache on a (1, nc)
    (data, model) mesh, beside the single-device decode attention."""
    nc = torch.distributed.get_world_size()
    m = mesh((1, nc), ("data", "model"))
    ctx = D.DistContext(m, sp_decode=True)
    s_l = ck.shape[1] // nc
    s = m.axis_index("model")
    got = A.flash_decode(_t(q), _t(ck[:, s * s_l:(s + 1) * s_l]),
                         _t(cv[:, s * s_l:(s + 1) * s_l]), pos=pos,
                         window=window, dist=ctx)
    want = A.decode_attention(_t(q), _t(ck), _t(cv),
                              q_pos=torch.tensor([pos] * q.shape[0]),
                              window=window)
    return {"got": _n(got), "want": _n(want)}


def _ctx(arch_experts, nc):
    m = mesh((1, nc), ("data", "model"))
    return D.DistContext(
        m, sp_decode=True,
        moe_ep_axis=S.expert_axis(m, True, "model", arch_experts))


def model_path(arch, tree, prompt, steps, max_len):
    """``prefill`` of ``prompt`` then a scalar-position ``decode_step`` for
    each token column of ``steps``, on this rank's serving state under a
    (1, nc) mesh with EP on "model" and flash-decode: -> the logits of
    every call and the rank's cache and expert panel shapes."""
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    nc = torch.distributed.get_world_size()
    ctx = _ctx(cfg.num_experts, nc)
    model = S.serving_state(from_numpy_params(tree, cfg, CPU), ctx)
    with D.use_dist(ctx):
        cache = M.make_cache(cfg, prompt.shape[0], max_len, device=CPU)
        logits, cache = M.prefill(model, cfg, {"tokens": _t(prompt).long()},
                                  cache)
        outs = [_n(logits)]
        pos = prompt.shape[1]
        for i in range(steps.shape[1]):
            logits, cache = M.decode_step(model, cfg,
                                          _t(steps[:, i:i + 1]).long(),
                                          cache, pos)
            outs.append(_n(logits))
            pos += 1
    return {"logits": outs, "cache_rows": cache["k"].shape[2],
            "experts": model.layers[0].moe.w_gate.shape[0]}


def moe_grads(x, router, wg, wu, wd, top_k, ct):
    """``moe_mlp`` (ragged) under EP on this rank's panels and on one
    device with all of them: loss sum(y * ct) + 0.01 aux; -> both outputs
    and gradients (the EP panels' are this rank's)."""
    nc = torch.distributed.get_world_size()
    e = wg.shape[0]
    ctx = _ctx(e, nc)
    m = ctx.mesh
    out = {}
    for ep_on in (True, False):
        panels = [(_local(w, m, "model") if ep_on else w)
                  for w in (wg, wu, wd)]
        p = MOE.MoEParams(_t(router), *(_t(w) for w in panels),
                          requires_grad=True)
        xt = _t(x, True)
        with D.use_dist(ctx if ep_on else None):
            y, aux = MOE.moe_mlp(xt, p, num_experts=e, top_k=top_k,
                                 compute_dtype=torch.float32,
                                 dispatch="ragged")
        loss = (y * _t(ct)).sum() + 0.01 * aux
        loss.backward()
        out["ep" if ep_on else "one"] = {
            "y": _n(y), "dx": _n(xt.grad), "router": _n(p.router.grad),
            "w": [_n(getattr(p, n).grad)
                  for n in ("w_gate", "w_up", "w_down")]}
    return out


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------

def _train_cfg(arch, depth=None):
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    return dataclasses.replace(cfg, num_layers=depth) if depth else cfg


def mesh_steps(arch, mesh_shape, tree, batches, *, moe_ep=False,
               ssm_head_shard=False, opt=None, depth=None, device="cpu",
               accum_steps=1, zero1=False, capacity_factor=None,
               moe_ep_axis="dp", overrides=None):
    """``make_train_step`` on this rank's blocks of ``tree`` (a whole
    reference-layout parameter tree) under a (data, model) mesh of
    ``mesh_shape`` with its tensors on ``device``, one step per global
    batch of ``batches`` (this rank's rows cut from each): -> each step's
    metrics, the whole updated tree (rank 0), this rank's parameter and
    moment block shapes and kernel launches.  ``zero1``: the parameters at
    ``named_specs(zero_stage=1)`` (TP only), the moments at ZeRO-3;
    ``moe_ep_axis``: the axis ``moe_ep`` cuts the experts over;
    ``overrides``: config fields replaced."""
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    cfg = dataclasses.replace(_train_cfg(arch, depth), **(overrides or {}))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    m = mesh(tuple(mesh_shape), ("data", "model"), dev)
    if m is None:
        return None
    K.reset_launch_counts()
    model = from_numpy_params(tree, cfg, dev, dtype=torch.float32)
    full_named = dict(model.named_parameters())
    specs = S.named_specs(full_named, m, moe_ep=moe_ep,
                          moe_ep_axis=moe_ep_axis,
                          zero_stage=1 if zero1 else 3)
    opt_specs = (S.named_specs(full_named, m, moe_ep=moe_ep,
                               moe_ep_axis=moe_ep_axis) if zero1 else specs)
    S.shard_params(model, specs, m)
    ep = (S.expert_axis(m, True, moe_ep_axis, cfg.num_experts) if moe_ep
          else None)
    ctx = D.DistContext(m, S.dp_axes(m), "model", moe_ep_axis=ep,
                        ssm_head_shard=ssm_head_shard, sharded_params=True)
    ocfg = adamw.OptConfig(**(opt or {}))
    step = make_train_step(cfg, ocfg, accum_steps)
    named = dict(model.named_parameters())
    state = S.shard_opt_state(adamw.init_opt_state(named), named, opt_specs,
                              m)
    metrics = []
    with D.use_dist(ctx):
        for batch in batches:
            local = {k: _t(v).to(dev) for k, v in S.cut_batch(cfg, batch,
                                                              m).items()}
            model, state, mt = step(model, state, local)
            metrics.append({k: float(v) for k, v in mt.items()})
    named = dict(model.named_parameters())
    full = {k: S.full_tensor(p, p.mesh_spec, m).cpu()
            for k, p in named.items()}
    return {"metrics": metrics,
            "params": (to_numpy_tree(full)
                       if torch.distributed.get_rank() == 0 else None),
            "shapes": {k: tuple(p.shape) for k, p in named.items()},
            "moment_shapes": {k: tuple(t.shape)
                              for k, t in state["m"].items()},
            "launches": {k: v for k, v in K.launch_counts().items() if v}}


def mesh_trainer(arch, mesh_shape, steps, ckpt_dir, *, seq=32, batch=4,
                 ckpt_every=50, opt=None, zero1=False):
    """``Trainer(mesh=...)`` for ``steps`` steps on a (data, model) mesh of
    ``mesh_shape``, checkpointing to ``ckpt_dir``: -> its metrics log.
    ``zero1``: ``shardings`` with the parameters at ``named_specs(
    zero_stage=1)`` and the moments at ZeRO-3."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer
    m = mesh(tuple(mesh_shape), ("data", "model"))
    if m is None:
        return None
    cfg = _train_cfg(arch)
    shardings = None
    if zero1:
        named = dict(init_params(cfg, 0, device=CPU,
                                 dtype=cfg.param_dtype).named_parameters())
        shardings = {"params": S.named_specs(named, m, zero_stage=1),
                     "opt": S.named_specs(named, m)}
    tr = Trainer(cfg, ShapeConfig("t", seq, batch, "train"),
                 adamw.OptConfig(**(opt or {})), mesh=m, shardings=shardings,
                 seed=0, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                 log_every=1)
    tr.run(steps)
    return tr.metrics_log


def head_cut_decode(arch, tree, prompt, steps, max_len, nc=2):
    """``prefill`` then a ``decode_step`` per column of ``steps`` on a
    (1, nc) mesh with ``ssm_head_shard``: whole serving weights, the SSM
    cache cut to this rank's heads.  -> every call's logits and the cache
    leaf shapes (None past the mesh)."""
    cfg = _train_cfg(arch)
    m = mesh((1, nc), ("data", "model"))
    if m is None:
        return None
    ctx = D.DistContext(m, ssm_head_shard=True)
    model = from_numpy_params(tree, cfg, CPU)
    K.reset_launch_counts()
    with D.use_dist(ctx):
        cache = M.make_cache(cfg, prompt.shape[0], max_len, device=CPU)
        logits, cache = M.prefill(model, cfg, {"tokens": _t(prompt).long()},
                                  cache)
        outs = [_n(logits)]
        pos = prompt.shape[1]
        for i in range(steps.shape[1]):
            logits, cache = M.decode_step(model, cfg,
                                          _t(steps[:, i:i + 1]).long(),
                                          cache, pos)
            outs.append(_n(logits))
            pos += 1
    return {"logits": outs,
            "cache": {k: tuple(v.shape) for k, v in cache.items()}}


def compress(g, err, steps=1):
    """``compress_allreduce`` of this rank's gradient ``g[rank]`` over the
    whole world, ``steps`` times with error feedback: -> the mean and error
    of each step, the dtype and size of every all-reduce buffer and the
    int8 codes this rank put on the wire."""
    from repro_torch.optim.compression import compress_allreduce
    m = mesh()
    r = torch.distributed.get_rank()
    seen = []
    real = torch.distributed.all_reduce

    codes = []

    def spy(t, *a, **k):
        seen.append((str(t.dtype), t.numel()))
        if t.dtype == torch.int8:
            codes.append(_n(t))
        return real(t, *a, **k)

    e = _t(err[r])
    out = []
    torch.distributed.all_reduce = spy
    try:
        for _ in range(steps):
            mean, e = compress_allreduce(_t(g[r]), e, m, "x")
            out.append({"mean": _n(mean), "err": _n(e)})
    finally:
        torch.distributed.all_reduce = real
    return {"steps": out, "wire": seen, "codes": codes}


def mesh_from_plan(data, model):
    """``mesh_from_plan`` of a (data, model) plan on this world: -> this
    rank's coords (None past the plan) or the error it raised."""
    from repro_torch.launch.mesh import mesh_from_plan as build
    from repro_torch.runtime.fault_tolerance import ElasticPlan
    try:
        got = build(ElasticPlan(data=data, model=model, chips=data * model,
                                dropped_chips=0), backend="gloo",
                    device=CPU)
    except ValueError as e:
        return {"error": str(e)}
    return {"coords": None if got is None else dict(got.coords)}


def elastic(arch, ckpt_dir, steps, *, fault=None, seq=32, batch=8,
            ckpt_every=4, opt=None):
    """``ElasticRunner`` over the whole world (``fault``: a ``REPRO_CHAOS``
    spec armed on every rank): -> its history, metrics log, the plan
    servings of the run and whether this rank left."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import ElasticRunner
    tuner.clear_plan_cache()
    runner = ElasticRunner(_train_cfg(arch),
                           ShapeConfig("elastic", seq, batch, "train"),
                           adamw.OptConfig(**(opt or {})), ckpt_dir=ckpt_dir,
                           model_parallel=1, seed=0, ckpt_every=ckpt_every,
                           log_every=1, backend="gloo", device=CPU)
    plan = chaos.parse_env(fault) if fault else chaos.FaultPlan()
    with chaos.chaos(plan):
        result = runner.run(steps)
    return {"history": runner.history, "metrics": runner.metrics_log,
            "plans": sum(tuner.PLAN_MODE_COUNTS.values()),
            "left": result is None}


# ---------------------------------------------------------------------------
# The mesh training configurations of slice 16 and the placed search
# ---------------------------------------------------------------------------

def capacity_keep(gate_idx, num_experts, cap, mesh_shape):
    """``moe.capacity_slots`` on this rank's rows of the global (T, K)
    routing ``gate_idx`` under a training mesh whose data axes cut the
    rows: -> this rank's keep mask and slots (None off the mesh)."""
    m = mesh(tuple(mesh_shape), ("data", "model"))
    if m is None:
        return None
    ctx = D.DistContext(m, S.dp_axes(m), "model", sharded_params=True)
    nc, s = ctx.dp_size, m.axis_index(S.dp_axes(m))
    rows = gate_idx.shape[0] // nc
    with D.use_dist(ctx):
        slot, keep = MOE.capacity_slots(
            _t(gate_idx[s * rows:(s + 1) * rows]).long(), num_experts, cap)
    return {"keep": _n(keep), "slot": _n(slot)}


def placed(kind, *, store=True, repeats=2, device="cpu"):
    """The placed-search measurements on a 2-rank mesh of the world's
    first ranks with its tensors on ``device``: ``calibrate_ici`` ("ici",
    with the store's calibration after it), ``time_placed_ragged_e2e``
    ("ragged") or ``time_placed_dense_e2e`` ("dense"), small shapes,
    fp32."""
    from repro_torch.core.gemm import autotune, plan_store
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    m = mesh((2,), ("x",), dev)
    if m is None:
        return None
    if kind == "ici":
        autotune.clear_plan_store()
        cal = autotune.calibrate_ici(m, "x", widths=(16, 32), rows=64,
                                     repeats=repeats, store=store)
        st = plan_store.get_store().calibration
        out = {"cal": cal.to_json(),
               "stored": None if st is None else st.to_json(),
               "link_bw": tuner.effective_spec(tuner.H100).link_bw}
        autotune.clear_plan_store()
        return out
    if kind == "ragged":
        return autotune.time_placed_ragged_e2e(4, 64, 32, 16, mesh=m,
                                               axis="x", repeats=repeats)
    return autotune.time_placed_dense_e2e(16, 64, 32, mesh=m, axis="x",
                                          repeats=repeats)


# ---------------------------------------------------------------------------
# Serving under tensor parallelism, and the dry run's real twins
# ---------------------------------------------------------------------------

def tp_serve(arch, tree, prompt, steps, max_len, frames=None,
             device="cpu"):
    """``prefill`` then a scalar-position ``decode_step`` per column of
    ``steps`` on a (1, nc) mesh with its tensors on ``device``, the
    weights cut as the dry run cuts them (``named_specs`` at ZeRO-3: every
    attention panel tensor-parallel) and the cache's sequence over
    "model": -> every call's logits, the rank's cache rows and its kernel
    launches."""
    cfg = _train_cfg(arch)
    nc = torch.distributed.get_world_size()
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    m = mesh((1, nc), ("data", "model"), dev)
    K.reset_launch_counts()
    model = from_numpy_params(tree, cfg, dev)
    S.shard_params(model, S.named_specs(dict(model.named_parameters()), m),
                   m)
    ctx = D.DistContext(m, S.dp_axes(m), "model", sharded_params=True)
    batch = {"tokens": _t(prompt).long().to(dev)}
    if frames is not None:
        batch["frames"] = _t(frames).to(dev)
    with D.use_dist(ctx):
        cache = M.make_cache(cfg, prompt.shape[0], max_len, device=dev)
        logits, cache = M.prefill(model, cfg, batch, cache)
        outs = [_n(logits.cpu())]
        pos = prompt.shape[1] + (cfg.num_patches or 0)
        for i in range(steps.shape[1]):
            logits, cache = M.decode_step(
                model, cfg, _t(steps[:, i:i + 1]).long().to(dev), cache,
                pos)
            outs.append(_n(logits.cpu()))
            pos += 1
    rows = cache["k" if "k" in cache else "attn_k"].shape[2]
    return {"logits": outs, "cache_rows": rows,
            "launches": {k: v for k, v in K.launch_counts().items() if v}}


def dryrun_twin(arch, shape, variant, mesh_shape, overrides=None):
    """The dry run's cell (``launch.dryrun.build_cell``) of ``arch`` (with
    ``overrides``) at ``shape`` = (seq, batch, kind) under ``variant``, run
    for real on this rank of a (data, model) mesh of ``mesh_shape``: ->
    its recorded collectives as (op, bytes, axis) and its exact argument
    bytes (None past the mesh)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR
    cfg = dataclasses.replace(get_config(arch), **(overrides or {}))
    m = mesh(tuple(mesh_shape), ("data", "model"))
    if m is None:
        return None
    seq, batch, kind = shape
    with _env(C.ENV_A2A, "dense"):
        cell = DR.build_cell(cfg, ShapeConfig("twin", seq, batch, kind), m,
                             variant)
        with D.use_dist(cell.dist), C.record() as rec:
            cell.step(*cell.args)
    return {"record": [(e.op, e.bytes, e.axis) for e in rec],
            "argument_size": cell.argument_size}
