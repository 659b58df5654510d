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
from repro_torch.models.weights import from_numpy_params
from repro_torch.runtime import chaos

CPU = torch.device("cpu")
_MESHES: dict = {}
EP_FNS = {"matmul": X.ep_ragged_matmul, "swiglu": X.ep_ragged_swiglu,
          "moe": X.ep_ragged_moe}


def mesh(shape=None, axes=("x",), device="cpu"):
    """This rank's gloo mesh of ``shape`` (default: the whole world on one
    axis) with its tensors on ``device``, built once."""
    if shape is None:
        shape = (torch.distributed.get_world_size(),)
    key = (tuple(shape), tuple(axes), str(device))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(tuple(shape), tuple(axes), backend="gloo",
                                 device=device)
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
