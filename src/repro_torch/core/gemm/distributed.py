"""Mesh-scale ftIMM executors over process groups: the execution side of
the placement the tuner plans (``tuner.plan_*(num_shards=)``).

Every function is SPMD: each rank of ``mesh[axis]`` calls it with the same
global arguments (replicated operands, global offsets) -- the expert
panels excepted, which are the rank's own -- and gets the replicated
global result back.  What the reference's ``shard_map`` in_specs do, the
executors do here: cut the rank's block of each operand; what its
out_specs and GSPMD do, they do too: gather the blocks (or reduce the
partials).  Every local product goes through the dispatch layer
(``matmul`` / ``batched_matmul`` / ``ragged_matmul`` / ``ragged_swiglu``
and their backward products), so on a CUDA tensor it launches the
hand-written kernels; the collectives are ``core.gemm.collective``'s.  No
executor takes a shortcut at one shard: a size-1 axis runs the same
exchanges, as the reference's size-1 ``shard_map`` does.

  * **dense** -- ``dist_matmul``: the paper's two multi-core strategies.
    Alg. 4 (m_parallel) shards A's rows (padded to the shard count, the
    residual's rows alongside) with B replicated: no steady-state
    collective.  Alg. 5 (k_parallel) shards the contraction and reduces
    the fp32 partials -- one ``all_reduce`` after the local product
    ("gather" schedule) or the overlapped ring (``ring_kparallel``,
    "ring") -- with the epilogue applied after the reduction.
  * **batched** -- ``dist_batched_matmul``: the batch / expert dim sharded
    (padded to the shard count), shared 2-D operands replicated.
  * **ragged** -- ``ep_ragged_matmul`` / ``ep_ragged_swiglu`` /
    ``ep_ragged_moe``: expert-parallel capacity-free MoE.  Each is a
    ``torch.autograd.Function``: the rank's row block (T padded to the
    shard count) goes through the exchange to the ranks owning its
    experts, the local ragged kernels run on this rank's ``G / nc``
    panels, the inverse exchange restores the global row order and the
    blocks are gathered.  The backward sends the (cotangent, activation)
    pair across the axis as ONE exchange (concatenated columns, or one
    batch a ring hop), computes dX with the local "nt" ragged product and
    dW with ``ftimm_gemm_ragged_dw``; an expert's dW stays on the rank
    that owns its panel.  ``ep_ragged_moe`` keeps the (rows, d_ff) hidden
    on the owning rank: one d_model-wide exchange each way.

The EP ladder (``_ep_ladder``) is ring -> gather -> single, with the
``ep_ring`` / ``ep_gather`` chaos sites at the reference's places.  A rung
is left for the next only when the ranks agree: each probes its fault
site, and one ``all_reduce(MAX)`` of the failure flags decides for all,
so a fault on one rank cannot send it alone to another rung while its
peers wait in a collective.  A failure inside a rung that has begun its
collectives raises (the ranks cannot leave a collective together).  The
single rung all-gathers the panels over the axis -- the gather the
reference's GSPMD makes implicitly -- and runs the same ragged kernels on
the full panels.  Each degradation is counted in
``tuner.plan_mode_stats()["degraded"]`` as ``ep:ring->gather`` /
``ep:gather->single``.

Schedule and exchange: the explicit ``schedule`` argument, else
``REPRO_EP_SCHEDULE``, else ``tuner.preferred_ep_schedule`` with
``serial`` the number of the axis's ranks that share one device (the CPU
or one GPU: their local products serialize); a multi-axis or one-rank
axis takes "gather".  The exchange realization is
``collective.exchange_method``'s.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ...kernels.ftimm.epilogue import IDENTITY, Epilogue
from ...runtime import chaos as _chaos
from . import collective as C
from .dispatch import (_check_epi, _degraded, _run_ragged, _run_ragged_dw,
                       _swiglu_bwd, batched_matmul, matmul, ragged_matmul,
                       ragged_swiglu)
from .tuner import note_plan_use, plan_distributed, preferred_ep_schedule

ENV_EP_SCHEDULE = "REPRO_EP_SCHEDULE"
F32 = torch.float32


def _pad_dim(x: torch.Tensor | None, dim: int, n: int):
    """``x`` zero-padded by ``n`` along ``dim`` (differentiable)."""
    if x is None or not n:
        return x
    pad = [0, 0] * (x.ndim - dim - 1) + [0, n]
    return F.pad(x, pad)


def dist_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh, axis="model",
                strategy: str | None = None, schedule: str | None = None,
                out_dtype=None, epilogue: Epilogue | None = None,
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """C = epi(A (M, K) @ B (K, N)) parallelized over ``mesh[axis]``; the
    operands and the result are replicated.  ``strategy`` None plans it
    (``plan_distributed``, which also gives the schedule when ``schedule``
    is None); m_parallel is "gather" only.  Under m_parallel the residual's
    rows shard with A and each rank fuses the tail into its own product;
    under k_parallel the tail runs after the fp32 reduction (an activation
    is not linear)."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(
            f"dist_matmul contraction mismatch: a has shape {tuple(a.shape)} "
            f"(K = {k}) but b has shape {tuple(b.shape)} (K = {k2})")
    epi = IDENTITY if epilogue is None else epilogue
    if epi.scale_vec:
        raise ValueError("dist_matmul takes no dequant scale vector")
    _check_epi(epi, bias, residual, None)
    nc = mesh.axis_size(axis)
    if strategy is None:
        plan = plan_distributed(m, k, n, nc, a.element_size())
        note_plan_use("dist_dense", plan.local)
        strategy = plan.strategy
        if schedule is None:
            schedule = plan.placement.schedule
    schedule = schedule or "gather"
    if schedule not in C.SCHEDULES:
        raise ValueError(f"unknown schedule: {schedule!r}")
    if schedule == "ring" and strategy != "k_parallel":
        raise ValueError(f"ring schedule is undefined for {strategy} (no "
                         "steady-state collective to overlap)")
    out_dtype = out_dtype or a.dtype

    if strategy == "m_parallel":
        pad_m = (-m) % nc
        a_l = C.shard(_pad_dim(a, 0, pad_m), mesh, axis, 0)
        res_l = (None if residual is None
                 else C.shard(_pad_dim(residual, 0, pad_m), mesh, axis, 0))
        out_l = matmul(a_l, C.replicate(b, mesh, axis), out_dtype=out_dtype,
                       epilogue=epilogue, bias=C.replicate(bias, mesh, axis),
                       residual=res_l)
        out = C.gather(out_l, mesh, axis, 0)
        return out[:m] if pad_m else out

    if strategy != "k_parallel":
        raise ValueError(f"unknown strategy: {strategy}")
    pad_k = (-k) % nc
    pad_n = (-n) % nc if schedule == "ring" else 0
    a_l = C.shard(_pad_dim(a, 1, pad_k), mesh, axis, 1)
    b_l = C.shard(_pad_dim(_pad_dim(b, 0, pad_k), 1, pad_n), mesh, axis, 0)
    if schedule == "ring":
        full = C.ring_kparallel(
            a_l, b_l, mesh, axis,
            lambda al, bc: matmul(al, bc, out_dtype=F32))[:, :n]
    else:
        # Paper Alg. 5 line 12: reduce the partial C among the cores.
        full = C.reduce_sum(matmul(a_l, b_l, out_dtype=F32), mesh, axis)
    if not epi.is_identity:
        full = epi.apply(full, bias=bias, residual=residual)
    return full.to(out_dtype)


def dist_batched_matmul(a: torch.Tensor, b: torch.Tensor, *, mesh,
                        axis="data", trans: str = "nn",
                        out_dtype=None) -> torch.Tensor:
    """Batched / grouped GEMM with the batch (expert) dim sharded over
    ``mesh[axis]``: the expert_parallel placement of the capacity-mode MoE
    GEMMs (E, C, D) @ (E, D, F).  A 2-D (shared) operand is replicated;
    each rank runs ``batched_matmul`` on its G / nc entries and the blocks
    are gathered."""
    if a.ndim != 3 and b.ndim != 3:
        raise ValueError(f"need a batched operand: {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")
    g = a.shape[0] if a.ndim == 3 else b.shape[0]
    pad_g = (-g) % mesh.axis_size(axis)

    def local(x):
        if x.ndim != 3:
            return C.replicate(x, mesh, axis)
        return C.shard(_pad_dim(x, 0, pad_g), mesh, axis, 0)

    out_l = batched_matmul(local(a), local(b), trans=trans,
                           out_dtype=out_dtype)
    out = C.gather(out_l, mesh, axis, 0)
    return out[:g] if pad_g else out


# ---------------------------------------------------------------------------
# Expert-parallel ragged (capacity-free) grouped GEMM
# ---------------------------------------------------------------------------

def _serial(mesh, axis) -> int:
    """How many of the axis's ranks share one device: all of them on the
    CPU or on one GPU (their local products serialize, as the reference's
    fake CPU devices do), else 1."""
    nc = mesh.axis_size(axis)
    if mesh.device.type != "cuda":
        return nc
    return nc if torch.cuda.device_count() < mesh.size else 1


def _resolve_ep_schedule(schedule, mesh, axis, g, total, k, n, in_bytes,
                         out_bytes) -> str:
    """Explicit argument > ``REPRO_EP_SCHEDULE`` > the planner's
    preference; the ring rotates ONE axis, so a multi-axis or one-rank
    axis takes "gather"."""
    nc = mesh.axis_size(axis)
    if schedule is None:
        schedule = os.environ.get(ENV_EP_SCHEDULE) or None
    if schedule is None:
        schedule = preferred_ep_schedule(g, total, k, n, in_bytes,
                                         out_bytes, nc,
                                         serial=_serial(mesh, axis))
    if schedule not in C.SCHEDULES:
        raise ValueError(f"unknown EP schedule: {schedule!r}")
    if schedule == "ring" and (len(mesh.axes(axis)) > 1 or nc <= 1):
        schedule = "gather"
    return schedule


class _Ep:
    """One EP call's fixed arguments: the mesh and axis, the schedule and
    exchange realization, the kind of product ("matmul" | "swiglu" |
    "moe"), the output dtype, and the host split sizes when the
    realization needs them (read once, in the forward)."""

    def __init__(self, mesh, axis, schedule, method, kind, out_dtype, g_l):
        self.mesh, self.axis, self.schedule = mesh, axis, schedule
        self.method, self.kind, self.out_dtype = method, kind, out_dtype
        self.g_l = g_l
        self.splits = None

    # -- the local products ------------------------------------------------
    def forward_local(self, win, loffs, panels):
        od = self.out_dtype
        if self.kind == "matmul":
            return ragged_matmul(win, panels[0], loffs, out_dtype=od)
        h = ragged_swiglu(win, panels[0], panels[1], loffs, out_dtype=od)
        if self.kind == "swiglu":
            return h
        return ragged_matmul(h, panels[2], loffs, out_dtype=od)

    def backward_local(self, ct, x, loffs, panels):
        """(dx, (dW, ...)) of the rows ``loffs`` addresses in (ct, x)."""
        def nt(p, w):
            return _run_ragged(p, w, loffs, "nt", F32)

        def dw(p, dt):
            return _run_ragged_dw(x, p, loffs, dt)

        if self.kind == "matmul":
            w = panels[0]
            return (_run_ragged(ct, w, loffs, "nt", x.dtype),
                    (_run_ragged_dw(x, ct, loffs, w.dtype),))
        wg, wu = panels[0], panels[1]
        a = _run_ragged(x, wg, loffs, "nn", F32)
        b = _run_ragged(x, wu, loffs, "nn", F32)
        if self.kind == "swiglu":
            dx, dwg, dwu = _swiglu_bwd(x, wg, wu, a, b, ct, nt, dw)
            return dx, (dwg, dwu)
        wd = panels[2]
        h = (a * torch.sigmoid(a) * b).to(x.dtype)
        dh = _run_ragged(ct, wd, loffs, "nt", F32)
        dwd = _run_ragged_dw(h, ct, loffs, wd.dtype)
        dx, dwg, dwu = _swiglu_bwd(x, wg, wu, a, b, dh, nt, dw)
        return dx, (dwg, dwu, dwd)

    # -- the schedules -----------------------------------------------------
    def forward(self, x_l, offsets, panels):
        mesh, axis = self.mesh, self.axis
        if self.schedule == "ring":
            return C.ring_forward(
                x_l, offsets, self.g_l, mesh, axis,
                lambda blk, lo: self.forward_local(blk, lo, panels),
                panels[-1].shape[2], self.out_dtype)
        if self.method == "primitive":
            self.splits = C.exchange_splits(offsets, self.g_l, mesh, axis,
                                            x_l.shape[0])
        win, loffs = C.dispatch(x_l, offsets, self.g_l, mesh, axis,
                                self.method, self.splits)
        y = self.forward_local(win, loffs, panels)
        return C.combine(y, mesh, axis, self.method, x_l.shape[0],
                         self.splits)

    def backward(self, ct_l, x_l, offsets, panels):
        mesh, axis = self.mesh, self.axis
        if self.schedule == "ring":
            return C.ring_backward(
                ct_l, x_l, offsets, self.g_l, mesh, axis,
                lambda c, xb, lo: self.backward_local(c, xb, lo, panels),
                tuple(torch.zeros_like(w) for w in panels))
        # The fused exchange: cotangent and activation as one payload.
        n_ct = ct_l.shape[1]
        cat_dt = torch.promote_types(ct_l.dtype, x_l.dtype)
        cat = torch.cat([ct_l.to(cat_dt), x_l.to(cat_dt)], dim=1)
        win, loffs = C.dispatch(cat, offsets, self.g_l, mesh, axis,
                                self.method, self.splits)
        ct_w = win[:, :n_ct].to(ct_l.dtype).contiguous()
        x_w = win[:, n_ct:].to(x_l.dtype).contiguous()
        dx_w, dws = self.backward_local(ct_w, x_w, loffs, panels)
        return (C.combine(dx_w, mesh, axis, self.method, x_l.shape[0],
                          self.splits), dws)


class _EpRagged(torch.autograd.Function):
    """The reference's custom-VJP'd EP executors, one for all three kinds:
    forward = row block -> exchange -> local ragged kernels -> inverse
    exchange -> gather; backward = the fused (cotangent, x) exchange, the
    local dX / dW products, the inverse exchange of dX and its gather.
    Panels are the rank's own; their gradients stay local."""

    @staticmethod
    def forward(ctx, x_p, offsets, ep, *panels):
        _, nc, s = C.axis_info(ep.mesh, ep.axis)
        tl = x_p.shape[0] // nc
        x_l = x_p[s * tl:(s + 1) * tl]
        y_l = ep.forward(x_l, offsets, panels)
        ctx.ep = ep
        ctx.save_for_backward(x_p, offsets, *panels)
        return C.raw_all_gather(y_l, ep.mesh, ep.axis)

    @staticmethod
    def backward(ctx, g):
        x_p, offsets, *panels = ctx.saved_tensors
        ep = ctx.ep
        _, nc, s = C.axis_info(ep.mesh, ep.axis)
        tl = x_p.shape[0] // nc
        ct_l = g[s * tl:(s + 1) * tl].contiguous()
        x_l = x_p[s * tl:(s + 1) * tl]
        dx_l, dws = ep.backward(ct_l, x_l, offsets, panels)
        dx = C.raw_all_gather(dx_l, ep.mesh, ep.axis)
        return (dx, None, None) + tuple(dws)


def _gather_panels(panels, mesh, axis):
    """The full panels of every rank, concatenated on the expert dim (the
    single rung's gather; a panel's gradient comes back as its block)."""
    return tuple(C.gather(w, mesh, axis, 0) for w in panels)


def _agreed_fault(site: str, mesh, axis) -> BaseException | None:
    """Probe ``site`` on this rank, then agree: the local fault, a stand-in
    naming a peer's, or None when no rank failed (one ``all_reduce(MAX)``
    of the failure flags over the axis)."""
    err = None
    try:
        _chaos.fire(site)
    except Exception as e:      # noqa: BLE001 -- any fault moves the rung
        err = e
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int32,
                        device=mesh.device)
    if int(C.raw_all_reduce(flag, mesh, axis, "max").item()) == 0:
        return None
    return err or _chaos.CollectiveFailure(f"{site} failed on a peer rank")


def _ep_ladder(run, schedule: str, single, mesh, axis):
    """The EP fallback ladder: ring -> gather -> single.  ``run(schedule)``
    runs the sharded executor, ``single()`` the last rung.  Every step down
    is agreed by all ranks of the axis first (``_agreed_fault``) and
    counted in ``plan_mode_stats()["degraded"]``."""
    if schedule == "ring":
        err = _agreed_fault("ep_ring", mesh, axis)
        if err is None:
            return run("ring")
        _degraded("ep", "ring->gather", err)
        schedule = "gather"
    err = _agreed_fault("ep_gather", mesh, axis)
    if err is None:
        return run(schedule)
    _degraded("ep", "gather->single", err)
    return single()


def _ep_call(kind: str, x, panels, group_offsets, mesh, axis, out_dtype,
             schedule):
    if x.ndim != 2 or any(w.ndim != 3 for w in panels):
        raise ValueError((tuple(x.shape), [tuple(w.shape) for w in panels]))
    nc = mesh.axis_size(axis)
    g_l = panels[0].shape[0]
    g = g_l * nc
    if group_offsets.shape[0] != g + 1:
        raise ValueError(f"{group_offsets.shape[0] - 1} groups but "
                         f"{g_l} panels on each of {nc} ranks")
    out_dtype = out_dtype or x.dtype
    t = x.shape[0]
    pad_t = (-t) % nc
    x_p = _pad_dim(x, 0, pad_t)
    offs = group_offsets.to(torch.int32)
    k, n = panels[0].shape[1], panels[-1].shape[2]
    schedule = _resolve_ep_schedule(schedule, mesh, axis, g, x_p.shape[0],
                                    k, n, x.element_size(),
                                    out_dtype.itemsize)
    method = C.exchange_method(mesh, axis)

    def run(sched):
        ep = _Ep(mesh, axis, sched, method, kind, out_dtype, g_l)
        out = _EpRagged.apply(x_p, offs, ep, *panels)
        return out[:t] if pad_t else out

    def single():
        full = _gather_panels(panels, mesh, axis)
        if kind == "matmul":
            return ragged_matmul(x, full[0], offs, out_dtype=out_dtype)
        h = ragged_swiglu(x, full[0], full[1], offs,
                          out_dtype=out_dtype if kind == "swiglu" else None)
        if kind == "swiglu":
            return h
        return ragged_matmul(h, full[2], offs, out_dtype=out_dtype)

    return _ep_ladder(run, schedule, single, mesh, axis)


def ep_ragged_matmul(x: torch.Tensor, w: torch.Tensor,
                     group_offsets: torch.Tensor, *, mesh, axis="data",
                     out_dtype=None, schedule: str | None = None
                     ) -> torch.Tensor:
    """Expert-parallel ragged grouped GEMM over ``mesh[axis]``: the
    contract of ``ragged_matmul`` -- ``x`` (T, D) rows sorted by group,
    ``group_offsets`` (G + 1,) prefix sums, both global -- with ``w`` this
    rank's (G / nc, D, F) panels (experts [s G/nc, (s+1) G/nc)).  Returns
    the replicated (T, F).  ``schedule``: "ring" | "gather" | None (the
    module docstring)."""
    return _ep_call("matmul", x, (w,), group_offsets, mesh, axis, out_dtype,
                    schedule)


def ep_ragged_swiglu(x: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, group_offsets: torch.Tensor, *,
                     mesh, axis="data", out_dtype=None,
                     schedule: str | None = None) -> torch.Tensor:
    """Expert-parallel fused ragged MoE front half: silu(x Wg_g) * (x Wu_g)
    with this rank's gate / up panels, one exchange each way (the
    contract of ``ep_ragged_matmul``)."""
    if w_gate.shape != w_up.shape:
        raise ValueError((tuple(w_gate.shape), tuple(w_up.shape)))
    return _ep_call("swiglu", x, (w_gate, w_up), group_offsets, mesh, axis,
                    out_dtype, schedule)


def ep_ragged_moe(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, group_offsets: torch.Tensor, *,
                  mesh, axis="data", out_dtype=None,
                  schedule: str | None = None) -> torch.Tensor:
    """The whole expert-parallel ragged MoE MLP, (silu(x Wg_g) * (x Wu_g))
    Wd_g, with this rank's three panel sets: the tokens cross the axis once
    each way (d_model wide), the (rows, d_ff) hidden never does.  ``x`` (T,
    D) global; ``w_gate`` / ``w_up`` (G / nc, D, F), ``w_down`` (G / nc, F,
    D) this rank's.  Returns the replicated (T, D)."""
    if w_gate.shape != w_up.shape:
        raise ValueError((tuple(w_gate.shape), tuple(w_up.shape)))
    if (w_down.ndim != 3 or w_down.shape[0] != w_gate.shape[0]
            or w_down.shape[1] != w_gate.shape[2]):
        raise ValueError((tuple(w_gate.shape), tuple(w_down.shape)))
    return _ep_call("moe", x, (w_gate, w_up, w_down), group_offsets, mesh,
                    axis, out_dtype, schedule)
