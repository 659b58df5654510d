"""The collective layer of the mesh executors: the expert-parallel token
exchange and the overlapped (ring) collective-GEMM schedules, over the
process groups of a ``launch.mesh.Mesh``.

Every call is SPMD: all ranks of the axis call the same functions in the
same order, each with its own row block, and get their own block (or the
replicated result) back.  The EP exchange is keyed by the ``group_offsets``
prefix sums: rows arrive sorted by group and experts are owned by ranks in
contiguous blocks of ``G_l = G / nc``, so rank s owns the contiguous window
[offsets[s * G_l], offsets[(s + 1) * G_l]) of the global row array.  The
offsets, like the rows, are global and the same on every rank.

**Exchange realizations** (``exchange_method``):

  * ``"primitive"`` -- ``all_to_all_single`` with split sizes: each rank
    ships only the rows of the owned windows.  The split sizes are host
    lists, so each exchange costs one device -> host read of the window
    bounds (counted in ``host_syncs``; the return leg and the backward
    reuse the forward's).  Trusted only after a round trip through it on
    the mesh reproduces its input bitwise (``_probe_offsets``; the ranks
    agree on the verdict).  ``REPRO_RAGGED_A2A`` as in the reference:
    "auto" (the default) probes, "dense" skips the probe, "primitive"
    raises when the probe fails.
  * ``"dense"`` -- ``all_gather`` of the row blocks in, ``reduce_scatter``
    back: the windows are disjoint and cover [0, offsets[G]), so the sum
    only merges them.  No host sync; more bytes.

Neither needs a window slice at a device offset: the ragged kernels read
the offsets on the device and give zeros for the rows no group owns, so a
rank runs its local product over the whole (T, d) buffer with its window's
offsets, and the rows outside the window come out zero.

**Schedules** (the ``Placement.schedule`` the tuner prices):

  * ``"gather"`` -- the exchange, ONE local product over the T-row buffer,
    the return leg;
  * ``"ring"`` -- the overlapped collective matmul: the row blocks rotate
    around the axis (``batch_isend_irecv``, the activation and the partial
    output of a hop in one batch) and each rank computes on every block
    with its window's offsets clipped to that block, so a block it owns no
    row of costs one launch and no work.  The reference skips such a block
    with ``lax.cond``; the port does not branch on the host over a device
    count, which would sync every hop.

``ring_kparallel`` is the dense analogue for ``dist_matmul``'s K-parallel
strategy: the output columns are chunked over the hops and the fp32
partial sums rotate, each hop beside the next chunk's product.

**Transport.**  Under a NCCL mesh (``mesh.transport == "device"``) the
collectives move device memory.  Under gloo (``"host"``) with CUDA
tensors, every collective copies its operands to host memory and its
results back, explicitly, and counts the bytes copied each way in
``staged_bytes`` (gloo lacks CUDA all-to-all, all-gather and send /
recv).  That follows from the mesh's backend, fixed when it was built; it
is not a fallback.  gloo's ``reduce_scatter`` is missing from some PyTorch
releases, so under gloo the return leg is an ``all_reduce`` and the rank's
slice of it.

The differentiable wrappers (``shard``, ``replicate``, ``gather``,
``reduce_sum``, ``ppermute``) read a cotangent as the reference's
``shard_map`` transpose does for a loss every rank computes alike: a
sharded input's gradient is gathered, a replicated input's summed over
the axis, a gathered output's cotangent sliced to the rank's block.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

ENV_A2A = "REPRO_RAGGED_A2A"
SCHEDULES = ("gather", "ring")

# Counters since ``reset_counts``: device -> host reads of exchange split
# sizes, and bytes copied between device and host memory under the host
# transport (both directions).
host_syncs = 0
staged_bytes = 0


def reset_counts() -> None:
    global host_syncs, staged_bytes
    host_syncs = 0
    staged_bytes = 0


def counts() -> dict[str, int]:
    return {"host_syncs": host_syncs, "staged_bytes": staged_bytes}


# ---------------------------------------------------------------------------
# Groups, staging and the raw collectives
# ---------------------------------------------------------------------------

def axis_info(mesh, axis) -> tuple:
    """(process group, axis size nc, this rank's index s) of ``axis``."""
    return mesh.group(axis), mesh.axis_size(axis), mesh.axis_index(axis)


def _staged(mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the mesh's collectives read it: host memory for a CUDA
    tensor under the host transport (counted), else ``t``."""
    global staged_bytes
    t = t.contiguous()
    if mesh.transport == "host" and t.is_cuda:
        staged_bytes += t.numel() * t.element_size()
        return t.cpu()
    return t


def _home(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A collective's result back on ``device`` (counted when it crosses)."""
    global staged_bytes
    if t.device != device:
        staged_bytes += t.numel() * t.element_size()
        return t.to(device)
    return t


def _peer(group, s: int) -> int:
    return dist.get_global_rank(group, s)


def raw_all_gather(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """The axis's blocks of ``x`` concatenated along ``dim`` in rank order."""
    group, nc, _ = axis_info(mesh, axis)
    w = _staged(mesh, x)
    parts = [torch.empty_like(w) for _ in range(nc)]
    dist.all_gather(parts, w, group=group)
    return _home(torch.cat(parts, dim=dim), x.device)


def raw_all_reduce(x: torch.Tensor, mesh, axis, op: str = "sum"
                   ) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the axis ("sum" | "max")."""
    group = mesh.group(axis)
    w = _staged(mesh, x)
    w = w.clone() if w is x else w
    dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return _home(w, x.device)


def raw_reduce_scatter(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Rank s's block (rows [s T/nc, (s+1) T/nc)) of ``x`` summed over the
    axis."""
    group, nc, s = axis_info(mesh, axis)
    tl = x.shape[0] // nc
    if mesh.backend == "nccl":
        out = torch.empty((tl,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    return raw_all_reduce(x, mesh, axis).narrow(0, s * tl, tl).clone()


def raw_ppermute(tensors, mesh, axis, shift: int = 1) -> list:
    """Each tensor sent to rank (s + shift) mod nc and its counterpart
    received from (s - shift) mod nc, all in one ``batch_isend_irecv``."""
    group, nc, s = axis_info(mesh, axis)
    if nc == 1:
        return [t.clone() for t in tensors]
    dst, src = _peer(group, (s + shift) % nc), _peer(group, (s - shift) % nc)
    sends = [_staged(mesh, t) for t in tensors]
    recvs = [torch.empty_like(w) for w in sends]
    ops = ([dist.P2POp(dist.isend, w, dst, group) for w in sends]
           + [dist.P2POp(dist.irecv, r, src, group) for r in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_home(r, t.device) for r, t in zip(recvs, tensors)]


def raw_all_to_all(x: torch.Tensor, send: list[int], recv: list[int],
                   out_rows: int, mesh, axis) -> torch.Tensor:
    """Rows x[:sum(send)] shipped in rank order by ``send`` counts; the
    received rows, ``recv`` counts from each rank in rank order, land at
    [0, sum(recv)) of a zero (out_rows, ...) buffer."""
    group = mesh.group(axis)
    w = _staged(mesh, x[:sum(send)])
    got = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=w.device)
    dist.all_to_all_single(got, w, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group)
    out = torch.zeros((out_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:sum(recv)] = _home(got, x.device)
    return out


# ---------------------------------------------------------------------------
# Differentiable wrappers (the shard_map transposes)
# ---------------------------------------------------------------------------

def _grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _block(x: torch.Tensor, nc: int, s: int, dim: int) -> torch.Tensor:
    size = x.shape[dim] // nc
    return x.narrow(dim, s * size, size)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        _, nc, s = axis_info(mesh, axis)
        return _block(x, nc, s, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return raw_all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return raw_all_reduce(g, ctx.mesh, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return raw_all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        _, nc, s = axis_info(ctx.mesh, ctx.axis)
        return _block(g, nc, s, ctx.dim).contiguous(), None, None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return raw_all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return raw_ppermute([x], mesh, axis, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return (raw_ppermute([g.contiguous()], ctx.mesh, ctx.axis,
                             -ctx.shift)[0], None, None, None)


def shard(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim`` (divisible by
    the axis size); its gradient is gathered over the axis."""
    if _grad(x):
        return _Shard.apply(x, mesh, axis, dim)
    _, nc, s = axis_info(mesh, axis)
    return _block(x, nc, s, dim)


def replicate(x: torch.Tensor | None, mesh, axis):
    """``x`` used by every rank's local compute; its gradient is summed
    over the axis."""
    if x is not None and _grad(x):
        return _Replicate.apply(x, mesh, axis)
    return x


def gather(x: torch.Tensor, mesh, axis, dim: int = 0) -> torch.Tensor:
    """The axis's blocks concatenated along ``dim`` (replicated result)."""
    if _grad(x):
        return _Gather.apply(x, mesh, axis, dim)
    return raw_all_gather(x, mesh, axis, dim)


def reduce_sum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` summed over the axis (replicated result)."""
    if _grad(x):
        return _ReduceSum.apply(x, mesh, axis)
    return raw_all_reduce(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh, axis, shift: int = 1) -> torch.Tensor:
    """``x`` sent one hop around the axis ring (received from s - shift)."""
    if _grad(x):
        return _PPermute.apply(x, mesh, axis, shift)
    return raw_ppermute([x], mesh, axis, shift)[0]


# ---------------------------------------------------------------------------
# The EP window geometry
# ---------------------------------------------------------------------------

def mask_rows(x: torch.Tensor, n_valid) -> torch.Tensor:
    """Zero rows at index >= n_valid (an int or a device scalar)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return torch.where((rows < n_valid)[:, None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def owned_bounds(offsets: torch.Tensor, g_l: int, s: int):
    """This rank's slice of the prefix sums: (local offsets (g_l + 1,),
    start, stop), on the device."""
    lo = offsets[s * g_l:(s + 1) * g_l + 1]
    return lo, lo[0], lo[g_l]


def window_bounds(offsets: torch.Tensor, g_l: int, nc: int) -> torch.Tensor:
    """(nc + 1,) global window bounds: rank j owns [wb[j], wb[j + 1])."""
    return offsets[::g_l][:nc + 1]


class Splits:
    """The host geometry of one primitive exchange (one sync): ``send[j]``
    rows of this rank's block go to rank j, ``recv[i]`` rows of its window
    come from rank i; the window is [start, stop)."""

    def __init__(self, wb: list[int], s: int, tl: int):
        nc = len(wb) - 1
        r0 = s * tl
        self.start, self.stop = wb[s], wb[s + 1]
        self.send = [max(min(wb[j + 1], r0 + tl) - max(wb[j], r0), 0)
                     for j in range(nc)]
        self.recv = [max(min(self.stop, i * tl + tl) - max(self.start, i * tl),
                         0) for i in range(nc)]


def exchange_splits(offsets: torch.Tensor, g_l: int, mesh, axis,
                    tl: int) -> Splits:
    """Read the window bounds to the host (one counted sync) and derive the
    split sizes of both legs."""
    global host_syncs
    _, nc, s = axis_info(mesh, axis)
    host_syncs += 1
    wb = [int(v) for v in window_bounds(offsets, g_l, nc).tolist()]
    return Splits(wb, s, tl)


def dispatch(x_l: torch.Tensor, offsets: torch.Tensor, g_l: int, mesh, axis,
             method: str, splits: Splits | None = None):
    """The dispatch leg: (T, d) buffer holding this rank's window rows and
    the local offsets that address them -- for "primitive" the window at
    [0, wlen) with offsets relative to its start, for "dense" the whole
    gathered row array with the window's absolute offsets."""
    _, nc, s = axis_info(mesh, axis)
    tl = x_l.shape[0]
    lo, start, _ = owned_bounds(offsets, g_l, s)
    if method == "primitive":
        win = raw_all_to_all(x_l, splits.send, splits.recv, nc * tl, mesh,
                             axis)
        return win, (lo - start).to(torch.int32)
    return raw_all_gather(x_l, mesh, axis), lo.to(torch.int32)


def combine(y: torch.Tensor, mesh, axis, method: str, tl: int,
            splits: Splits | None = None) -> torch.Tensor:
    """The return leg: the (T, n) output of ``dispatch``'s layout back to
    this rank's (tl, n) block of the global row order (rows no window
    covers stay zero)."""
    if method == "primitive":
        return raw_all_to_all(y, splits.recv, splits.send, tl, mesh, axis)
    return raw_reduce_scatter(y, mesh, axis)


# ---------------------------------------------------------------------------
# Exchange-method selection: probe the true ragged all-to-all on the mesh
# ---------------------------------------------------------------------------

def _probe_offsets(nc: int, tl: int) -> np.ndarray:
    """The reference's adversarial distribution for the probe: one window
    spanning several blocks, one empty window, singleton windows, ending
    exactly at T so the round trip must reproduce the input bitwise.  On
    two ranks the reference's construction empties the LAST window and
    leaves row T - 1 unowned, so its round trip can never be exact (the
    reference always takes the dense realization there, ROADMAP Queue 3);
    here the first window spans all T rows and the second is the empty
    one."""
    t = nc * tl
    if nc == 2:
        return np.asarray([0, t, t], dtype=np.int32)
    off = [0, t - (nc - 1)]
    for j in range(2, nc + 1):
        off.append(t - nc + j)
    off[min(2, nc)] = off[1]
    return np.asarray(off, dtype=np.int32)


def _primitive_probe_ok(mesh, axis) -> bool:
    """A dispatch + combine round trip through ``all_to_all_single`` on
    ``_probe_offsets`` must reproduce its input exactly on every rank; the
    ranks agree on the verdict (all reduce of the failures), so all take
    one realization."""
    _, nc, s = axis_info(mesh, axis)
    if nc <= 1:
        return False
    tl, d = 2, 4
    dev = mesh.device
    offs = torch.as_tensor(_probe_offsets(nc, tl), device=dev)
    x = torch.arange(nc * tl * d, dtype=torch.float32,
                     device=dev).reshape(nc * tl, d)
    x_l = x[s * tl:(s + 1) * tl]
    try:
        sp = exchange_splits(offs, 1, mesh, axis, tl)
        win, _ = dispatch(x_l, offs, 1, mesh, axis, "primitive", sp)
        back = combine(mask_rows(win, sp.stop - sp.start), mesh, axis,
                       "primitive", tl, sp)
        bad = 0 if torch.equal(back, x_l) else 1
    except RuntimeError:
        bad = 1
    flag = torch.tensor([bad], dtype=torch.int32, device=dev)
    return int(raw_all_reduce(flag, mesh, axis, "max").item()) == 0


_METHODS: dict = {}


def exchange_method(mesh, axis) -> str:
    """"primitive" when ``all_to_all_single`` passes the round-trip probe
    on this mesh's axis, "dense" otherwise; ``REPRO_RAGGED_A2A`` overrides
    ("dense": no probe; "primitive": a failed probe raises).  The verdict
    is kept per (mesh, axis, setting)."""
    env = os.environ.get(ENV_A2A, "auto")
    key = (mesh, mesh.axes(axis), env)
    if key not in _METHODS:
        if env == "dense":
            method = "dense"
        else:
            ok = _primitive_probe_ok(mesh, axis)
            if env == "primitive" and not ok:
                raise RuntimeError(
                    "REPRO_RAGGED_A2A=primitive but all_to_all_single failed "
                    "the round-trip probe on this mesh")
            method = "primitive" if ok else "dense"
        _METHODS[key] = method
    return _METHODS[key]


# ---------------------------------------------------------------------------
# Ring schedules: the overlapped collective GEMM
# ---------------------------------------------------------------------------

def _block_offsets(lo: torch.Tensor, b0: int, tl: int) -> torch.Tensor:
    """The window's offsets clipped to the block of rows [b0, b0 + tl), in
    the block's own row numbers: empty where the window misses it."""
    return (lo - b0).clamp(0, tl).to(torch.int32)


def ring_forward(x_l: torch.Tensor, offsets: torch.Tensor, g_l: int, mesh,
                 axis, compute, out_width: int, out_dtype) -> torch.Tensor:
    """Overlapped EP forward: at hop p rank s holds block b = (s - p) mod
    nc and its partial output; it adds the rows of b its window owns
    (``compute(block, offsets)``, zero elsewhere), then sends both on.
    After nc hops each output block is home, every row written by the one
    rank that owns it."""
    _, nc, s = axis_info(mesh, axis)
    tl = x_l.shape[0]
    lo, _, _ = owned_bounds(offsets, g_l, s)
    x_blk = x_l
    y_blk = torch.zeros((tl, out_width), dtype=out_dtype, device=x_l.device)
    for p in range(nc):
        b0 = ((s - p) % nc) * tl
        y_blk = y_blk + compute(x_blk, _block_offsets(lo, b0, tl))
        if p < nc - 1:
            x_blk, y_blk = raw_ppermute([x_blk, y_blk], mesh, axis)
        else:
            (y_blk,) = raw_ppermute([y_blk], mesh, axis)
    return y_blk


def ring_backward(ct_l: torch.Tensor, x_l: torch.Tensor,
                  offsets: torch.Tensor, g_l: int, mesh, axis, compute,
                  dw_zeros: tuple):
    """Overlapped EP backward: the (cotangent, activation) blocks rotate
    together with the partial dX block, one batch a hop; dW accumulates on
    the rank that owns the panels.  ``compute(ct_blk, x_blk, offsets) ->
    (dx_blk, (dw, ...))``; returns ``(dx_l, (dw, ...))``."""
    _, nc, s = axis_info(mesh, axis)
    tl = x_l.shape[0]
    lo, _, _ = owned_bounds(offsets, g_l, s)
    ct_blk, x_blk = ct_l, x_l
    dx_blk = torch.zeros_like(x_l)
    dws = list(dw_zeros)
    for p in range(nc):
        b0 = ((s - p) % nc) * tl
        dx_c, dw_c = compute(ct_blk, x_blk, _block_offsets(lo, b0, tl))
        dx_blk = dx_blk + dx_c
        dws = [d + c for d, c in zip(dws, dw_c)]
        if p < nc - 1:
            ct_blk, x_blk, dx_blk = raw_ppermute([ct_blk, x_blk, dx_blk],
                                                 mesh, axis)
        else:
            (dx_blk,) = raw_ppermute([dx_blk], mesh, axis)
    return dx_blk, tuple(dws)


def ring_kparallel(a_l: torch.Tensor, b_l: torch.Tensor, mesh, axis,
                   partial_fn) -> torch.Tensor:
    """Overlapped K-parallel collective matmul: at hop p rank s adds its
    K-shard's fp32 partial of column chunk (s - p - 1) mod nc to the sum
    arriving from the ring and sends it on; after nc hops rank s holds the
    reduced chunk s, and one gather along the columns gives the replicated
    (M, N).  ``b_l``'s N must be a multiple of nc (callers pad);
    ``partial_fn(a_l, b_chunk)`` is the fp32 local product.
    Differentiable (the hops and the gather are)."""
    _, nc, s = axis_info(mesh, axis)
    cn = b_l.shape[1] // nc
    acc = None
    for p in range(nc):
        c = (s - p - 1) % nc
        part = partial_fn(a_l, b_l[:, c * cn:(c + 1) * cn].contiguous())
        acc = part if acc is None else acc + part
        if p < nc - 1:
            acc = ppermute(acc, mesh, axis)
    return gather(acc, mesh, axis, dim=1)
