"""Meshes of process-group ranks: the port's counterpart of a ``jax``
device mesh.

A ``Mesh`` names its axes and their sizes, as the reference's does, and
maps each rank of the ``torch.distributed`` world onto a coordinate,
row-major (rank = ravel(coords)), the order ``P((a, b))`` lays a
multi-axis dimension out in.  Each axis has one process group: the ranks
that share every other coordinate, in rank order, so a rank's index in
its group is its coordinate on the axis.  A tuple of axes (in mesh order)
gets its group on first use; every rank asks for it at the same point of
the program, as the collectives that use it require.

The backend is fixed when the mesh is built, and with it the transport the
collectives take (``core.gemm.collective``):

  * ``"device"`` -- NCCL, when every rank has a GPU of its own: the
    exchanges move device memory;
  * ``"host"`` -- gloo: asked for by the caller, or the ranks' tensors live
    on the CPU.  With CUDA tensors the collective module copies them to
    host memory and back, explicitly, and counts the bytes.

Two ranks on one GPU cannot take NCCL (it refuses two ranks on one
device): ``make_mesh`` raises, naming the reason, instead of switching.
Nothing switches the transport later, on a failure or otherwise.

The caller starts the world (``torch.distributed.init_process_group``
with its address, world size and rank); ``make_mesh`` only builds the
groups over it.  An ``abstract`` mesh has shape and names and no groups:
the sharding rules (``launch.sharding``) read nothing else.  The
reference's ``make_production_mesh`` (512 devices) and ``mesh_from_plan``
(the elastic re-mesh) are not ported here (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import math
import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..core.device import resolve_device


@dataclass(eq=False)
class Mesh:
    """``shape`` {axis: size} in axis order (as ``jax.sharding.Mesh.shape``),
    this rank's ``coords`` {axis: index}, the ``backend`` ("nccl" | "gloo")
    and ``transport`` ("device" | "host") of its groups, and ``device``,
    where this rank's tensors live.  Built by ``make_mesh`` (with groups)
    or ``abstract`` (without)."""
    shape: dict
    coords: dict
    backend: str | None = None
    transport: str | None = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    _groups: dict = field(default_factory=dict, repr=False)

    @classmethod
    def abstract(cls, shape: tuple[int, ...], axes: tuple[str, ...]) -> "Mesh":
        """A mesh of ``shape`` over ``axes`` with no process group: what
        the sharding rules need, and no world."""
        _check_shape(shape, axes)
        return cls(dict(zip(axes, shape)), dict.fromkeys(axes, 0))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axes(self, axis) -> tuple[str, ...]:
        """``axis`` (a name or a tuple of names, in mesh order) as a tuple."""
        ax = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        order = [self.axis_names.index(a) for a in ax]
        if order != sorted(order):
            raise ValueError(f"axes {ax} are not in mesh order "
                             f"{self.axis_names}")
        return ax

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes(axis))

    def axis_index(self, axis) -> int:
        """This rank's linear index along ``axis``, major-first (the
        reference's ``_sidx``)."""
        idx = 0
        for a in self.axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis):
        """The process group of the ranks that differ only along ``axis``
        (built on first use for a tuple of axes; every rank must ask at the
        same point)."""
        ax = self.axes(axis)
        if ax not in self._groups:
            if self.backend is None:
                raise RuntimeError("an abstract mesh has no process groups")
            self._groups[ax] = _new_groups(self, ax)
        return self._groups[ax]


def _check_shape(shape, axes) -> None:
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if any(int(n) < 1 for n in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")


def _rank_of(shape: tuple[int, ...], coords: tuple[int, ...]) -> int:
    r = 0
    for n, c in zip(shape, coords):
        r = r * n + c
    return r


def _new_groups(mesh: Mesh, ax: tuple[str, ...]):
    """Every group along ``ax`` (all ranks create all of them, in the same
    order, as ``dist.new_group`` requires); returns this rank's."""
    names = mesh.axis_names
    sizes = tuple(mesh.shape.values())
    others = [a for a in names if a not in ax]
    mine = None
    for rest in _product([mesh.shape[a] for a in others]):
        fixed = dict(zip(others, rest))
        ranks = []
        for along in _product([mesh.shape[a] for a in ax]):
            c = dict(fixed, **dict(zip(ax, along)))
            ranks.append(_rank_of(sizes, tuple(c[a] for a in names)))
        g = dist.new_group(sorted(ranks), backend=mesh.backend)
        if all(fixed[a] == mesh.coords[a] for a in others):
            mine = g
    return mine


def _product(sizes):
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _product(sizes[1:]):
            yield (i,) + rest


def _one_gpu_a_rank(device: torch.device) -> bool:
    """Whether every rank of the world sits on a GPU no other rank uses
    (host name and card UUID, gathered over the world)."""
    props = torch.cuda.get_device_properties(device)
    me = (socket.gethostname(), str(getattr(props, "uuid", device.index)))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, me)
    return len(set(everyone)) == len(everyone)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              backend: str | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """This rank's ``Mesh`` of ``shape`` over ``axes`` on the running world
    (its size must be prod(shape)).  ``device``: where this rank's tensors
    live (default: the current CUDA device; with no card, ``device="cpu"``
    must be asked for, as at every entry point of the port).  ``backend``:
    None picks NCCL on a GPU and gloo on the CPU; "gloo" takes gloo
    whatever the device (with CUDA tensors the exchanges then stage
    through host memory); "nccl" on the CPU, or NCCL with two ranks on one
    GPU, raises."""
    _check_shape(shape, axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running torch.distributed "
                           "world (init_process_group with its address, "
                           "world size and rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    device = resolve_device(device)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL moves device memory: its ranks need CUDA "
                             f"tensors, not {device}")
        if not _one_gpu_a_rank(device):
            raise RuntimeError(
                "NCCL needs one GPU a rank and this world puts two ranks on "
                "one GPU; pass backend='gloo' (host transport)")
    coords, r = {}, rank
    for a, n in reversed(list(zip(axes, shape))):
        coords[a] = r % n
        r //= n
    transport = "device" if backend == "nccl" else "host"
    mesh = Mesh(dict(zip(axes, shape)), {a: coords[a] for a in axes},
                backend, transport, device)
    for a in axes:              # every rank builds every axis's groups now
        mesh.group(a)
    return mesh
