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
groups over it, or over its first ranks (``mesh_from_plan``, the elastic
re-mesh: the survivors' mesh, whose groups every rank of the world builds
before the others leave).  An ``abstract`` mesh has shape and names and no
groups: the sharding rules (``launch.sharding``) read nothing else, and on
it the collectives (``core.gemm.collective``) record each call and return
a result of the right shape without moving data, every other rank taken
for this one's twin -- the production-mesh dry run (``launch.dryrun``)
runs rank 0's step on one (``make_production_mesh``: the reference's
16 x 16 and 2 x 16 x 16 meshes).
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
    or ``abstract`` (without; ``shared_device``: whether its ranks stand
    for ranks that share one device, which the EP schedule reads)."""
    shape: dict
    coords: dict
    backend: str | None = None
    transport: str | None = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    shared_device: bool = False
    _groups: dict = field(default_factory=dict, repr=False)

    @classmethod
    def abstract(cls, shape: tuple[int, ...], axes: tuple[str, ...], *,
                 device: str | torch.device = "cpu",
                 shared_device: bool = False) -> "Mesh":
        """A mesh of ``shape`` over ``axes`` with no process group, seen
        from the rank at coordinate 0 on every axis: what the sharding
        rules need, and no world.  ``device``: where its tensors live
        ("meta" for the dry run: shapes only)."""
        _check_shape(shape, axes)
        return cls(dict(zip(axes, shape)), dict.fromkeys(axes, 0),
                   device=torch.device(device), shared_device=shared_device)

    @property
    def is_abstract(self) -> bool:
        return self.backend is None

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
    """Every group along ``ax`` (all ranks of the world create all of them,
    in the same order, as ``dist.new_group`` requires; a rank outside the
    mesh has no ``coords``); returns this rank's."""
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
        if mesh.coords is not None and all(fixed[a] == mesh.coords[a]
                                           for a in others):
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
              device: str | torch.device | None = None,
              first_ranks: bool = False) -> Mesh | None:
    """This rank's ``Mesh`` of ``shape`` over ``axes`` on the running world
    (its size must be prod(shape)).  ``device``: where this rank's tensors
    live (default: the current CUDA device; with no card, ``device="cpu"``
    must be asked for, as at every entry point of the port).  ``backend``:
    None picks NCCL on a GPU and gloo on the CPU; "gloo" takes gloo
    whatever the device (with CUDA tensors the exchanges then stage
    through host memory); "nccl" on the CPU, or NCCL with two ranks on one
    GPU, raises.  ``first_ranks``: the mesh spans the first prod(shape)
    ranks of a world that may be larger; every rank of the world calls
    this, and one past the mesh gets None.  The groups of each axis and
    of all axes together are built at once."""
    _check_shape(shape, axes)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a running torch.distributed "
                           "world (init_process_group with its address, "
                           "world size and rank)")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = math.prod(shape)
    if need > world or (need != world and not first_ranks):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                         f"{need} ranks, the world has {world}")
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
    member = rank < need
    mesh = Mesh(dict(zip(axes, shape)),
                {a: coords[a] for a in axes} if member else None,
                backend, transport, device)
    for a in list(axes) + [tuple(axes)]:    # every rank builds them now
        mesh.group(a)
    return mesh if member else None


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "meta") -> Mesh:
    """The reference's production mesh as an abstract mesh (no world, no
    groups): 16 x 16 = 256 ranks over ("data", "model"), or with
    ``multi_pod`` 2 x 16 x 16 = 512 over ("pod", "data", "model") -- the
    pod axis joins the data axes.  Its tensors live on ``device`` (the
    dry run's "meta")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.abstract(shape, axes, device=device)


def mesh_from_plan(plan, *, backend: str | None = None,
                   device: str | torch.device | None = None) -> Mesh | None:
    """The shrunken (data, model) mesh an ``ElasticPlan`` prescribes, over
    the first ``plan.chips`` ranks of the running world: the survivors
    (lost and dropped ranks come off the tail, as the reference takes the
    first ``plan.chips`` devices).  Every rank of the world calls it --
    building a process group needs them all -- and a rank past the plan
    gets None and leaves.  Raises when the world has fewer ranks than the
    plan needs, so a stale plan cannot oversubscribe."""
    world = dist.get_world_size()
    if world < plan.chips:
        raise ValueError(f"elastic plan needs {plan.chips} ranks but the "
                         f"world has {world}")
    return make_mesh(tuple(plan.mesh_shape), ("data", "model"),
                     backend=backend, device=device, first_ranks=True)
