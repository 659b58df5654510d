"""The distribution context of a run on a mesh.

Model code consults ``current_dist()`` to decide whether to take the
mesh executors -- sequence-parallel flash-decode attention (the paper's
K-parallel strategy across ranks) and the expert-parallel MoE.  A launcher
sets it with ``use_dist``; None means single-device semantics.

The reference also has ``shard_act``, a GSPMD layout constraint on an
activation (``with_sharding_constraint``).  Eager PyTorch has no
counterpart: nothing lays a tensor out behind the program's back, so there
is nothing to pin.  Here the executors carry the layout themselves -- each
cuts its operands to this rank's block and gathers or reduces what it
returns -- and ``launch.sharding`` cuts the weights and caches.  So
``shard_act`` is not ported, rather than ported as a function that does
nothing.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

from ..launch.mesh import Mesh


@dataclass(frozen=True)
class DistContext:
    """The reference's fields: the mesh, its data axes and model axis,
    flash-decode on or off (``sp_decode``), and the mesh axis (or tuple of
    axes) that owns the MoE expert dimension (``moe_ep_axis``, from
    ``launch.sharding.expert_axis``), under which the ragged MoE runs
    expert-parallel.  ``moe_buf_shard``, ``ssm_head_shard``, ``rms_bf16``
    and ``sp_inputs`` are carried for the reference's launchers; no port
    code reads them yet (ROADMAP Queue 1 item 10)."""
    mesh: Mesh
    dp_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    sp_decode: bool = True
    moe_buf_shard: bool = False
    moe_ep_axis: str | tuple[str, ...] | None = None
    ssm_head_shard: bool = False
    rms_bf16: bool = False
    sp_inputs: bool = False

    @property
    def dp_size(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.dp_axes))

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape[self.model_axis])


_CURRENT: DistContext | None = None


def current_dist() -> DistContext | None:
    return _CURRENT


@contextlib.contextmanager
def use_dist(ctx: DistContext | None):
    global _CURRENT
    old = _CURRENT
    _CURRENT = ctx
    try:
        yield
    finally:
        _CURRENT = old
