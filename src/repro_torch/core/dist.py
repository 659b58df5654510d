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

Training on a mesh (``train.Trainer(mesh=...)``) sets the port's own field
``sharded_params``: every parameter is then this rank's block under
``launch.sharding.param_specs`` (ZeRO-3 over the data axes, tensor
parallelism over ``model``) and ``launch.sharding.gathered`` brings it to
the layout the local compute reads; the batch is cut over the data axes.
``ssm_head_shard`` runs the SSD scan on this rank's heads
(``models.ssm``) with the weights whole or cut.
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
    expert-parallel; ``ssm_head_shard``, the SSD's heads cut over the model
    axis; ``rms_bf16``, ``models.layers.rms_norm`` normalizing in its
    input's dtype (a change of numerics, read on every device).
    ``moe_buf_shard`` and ``sp_inputs`` are carried for the reference's
    launchers (GSPMD layout hints with no eager counterpart).
    ``sharded_params`` (the port's own): the parameters are this rank's
    ``param_specs`` blocks and the rows are cut over the data axes, as the
    trainer lays them out -- unless ``batch_cut`` is False: a batch whose
    rows the data axes do not divide, which ``batch_specs`` leaves whole
    on every rank (the dry run's one-row long-context decode)."""
    mesh: Mesh
    dp_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    sp_decode: bool = True
    moe_buf_shard: bool = False
    moe_ep_axis: str | tuple[str, ...] | None = None
    ssm_head_shard: bool = False
    rms_bf16: bool = False
    sp_inputs: bool = False
    sharded_params: bool = False
    batch_cut: bool = True

    @property
    def dp_size(self) -> int:
        return int(math.prod(self.mesh.shape[a] for a in self.dp_axes))

    @property
    def model_size(self) -> int:
        return int(self.mesh.shape[self.model_axis])

    @property
    def tp(self) -> int:
        """The tensor-parallel degree: the model axis's size when the
        parameters are cut over it (``sharded_params``), else 1."""
        return self.model_size if self.sharded_params else 1

    @property
    def head_shard(self) -> int:
        """The SSD's head-parallel degree: the model axis's size under
        ``ssm_head_shard``, else 1."""
        return self.model_size if self.ssm_head_shard else 1

    @property
    def rows_cut(self) -> bool:
        """Whether the ranks of the data axes hold different rows (the
        trainer's batch cut) rather than the same ones."""
        return self.sharded_params and self.batch_cut and self.dp_size > 1


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
