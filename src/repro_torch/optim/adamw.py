"""AdamW with warmup + cosine schedule and global-norm clipping.

The state mirrors the parameters: ``m`` and ``v`` are dicts keyed by the
parameter names (``dict(model.named_parameters())``), each tensor in its
parameter's dtype and on its device, as ``zeros_like`` gives, plus the
step count.  Unlike the reference's pure functions, ``apply_updates``
updates the parameters and the moments IN PLACE (no second copy of the
model or its state on the card); it returns them for symmetry.  The lr and
clipping scale stay device tensors, so a step never waits for the host.
On a mesh (``launch.sharding.shard_params``) everything here is a block:
only the gradient norm needs the other ranks (``global_norm(mesh=)``).
Moments whose spec (their ``mesh_spec``, ``launch.sharding.shard_opt_state``)
cuts them further than their parameter's (ZeRO-1) make each rank update
only the part of the parameter block its moments cover; the updated parts
are then gathered over the axes of that further cut, so every rank holds
its whole parameter block again.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..core.gemm import collective
from ..launch.sharding import full_tensor, refine_spec, shard_tensor
from ..launch.sharding import replicas as _replicas

F32 = torch.float32


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    clip_norm: float = 1.0


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then cosine decay to ``min_lr_ratio``
    x lr at ``total_steps`` (fp32, on the step's device)."""
    step = step.to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps
                                           - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    """{"m": zeros, "v": zeros (each like its parameter), "step": 0}."""
    device = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors, *, mesh=None, replicas=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32.  On a mesh
    each tensor is this rank's block of a leaf that ``replicas[i]`` ranks
    hold alike: each block's squares count once over the mesh (divided by
    its replica count, then summed over every rank)."""
    total = None
    for i, t in enumerate(tensors):
        sq = torch.sum(torch.square(t.to(F32)))
        if replicas is not None:
            sq = sq / replicas[i]
        total = sq if total is None else total + sq
    if mesh is not None:
        total = collective.raw_all_reduce(total, mesh, mesh.axis_names)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: dict,
                  cfg: OptConfig, *, mesh=None):
    """One AdamW step in place.  -> (params, state, {"grad_norm", "lr"}).
    ``mesh``: the parameters, gradients and moments are this rank's blocks
    (each parameter's ``mesh_spec``, each moment's where it has its own);
    the gradient norm is the whole model's, and the update runs on the
    blocks."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    reps = (None if mesh is None else
            [_replicas(params[k].mesh_spec, mesh) for k in grads])
    gnorm = global_norm(grads.values(), mesh=mesh, replicas=reps)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=step.device),
                        step.to(F32))
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=step.device),
                        step.to(F32))
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g, target, extra = grads[name], p, None
        ospec = getattr(m, "mesh_spec", None)
        if mesh is not None and ospec is not None and ospec != p.mesh_spec:
            extra = refine_spec(p.mesh_spec, ospec)
            g, target = (shard_tensor(t, extra, mesh) for t in (g, p))
        g = g.to(F32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        del g
        # In place where the reference's expression allows, to hold at most
        # a few parameter-sized temporaries (the largest leaf is GBs).
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        delta = (m / bc1).div_(denom)
        del denom
        delta.add_(cfg.weight_decay * target.to(F32)).mul_(lr)
        if extra is None:
            p.copy_(p.to(F32) - delta)
        else:
            p.copy_(full_tensor((target.to(F32) - delta).to(p.dtype), extra,
                                mesh))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
