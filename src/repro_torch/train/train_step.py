"""Train / serve step factories used by the trainer, the dry run and the
tests."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.dist import current_dist
from ..models.model import DenseLM, decode_step, loss_fn, prefill
from ..optim.adamw import OptConfig, apply_updates


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    accum_steps: int = 1, aux_weight: float = 0.01):
    """Returns train_step(model, opt_state, batch) -> (model, opt_state,
    metrics), updating the model and the state in place.

    The batch is a dict of tensors on the model's device.  ``accum_steps >
    1`` splits it along the batch into microbatches run one after the
    other, their fp32 gradients summed in the parameters' ``.grad`` and
    divided by ``accum_steps`` (gradient accumulation, as the reference's
    scan); the metrics are the last microbatch's.  Metrics are 0-d device
    tensors: reading one waits for the step.

    Under a ``DistContext`` with ``sharded_params`` (``train.Trainer`` on a
    mesh) the model holds this rank's blocks and the batch this rank's
    rows; the gradients land on the blocks through the gathers' backward
    (``launch.sharding.gathered``), microbatches split the local rows, and
    the update runs on the blocks with the whole model's gradient norm."""

    def single(model: DenseLM, batch: dict) -> dict:
        total, metrics = loss_fn(model, cfg, batch, aux_weight=aux_weight)
        total.backward()
        # The global batch's (on a mesh, ``total`` is this rank's share).
        metrics["total_loss"] = (metrics["loss"]
                                 + aux_weight * metrics["aux_loss"])
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(model: DenseLM, opt_state: dict, batch: dict):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum_steps == 1:
            metrics = single(model, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % accum_steps:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{accum_steps} microbatches")
            mb = rows // accum_steps
            for i in range(accum_steps):
                metrics = single(model, {k: v[i * mb:(i + 1) * mb]
                                         for k, v in batch.items()})
            with torch.no_grad():
                for p in params.values():
                    p.grad.div_(accum_steps)
        grads = {name: p.grad for name, p in params.items()}
        ctx = current_dist()
        mesh = ctx.mesh if ctx is not None and ctx.sharded_params else None
        _, opt_state, stats = apply_updates(params, grads, opt_state, opt_cfg,
                                            mesh=mesh)
        metrics.update(stats)
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """Returns prefill_step(model, batch, cache) -> (greedy tokens (B,)
    int32, cache): the prompt through the stack, the cache filled in
    place, the argmax of the last position's logits (the reference's)."""
    def prefill_step(model: DenseLM, batch: dict, cache: dict):
        logits, cache = prefill(model, cfg, batch, cache)
        return logits.argmax(dim=-1).to(torch.int32), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(model, cache, tokens, pos) -> (next tokens (B, 1)
    int32, cache): one greedy decode step (the reference's ``serve_step``),
    the cache written in place."""
    def serve_step(model: DenseLM, cache: dict, tokens: torch.Tensor, pos):
        logits, cache = decode_step(model, cfg, tokens, cache, pos)
        return logits.argmax(dim=-1)[:, None].to(torch.int32), cache
    return serve_step
