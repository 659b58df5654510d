"""Elastic re-planned training on a mesh of process-group ranks: the glue
between fault tolerance and the training stack.

``fault_tolerance.TrainSupervisor`` is the retry-with-shrink state machine;
this module runs the same loop on the real pieces, so a ``HostFailure``
(injected with ``runtime.chaos``'s ``shard_loss`` site, which fires on
every rank at the same step boundary: each rank holds the same fault plan
and probes it once a step) recovers:

  1. **re-mesh** -- ``plan_elastic_mesh`` keeps the TP degree and shrinks
     data-parallel to the survivors; ``launch.mesh.mesh_from_plan`` builds
     the smaller (data, model) mesh over the first ``plan.chips`` ranks.
     Every rank of the world joins the group builds; a rank past the plan
     then leaves the run (``run`` returns None there).
  2. **invalidate** -- every cache that closed over the old mesh is dropped
     (``invalidate_plans``).  The persistent plan store is not reset: its
     sharded keys carry the shard count.  The telemetry counters survive,
     so ``plan_mode_stats()`` shows the re-plan.
  3. **restore** -- the next ``Trainer`` restores the latest checkpoint
     onto the new mesh (whole on disk, cut to the new blocks) and replays
     the deterministic data stream from the checkpointed step: recovery is
     exactly-once in optimizer steps.

Scope: a failure this process survives (the injected one, or a
``HostFailure`` raised by the caller's own detection).  A rank that is
really dead takes its process-group world with it; recovering from that
needs a new world (``torchrun``'s elastic agent restarting the job), which
this module does not build.
"""
from __future__ import annotations

from ..core.gemm import collective, tuner
from ..launch.mesh import mesh_from_plan
from ..train.trainer import Trainer
from .fault_tolerance import HostFailure, plan_elastic_mesh


def invalidate_plans() -> None:
    """Drop what the port caches over a mesh or its shard counts: the
    planner LRUs (``tuner.clear_planner_caches``: dense, batched, ragged,
    MoE dispatch, placement, EP schedule) and the exchange realizations
    agreed per (mesh, axis) (``collective.clear_exchange_methods``).  The
    port has no dispatch-level or executor closure caches to drop (the
    reference's ``clear_dispatch_caches`` / ``clear_executor_caches``): its
    executors take the mesh at each call.  Keeps the plan store and the
    counters."""
    tuner.clear_planner_caches()
    collective.clear_exchange_methods()


class ElasticRunner:
    """Checkpoint-restart training on a shrinking mesh.

    Runs ``Trainer`` attempts until ``num_steps`` completes: each attempt
    plans the largest TP-preserving mesh for the surviving ranks, builds it,
    invalidates the stale caches and resumes from the latest checkpoint with
    deterministic data replay.  A ``HostFailure`` out of the step loop
    shrinks the survivor count and retries; anything else propagates.
    ``history`` records every attempt and failure; ``metrics_log``
    accumulates the per-attempt step metrics in order.  ``total_chips``:
    the world's size by default; ``backend`` / ``device``: the meshes'
    (``make_mesh``)."""

    def __init__(self, cfg, shape, opt_cfg=None, *, ckpt_dir,
                 model_parallel: int = 1, total_chips: int | None = None,
                 max_retries: int = 3, seed: int = 0, ckpt_every: int = 50,
                 log_every: int = 10, monitor=None, backend=None,
                 device=None):
        if not ckpt_dir:
            raise ValueError("elastic training requires a checkpoint dir "
                             "(recovery restores from it)")
        self.cfg = cfg
        self.shape = shape
        self.opt_cfg = opt_cfg
        self.ckpt_dir = ckpt_dir
        self.tp = model_parallel
        self.total_chips = total_chips
        self.max_retries = max_retries
        self.seed = seed
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.monitor = monitor
        self.backend = backend
        self.device = device
        self.history: list[dict] = []
        self.metrics_log: list[dict] = []

    def run(self, num_steps: int):
        """-> the last attempt's (model, opt state), or None on a rank the
        shrunken mesh left out."""
        import torch.distributed as dist

        chips = self.total_chips or dist.get_world_size()
        for attempt in range(self.max_retries + 1):
            plan = plan_elastic_mesh(chips, model_parallel=self.tp,
                                     global_batch=self.shape.global_batch)
            mesh = mesh_from_plan(plan, backend=self.backend,
                                  device=self.device)
            invalidate_plans()
            if mesh is None:
                self.history.append({"attempt": attempt, "chips": plan.chips,
                                     "mesh": plan.mesh_shape, "left": True})
                return None
            trainer = Trainer(self.cfg, self.shape, self.opt_cfg, mesh=mesh,
                              seed=self.seed, ckpt_dir=self.ckpt_dir,
                              ckpt_every=self.ckpt_every,
                              monitor=self.monitor,
                              log_every=self.log_every)
            start = (trainer.ckpt.latest_step() or -1) + 1
            self.history.append({"attempt": attempt, "chips": plan.chips,
                                 "mesh": plan.mesh_shape, "start": start})
            try:
                result = trainer.run(num_steps)
                self.metrics_log.extend(trainer.metrics_log)
                return result
            except HostFailure as e:
                self.metrics_log.extend(trainer.metrics_log)
                self.history.append({"attempt": attempt,
                                     "failure": type(e).__name__,
                                     "lost_chips": e.lost_chips})
                chips = plan.chips - e.lost_chips
        raise RuntimeError("exhausted elastic retries")
