"""Training loop: the train step, prefetched synthetic data,
asynchronous checkpoints and the heartbeat hook, on one device or on a
mesh of process-group ranks.

Each step boundary probes the reference's chaos sites: ``shard_loss``
raises ``HostFailure`` to the supervisor (``runtime.TrainSupervisor``,
``runtime.elastic.ElasticRunner``), and ``slow_step`` sleeps (a
straggler).  After each step ``monitor.beat(host, step)`` is called when a
monitor is given (``runtime.HeartbeatMonitor``).  Parameters are fp32
masters (``cfg.param_dtype``) on the card unless ``device`` says
otherwise; checkpoints hold the reference's tree layout, so either package
resumes the other's.

On a mesh (``mesh=``, ``shardings=``, the reference's arguments) the run
is the reference's GSPMD step in eager form, under
``use_dist(DistContext(mesh, dp_axes(mesh), "model",
sharded_params=True))``: the model is drawn whole as on one device (the
same seed, the same device) and cut to this rank's blocks under
``param_specs`` (ZeRO-3 over the data axes, tensor parallelism over
``model``; ``moe_ep`` the experts over ``moe_ep_axis``, the data axes or
the model axis; ``ssm_head_shard``
the SSD heads over ``model``), the moments follow -- or are cut by specs of
their own, ``shardings["opt"]`` (ZeRO-1: the parameters TP only, the
moments at ZeRO-3; each rank then updates the part of its parameter block
that its moments cover, and the parts are gathered over the data axes) --
and each rank reads its rows of the global batch.  The result is the
one-device step on the global batch.  A checkpoint is gathered whole
(every rank joins, mesh rank 0 writes) and restored cut, so any mesh -- or
one device, or the reference -- resumes it.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import ModelConfig, ShapeConfig
from ..core.device import resolve_device
from ..core.dist import DistContext, use_dist
from ..core.gemm import collective
from ..data.pipeline import Prefetcher, SyntheticLM
from ..launch import sharding
from ..models.model import DenseLM, init_params
from ..models.weights import load_numpy_tree, to_numpy_tree
from ..optim.adamw import OptConfig, init_opt_state
from ..runtime import chaos as _chaos
from .train_step import make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: OptConfig | None = None, *, mesh=None,
                 shardings: dict | None = None, seed: int = 0,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 log_every: int = 10, accum_steps: int = 1,
                 device: str | torch.device | None = None, monitor=None,
                 moe_ep: bool = False, moe_ep_axis: str = "dp",
                 ssm_head_shard: bool = False):
        """``mesh``: a ``launch.mesh.Mesh`` with a "model" axis (its other
        axes the data axes); the model lives on ``mesh.device``.
        ``shardings``: {"params": {parameter name: spec}, "opt": {name:
        spec}}, the reference's keys (default: ``launch.sharding.named_specs``
        at ZeRO-3, ``moe_ep`` as given, for the parameters; the moments
        follow them unless "opt" is given, which must cut each moment at
        least as the parameter is cut); the batch ``batch_specs``.
        ``moe_ep_axis``: the axis ``moe_ep`` cuts the experts over, "dp"
        (the data axes) or "model" (the reference's knob)."""
        self.cfg = cfg
        self.shape = shape
        self.opt_cfg = opt_cfg or OptConfig()
        self.seed = seed
        self.mesh = mesh
        self.shardings = dict(shardings or {})
        self.moe_ep = moe_ep
        self.moe_ep_axis = moe_ep_axis
        self.ctx = None
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"the mesh's tensors live on {mesh.device}, "
                                 f"not {device}")
            ep = (sharding.expert_axis(mesh, True, moe_ep_axis,
                                       cfg.num_experts) if moe_ep else None)
            if moe_ep and ep is None:
                raise ValueError(f"moe_ep needs a {moe_ep_axis!r} axis whose "
                                 f"size divides the {cfg.num_experts} "
                                 "experts")
            self.ctx = DistContext(mesh, sharding.dp_axes(mesh), "model",
                                   moe_ep_axis=ep,
                                   ssm_head_shard=ssm_head_shard,
                                   sharded_params=True)
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.monitor = monitor
        self.metrics_log: list[dict] = []
        self.dataset = SyntheticLM(cfg, shape, seed=seed)
        self.step_fn = make_train_step(cfg, self.opt_cfg, accum_steps)

    @property
    def writer(self) -> bool:
        """Whether this rank writes checkpoints and prints: the only one
        off a mesh, mesh rank 0 on one."""
        return self.mesh is None or all(c == 0 for c in
                                        self.mesh.coords.values())

    def init_state(self) -> tuple[DenseLM, dict]:
        """A fresh model and AdamW state: the one-device draw, on a mesh
        cut to this rank's blocks."""
        model = init_params(self.cfg, self.seed, device=self.device,
                            dtype=self.cfg.param_dtype)
        if self.mesh is not None:
            if "params" not in self.shardings:
                self.shardings["params"] = sharding.named_specs(
                    dict(model.named_parameters()), self.mesh,
                    moe_ep=self.moe_ep, moe_ep_axis=self.moe_ep_axis)
            sharding.shard_params(model, self.shardings["params"],
                                  self.mesh)
            self.shardings.setdefault("opt", self.shardings["params"])
        named = dict(model.named_parameters())
        opt = init_opt_state(named)
        if self.mesh is not None:
            sharding.shard_opt_state(opt, named, self.shardings["opt"],
                                     self.mesh)
        return model, opt

    def state_tree(self, model: DenseLM, opt: dict) -> dict:
        """The checkpointed state in the reference's layout, whole (on a
        mesh every rank joins the gathers)."""
        params = dict(model.named_parameters())
        m, v = opt["m"], opt["v"]
        if self.mesh is not None:
            def full(named, specs):
                return {k: sharding.full_tensor(t, specs[k], self.mesh)
                        for k, t in named.items()}
            params, m, v = (full(params, self.shardings["params"]),
                            full(m, self.shardings["opt"]),
                            full(v, self.shardings["opt"]))
        return {"params": to_numpy_tree(params),
                "opt": {"m": to_numpy_tree(m), "v": to_numpy_tree(v),
                        "step": opt["step"]}}

    def save(self, step: int, model: DenseLM, opt: dict,
             blocking: bool = False) -> None:
        """Checkpoint ``step``.  On a mesh every rank gathers, mesh rank 0
        writes to the end, and the ranks wait for it: a restart reads the
        step whatever rank it lands on."""
        tree = self.state_tree(model, opt)
        if self.mesh is None:
            self.ckpt.save(step, tree, blocking=blocking)
            return
        if self.writer:
            self.ckpt.save(step, tree, blocking=True)
        collective.raw_all_reduce(torch.zeros(1, device=self.device),
                                  self.mesh, self.mesh.axis_names)

    def restore_or_init(self) -> tuple[int, DenseLM, dict]:
        """A fresh state, overwritten by the latest checkpoint if there is
        one (on a mesh each block from the whole tree).  -> (first step to
        run, model, opt state)."""
        model, opt = self.init_state()
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            step, tree = self.ckpt.restore()
            params = dict(model.named_parameters())
            if self.mesh is None:
                load = load_opt = load_numpy_tree
            else:
                load, load_opt = (functools.partial(
                    sharding.load_blocks, specs=self.shardings[key],
                    mesh=self.mesh) for key in ("params", "opt"))
            load(params, tree["params"])
            load_opt(opt["m"], tree["opt"]["m"])
            load_opt(opt["v"], tree["opt"]["v"])
            opt["step"] = torch.as_tensor(tree["opt"]["step"]).to(
                self.device, torch.int32)
            start = step + 1
        return start, model, opt

    def run(self, num_steps: int,
            host: str = "host0") -> tuple[DenseLM, dict]:
        with use_dist(self.ctx) if self.ctx else contextlib.nullcontext():
            return self._run(num_steps, host)

    def _run(self, num_steps: int, host: str) -> tuple[DenseLM, dict]:
        start, model, opt = self.restore_or_init()
        cut = (None if self.mesh is None else functools.partial(
            sharding.cut_batch, self.cfg, mesh=self.mesh))
        prefetch = Prefetcher(self.dataset, start_step=start, cut=cut)
        t0 = time.perf_counter()
        try:
            for _ in range(start, num_steps):
                # A step boundary is where shard loss and stragglers are
                # noticed: an injected HostFailure propagates to the
                # supervisor.
                _chaos.fire("shard_loss")
                _chaos.maybe_delay("slow_step")
                step_i, arrays = prefetch.next()
                batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in arrays.items()}
                model, opt, metrics = self.step_fn(model, opt, batch)
                if self.monitor is not None:
                    self.monitor.beat(host, step_i)
                if step_i % self.log_every == 0 or step_i == num_steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step_i
                    m["wall_s"] = time.perf_counter() - t0
                    self.metrics_log.append(m)
                    if self.writer:
                        print(f"step {step_i:5d} loss={m['loss']:.4f} "
                              f"gnorm={m['grad_norm']:.3f} "
                              f"lr={m['lr']:.2e}", flush=True)
                if (self.ckpt and step_i > 0
                        and step_i % self.ckpt_every == 0):
                    self.save(step_i, model, opt)
        finally:
            prefetch.close()
        # The final save only on clean completion: a checkpoint must never
        # claim steps that did not run.
        if self.ckpt:
            self.save(num_steps - 1, model, opt, blocking=True)
        return model, opt
