"""Training loop on one device: the train step, prefetched synthetic data
and asynchronous checkpoints.

Mesh shardings, the elastic runner and the chaos sites of the reference
trainer are not ported; this is its single-device loop.  Parameters are
fp32 masters (``cfg.param_dtype``) on the card unless ``device`` says
otherwise; checkpoints hold the reference's tree layout, so either
package resumes the other's.
"""
from __future__ import annotations

import time

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs.base import ModelConfig, ShapeConfig
from ..core.device import resolve_device
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models.model import DenseLM, init_params
from ..models.weights import load_numpy_tree, to_numpy_tree
from ..optim.adamw import OptConfig, init_opt_state
from .train_step import make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: OptConfig | None = None, *, seed: int = 0,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 log_every: int = 10, accum_steps: int = 1,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.shape = shape
        self.opt_cfg = opt_cfg or OptConfig()
        self.seed = seed
        self.device = resolve_device(device)
        self.ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.metrics_log: list[dict] = []
        self.dataset = SyntheticLM(cfg, shape, seed=seed)
        self.step_fn = make_train_step(cfg, self.opt_cfg, accum_steps)

    def init_state(self) -> tuple[DenseLM, dict]:
        model = init_params(self.cfg, self.seed, device=self.device,
                            dtype=self.cfg.param_dtype)
        return model, init_opt_state(dict(model.named_parameters()))

    @staticmethod
    def state_tree(model: DenseLM, opt: dict) -> dict:
        """The checkpointed state in the reference's layout."""
        return {"params": to_numpy_tree(dict(model.named_parameters())),
                "opt": {"m": to_numpy_tree(opt["m"]),
                        "v": to_numpy_tree(opt["v"]), "step": opt["step"]}}

    def restore_or_init(self) -> tuple[int, DenseLM, dict]:
        """A fresh state, overwritten by the latest checkpoint if there is
        one.  -> (first step to run, model, opt state)."""
        model, opt = self.init_state()
        start = 0
        if self.ckpt and self.ckpt.latest_step() is not None:
            step, tree = self.ckpt.restore()
            load_numpy_tree(dict(model.named_parameters()), tree["params"])
            load_numpy_tree(opt["m"], tree["opt"]["m"])
            load_numpy_tree(opt["v"], tree["opt"]["v"])
            opt["step"] = torch.as_tensor(tree["opt"]["step"]).to(
                self.device, torch.int32)
            start = step + 1
        return start, model, opt

    def run(self, num_steps: int) -> tuple[DenseLM, dict]:
        start, model, opt = self.restore_or_init()
        prefetch = Prefetcher(self.dataset, start_step=start)
        t0 = time.perf_counter()
        try:
            for _ in range(start, num_steps):
                step_i, host = prefetch.next()
                batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in host.items()}
                model, opt, metrics = self.step_fn(model, opt, batch)
                if step_i % self.log_every == 0 or step_i == num_steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step_i
                    m["wall_s"] = time.perf_counter() - t0
                    self.metrics_log.append(m)
                    print(f"step {step_i:5d} loss={m['loss']:.4f} "
                          f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}",
                          flush=True)
                if (self.ckpt and step_i > 0
                        and step_i % self.ckpt_every == 0):
                    self.ckpt.save(step_i, self.state_tree(model, opt))
        finally:
            prefetch.close()
        # The final save only on clean completion: a checkpoint must never
        # claim steps that did not run.
        if self.ckpt:
            self.ckpt.save(num_steps - 1, self.state_tree(model, opt),
                           blocking=True)
        return model, opt
