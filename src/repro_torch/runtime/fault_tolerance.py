"""Fault tolerance & straggler mitigation for multi-host training
(a copy of the JAX package's pure-Python module; exercised against
simulated hosts in tests/test_torch_chaos.py):

* HeartbeatMonitor — every host records a heartbeat per step; hosts silent
  past ``dead_after`` are failed, hosts slower than ``straggler_factor`` x
  median step time are flagged (mitigation at this scale is exclusion +
  elastic restart, since SPMD steps are barrier-synchronous).
* ElasticPlan — given the surviving host/chip count, choose the largest
  (data, model) mesh <= survivors that preserves TP degree (params reshard
  cleanly) and keeps global batch divisible; the trainer then restores the
  latest checkpoint onto the new mesh (Checkpointer.restore re-shards) and
  replays the data stream deterministically from (seed, step).
* TrainSupervisor — retry-with-shrink loop: run -> on failure, compute the
  elastic plan, restore, continue.  The deterministic data pipeline makes
  the recovery exactly-once w.r.t. optimizer steps.
"""
from __future__ import annotations

import dataclasses
import statistics
import time


@dataclasses.dataclass
class HostState:
    last_beat: float
    last_step: int = -1
    step_times: list = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, hosts: list[str], *, dead_after: float = 60.0,
                 straggler_factor: float = 2.0, clock=time.monotonic):
        self.clock = clock
        self.dead_after = dead_after
        self.straggler_factor = straggler_factor
        now = clock()
        self.hosts = {h: HostState(last_beat=now) for h in hosts}

    def beat(self, host: str, step: int) -> None:
        st = self.hosts[host]
        now = self.clock()
        if st.last_step >= 0 and step > st.last_step:
            st.step_times.append((now - st.last_beat) / (step - st.last_step))
            st.step_times = st.step_times[-32:]
        st.last_beat = now
        st.last_step = step

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.dead_after]

    def stragglers(self) -> list[str]:
        times = {h: (sum(st.step_times) / len(st.step_times))
                 for h, st in self.hosts.items() if st.step_times}
        if len(times) < 2:
            return []
        med = statistics.median(times.values())
        return [h for h, t in times.items()
                if t > self.straggler_factor * med]

    def remove(self, host: str) -> None:
        self.hosts.pop(host, None)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    chips: int
    dropped_chips: int

    @property
    def mesh_shape(self) -> tuple[int, int]:
        return (self.data, self.model)


def plan_elastic_mesh(surviving_chips: int, *, model_parallel: int,
                      global_batch: int) -> ElasticPlan:
    """Largest (data, model) grid that fits the survivors, keeping the TP
    degree fixed (so param shards stay valid) and dp | global_batch."""
    if surviving_chips < model_parallel:
        raise ValueError(
            f"fewer chips ({surviving_chips}) than TP degree "
            f"({model_parallel}); cannot re-mesh")
    dp = surviving_chips // model_parallel
    while dp > 1 and global_batch % dp != 0:
        dp -= 1
    chips = dp * model_parallel
    return ElasticPlan(data=dp, model=model_parallel, chips=chips,
                       dropped_chips=surviving_chips - chips)


class TrainSupervisor:
    """Checkpoint-restart loop: run the step loop, and on a failure event
    re-mesh + restore + resume.  ``run_fn(start_step, mesh_shape)`` should
    raise ``HostFailure`` (or any exception) to signal a lost host."""

    def __init__(self, *, checkpointer, model_parallel: int,
                 global_batch: int, total_chips: int, max_retries: int = 3):
        self.ckpt = checkpointer
        self.tp = model_parallel
        self.gb = global_batch
        self.chips = total_chips
        self.max_retries = max_retries
        self.history: list[dict] = []

    def run(self, run_fn) -> int:
        chips = self.chips
        for attempt in range(self.max_retries + 1):
            plan = plan_elastic_mesh(chips, model_parallel=self.tp,
                                     global_batch=self.gb)
            start = (self.ckpt.latest_step() or -1) + 1
            self.history.append({"attempt": attempt, "chips": plan.chips,
                                 "mesh": plan.mesh_shape, "start": start})
            try:
                return run_fn(start, plan.mesh_shape)
            except HostFailure as e:
                self.history.append({"attempt": attempt,
                                     "failure": type(e).__name__,
                                     "lost_chips": e.lost_chips})
                chips = plan.chips - e.lost_chips
        raise RuntimeError("exhausted retries")


class HostFailure(Exception):
    def __init__(self, lost_chips: int, msg: str = ""):
        super().__init__(msg or f"lost {lost_chips} chips")
        self.lost_chips = lost_chips
