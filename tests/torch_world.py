"""A ``torch.distributed`` world of CPU ranks for the port's mesh tests.

``World(n, tmp_dir)`` spawns ``n`` rank processes that meet on a
``file://`` store under ``tmp_dir`` (no TCP port, so test workers running
side by side cannot collide) and start a gloo world.  ``world.run(fn,
*args)`` runs ``torch_dist_tasks.<fn>(*args)`` on every rank and returns
the ranks' results in rank order; a rank that raises fails the call with
its traceback, and a call that outlives ``timeout`` seconds tears the
world down and fails.  The ranks import torch and the port only.
"""
from __future__ import annotations

import os
import queue
import sys
import traceback

import torch.multiprocessing as mp

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def _rank_main(rank, n, store, tasks, results):
    sys.path[:0] = [HERE, SRC]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    import torch_dist_tasks
    while True:
        item = tasks.get()
        if item is None:
            break
        name, args, kwargs = item
        try:
            results.put((rank, True,
                         getattr(torch_dist_tasks, name)(*args, **kwargs)))
        except BaseException:       # noqa: BLE001 -- reported to the test
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp_dir, timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.n, self.timeout = n, timeout
        self.tasks = [ctx.Queue() for _ in range(n)]
        self.results = ctx.Queue()
        store = os.path.join(str(tmp_dir), f"store{n}")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, n, store, self.tasks[r],
                                        self.results), daemon=True)
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, per_rank=None, **kwargs) -> list:
        """``torch_dist_tasks.<name>(*args, **kwargs)`` on every rank
        (``per_rank``: a list of argument tuples, one a rank, instead of
        ``args``)."""
        if not self.alive:
            raise RuntimeError("the world was torn down by an earlier "
                               "failure")
        for r in range(self.n):
            self.tasks[r].put((name, per_rank[r] if per_rank else args,
                               kwargs))
        out = [None] * self.n
        for _ in range(self.n):
            try:
                rank, ok, value = self.results.get(timeout=self.timeout)
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(f"{name}: the {self.n}-rank world did not "
                                   f"answer in {self.timeout} s") from None
            if not ok:
                self.close(kill=True)
                raise AssertionError(f"{name} failed on rank {rank}:\n"
                                     f"{value}")
            out[rank] = value
        return out

    @property
    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def close(self, kill: bool = False) -> None:
        if not kill:
            for q in self.tasks:
                q.put(None)
        for p in self.procs:
            p.join(timeout=0 if kill else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
