"""The elastic re-mesh on a gloo world of 4 CPU ranks, mirroring the
reference's ``tests/test_chaos.py``
(``test_elastic_replan_recovery_deterministic``):
an injected ``shard_loss`` at step 6 (1 rank lost) re-meshes (4, 1) onto
(2, 1) -- 3 survivors, and the data axis must divide the batch of 8 --
restores the step-4 checkpoint and replays the data from step 5.  The
losses after the recovery are the JAX package's single-device ``Trainer``'s
on the same initial parameters within 1e-5, two faulted runs are bitwise
equal, and the re-plan shows as more plan servings than the clean run's.
Also: ``mesh_from_plan`` over the world's first ranks and its refusal of a
plan larger than the world, and ``launch.train --elastic`` end to end."""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.weights import to_numpy_params  # noqa: E402
from torch_world import World  # noqa: E402

QWEN = "qwen3-1.7b-smoke"
SEQ, BATCH, STEPS = 32, 8, 12
OPT = {"lr": 1e-3, "warmup_steps": 2, "total_steps": 12}
FAULT = "shard_loss@6:chips=1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world"), timeout=240)
    yield w
    w.close()


@pytest.fixture(scope="module")
def runs(world, tmp_path_factory):
    """The clean run and two faulted runs, each rank's result."""
    def run(name, fault):
        return world.run("elastic", QWEN, str(tmp_path_factory.mktemp(name)),
                         STEPS, fault=fault, seq=SEQ, batch=BATCH,
                         ckpt_every=4, opt=OPT)
    return {"clean": run("clean", None), "faulted": run("faulted", FAULT),
            "again": run("again", FAULT)}


def _losses(result):
    return {m["step"]: m["loss"] for m in result["metrics"]}


def test_clean_run_is_one_attempt_on_the_whole_world(runs):
    for r in runs["clean"]:
        assert len(r["history"]) == 1 and not r["left"]
        assert r["history"][0]["mesh"] == (4, 1)
        assert sorted(_losses(r)) == list(range(STEPS))


def test_shard_loss_remeshes_onto_the_survivors(runs):
    for rank, r in enumerate(runs["faulted"]):
        hist = r["history"]
        assert [h.get("failure") for h in hist] == [None, "HostFailure",
                                                    None]
        assert hist[0]["mesh"] == (4, 1)
        assert hist[2]["mesh"] == (2, 1)       # 3 survivors -> data 2
        assert r["left"] == (rank >= 2)
        if rank < 2:
            assert hist[2]["start"] == 5       # ckpt_every=4 -> step 4
            assert sorted(s for s in _losses(r) if s >= 6) == list(
                range(6, STEPS))
    # the re-plan: a second trace's plan servings on top of the first's
    assert runs["faulted"][0]["plans"] > runs["clean"][0]["plans"]


def test_recovered_losses_match_jax_single_device(runs):
    """The JAX ``Trainer`` (one device) from the port's initial parameters
    for the same seed: steps 6-11 of the faulted run within 1e-5, and the
    clean run at every step."""
    jcfg = dataclasses.replace(jget_config(QWEN), compute_dtype="float32")
    cfg = dataclasses.replace(get_config(QWEN), compute_dtype="float32")
    tree = to_numpy_params(tmodel.init_params(cfg, 0, device="cpu",
                                              dtype="float32"))

    class Bridged(JTrainer):
        def init_state(self):
            params = jax.tree.map(jnp.asarray, tree)
            return params, jadamw.init_opt_state(params)

    ref = Bridged(jcfg, JShape("elastic", SEQ, BATCH, "train"),
                  jadamw.OptConfig(**OPT), seed=0, log_every=1)
    ref.run(STEPS)
    want = {m["step"]: m["loss"] for m in ref.metrics_log}
    got = _losses(runs["faulted"][0])
    for s in range(6, STEPS):
        assert abs(got[s] - want[s]) <= 1e-5 * want[s], (s, got[s], want[s])
    clean = _losses(runs["clean"][0])
    for s in range(STEPS):
        assert abs(clean[s] - want[s]) <= 1e-5 * want[s], s


def test_two_faulted_runs_are_bitwise_equal(runs):
    def values(r):      # every logged metric but the wall clock
        return [{k: v for k, v in m.items() if k != "wall_s"}
                for m in r["metrics"]]
    for a, b in zip(runs["faulted"], runs["again"]):
        assert a["history"] == b["history"]
        assert values(a) == values(b)


def test_mesh_from_plan_takes_the_first_ranks_and_refuses_a_larger_plan(
        world):
    got = world.run("mesh_from_plan", 1, 2)
    assert [g["coords"] for g in got] == [{"data": 0, "model": 0},
                                          {"data": 0, "model": 1},
                                          None, None]
    refused = world.run("mesh_from_plan", 4, 2)
    assert all("needs 8 ranks but the world has 4" in r["error"]
               for r in refused)


def test_launcher_elastic_recovers_end_to_end(tmp_path):
    """``launch.train --mesh 2x1 --elastic`` with a rank lost at step 2:
    the survivor resumes alone, (2, 1) -> (1, 1)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_CHAOS="shard_loss@2:chips=1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", QWEN,
         "--mesh", "2x1", "--elastic", "--device", "cpu", "--steps", "4",
         "--seq", "32", "--batch", "4", "--ckpt", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    elastic = [ln for ln in out.stdout.splitlines()
               if ln.startswith("elastic:")]
    assert len(elastic) == 3, out.stdout
    assert "'failure': 'HostFailure'" in elastic[1]
    assert "'mesh': (1, 1)" in elastic[2]
    assert out.stdout.splitlines()[-1] == "training done"
