"""The mesh training configurations the port added last, each held against
the JAX package's one-device step on the CPU (its result is the one-device
step on the global batch, as GSPMD's):

  * capacity-dispatch MoE with the rows cut over the data axes
    (``mixtral-8x7b-smoke`` on (data, model) = (2, 1), with and without
    ``moe_ep``, and with a capacity factor of 0.5 that drops copies; and
    with 3 experts over 4 data ranks, the buffer cut by capacity slot);
    ``moe.capacity_slots`` keeps and drops exactly the one-device run's
    copies;
  * the encoder-decoder under tensor parallelism (``whisper-base-smoke``
    on (1, 2) and (2, 2): the encoder's attention, the cross projections
    and the cross-attention on the rank's heads);
  * ZeRO-1 (``qwen3-1.7b-smoke`` on (2, 1), the parameters at
    ``named_specs(zero_stage=1)``, TP only, the moments at ZeRO-3): each
    rank holds only its moment blocks; ``Trainer`` takes
    ``shardings["opt"]`` and its checkpoint holds the reference's layout;
  * ``rms_norm`` under ``DistContext(rms_bf16=True)`` against the
    reference's, bf16 and fp32.

One AdamW step in fp32: the loss, aux loss and gradient norm within 1e-5
relative, every parameter (gathered whole) within 1e-5 normwise.  The
parameters drawn as zeros (the norm scales) hold one AdamW update after the
step, lr * g / (|g| + eps) element by element, which magnifies the fp32
summation-order difference of a gradient near eps: they are held to 1e-3
(qwen3-1.7b-smoke's ``ln1`` / ``ln2`` differ by 1.3e-4 / 2.7e-4 under every
mesh layout, ZeRO-3 on (2, 1) and TP on (1, 2) as well as ZeRO-1).  One
gloo world of 4 CPU ranks (``torch_world``) serves the module.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core import dist as jdist  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import dist as tdist  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_world import World  # noqa: E402

MIXTRAL, WHISPER, QWEN = ("mixtral-8x7b-smoke", "whisper-base-smoke",
                          "qwen3-1.7b-smoke")
SEQ, BATCH = 32, 4
TOL, ZERO_INIT_TOL = 1e-5, 1e-3
CASES = {
    "mixtral-capacity-2x1": (MIXTRAL, (2, 1), {}),
    "mixtral-capacity-ep-2x1": (MIXTRAL, (2, 1), {"moe_ep": True}),
    "mixtral-overflow-2x1": (MIXTRAL, (2, 1), {"capacity_factor": 0.5}),
    "mixtral-overflow-ep-2x1": (MIXTRAL, (2, 1), {"capacity_factor": 0.5,
                                                  "moe_ep": True}),
    "whisper-tp-1x2": (WHISPER, (1, 2), {}),
    "whisper-tp-2x2": (WHISPER, (2, 2), {}),
    "qwen-zero1-2x1": (QWEN, (2, 1), {"zero1": True}),
    # 3 experts over 4 data ranks: the buffer cut by capacity slot
    "mixtral-slots-4x1": (MIXTRAL, (4, 1), {"overrides": {"num_experts": 3}}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("world"), timeout=180)
    yield w
    w.close()


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _jcfg(arch, capacity_factor=None, overrides=()):
    cfg = dataclasses.replace(jget_config(arch), compute_dtype="float32",
                              **dict(overrides))
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def _over(case) -> tuple:
    return tuple(sorted(CASES[case][2].get("overrides", {}).items()))


@functools.lru_cache(maxsize=None)
def _init(arch, overrides=()):
    return jax.tree.map(np.asarray, jmodel.init_params(
        _jcfg(arch, overrides=overrides), jax.random.PRNGKey(0)))


def _batches(arch, steps, overrides=()):
    ds = JSynthetic(_jcfg(arch, overrides=overrides),
                    JShape("t", SEQ, BATCH, "train"), seed=0)
    return [ds.host_batch(i) for i in range(steps)]


_RUNS: dict = {}


def _run(world, case, steps=1):
    """(each step's reference metrics, the reference params after the
    last, the mesh run's rank-0 result, every rank's result) for ``steps``
    AdamW steps of ``case``, computed once."""
    if (case, steps) not in _RUNS:
        arch, shape, kw = CASES[case]
        over = _over(case)
        tree, batches = _init(arch, over), _batches(arch, steps, over)
        jcfg = _jcfg(arch, kw.get("capacity_factor"), over)
        step = jax.jit(jmake_step(jcfg, jadamw.OptConfig()))
        params = jax.tree.map(jnp.asarray, tree)
        opt, jm = jadamw.init_opt_state(params), []
        for batch in batches:
            params, opt, m = step(params, opt,
                                  jax.tree.map(jnp.asarray, batch))
            jm.append({k: float(v) for k, v in m.items()})
        ranks = world.run("mesh_steps", arch, shape, tree, batches, **kw)
        _RUNS[case, steps] = (jm, jax.tree.map(np.asarray, params),
                              ranks[0], ranks)
    return _RUNS[case, steps]


def _hold(case, jm, jp, got):
    """Each step's loss, aux loss and gradient norm, and every parameter
    after the last step, against the reference's."""
    assert len(got["metrics"]) == len(jm)
    for m, want_m in zip(got["metrics"], jm):
        for key in ("loss", "aux_loss", "grad_norm"):
            assert abs(m[key] - want_m[key]) <= TOL * max(
                abs(want_m[key]), 1.0), (key, m[key], want_m[key])
    want = dict(_leaves(jp))
    init = dict(_leaves(_init(CASES[case][0], _over(case))))
    assert sorted(want) == sorted(k for k, _ in _leaves(got["params"]))
    for k, g in _leaves(got["params"]):
        tol = ZERO_INIT_TOL if not np.any(init[k]) else TOL
        assert _err(g, want[k]) <= tol, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_step_matches_jax(world, case):
    """Loss, aux loss and gradient norm of the step, and every parameter
    after it, against the reference's one-device step."""
    _hold(case, *_run(world, case)[:3])


@pytest.mark.parametrize("case", ["mixtral-capacity-2x1",
                                  "mixtral-capacity-ep-2x1",
                                  "mixtral-overflow-ep-2x1",
                                  "mixtral-slots-4x1"])
def test_three_capacity_steps_match_jax(world, case):
    """Three AdamW steps of capacity dispatch with the rows cut, against
    the reference's three one-device steps: the backward of the cut
    capacity path and the moments of the expert blocks are held past the
    step where the weights still equal the start."""
    _hold(case, *_run(world, case, steps=3)[:3])


@pytest.mark.parametrize("case", ["mixtral-capacity-2x1",
                                  "mixtral-capacity-ep-2x1"])
def test_capacity_experts_on_each_rank(world, case):
    """Each rank runs the grouped pair and down product (its E / dp
    experts of the capacity buffer); under ``moe_ep`` it holds only its
    experts' panels, else the ZeRO-3 blocks of all of them."""
    _, _, _, ranks = _run(world, case)
    e = get_config(MIXTRAL).num_experts
    for r in ranks[:2]:
        shape = r["shapes"]["layers.0.moe.w_gate"]
        assert shape[0] == (e // 2 if "ep" in case else e)
    assert ranks[2] is None and ranks[3] is None


@pytest.mark.parametrize("cf", [1.25, 0.5, 0.25])
def test_capacity_slots_keep_the_one_device_copies(world, cf):
    """The kept / dropped copies and their buffer rows on a (2, 1) mesh,
    each rank with its rows, are the one-device run's, copy for copy."""
    e, k, t = 8, 2, 64
    rng = np.random.default_rng(int(cf * 100))
    gate_idx = np.stack([rng.choice(e, size=k, replace=False)
                         for _ in range(t)]).astype(np.int64)
    cap = tmoe.capacity(t, e, k, cf)
    slot, keep = tmoe.capacity_slots(torch.from_numpy(gate_idx), e, cap)
    ranks = world.run("capacity_keep", gate_idx, e, cap, (2, 1))
    got_keep = np.concatenate([ranks[0]["keep"], ranks[1]["keep"]])
    got_slot = np.concatenate([ranks[0]["slot"], ranks[1]["slot"]])
    np.testing.assert_array_equal(got_keep, keep.numpy())
    np.testing.assert_array_equal(got_slot, slot.numpy())
    if cf < 1.0:
        assert (~keep).sum() > 0        # the capacity overflows


def test_zero1_ranks_hold_only_their_moment_blocks(world):
    """ZeRO-1: every parameter block is the TP-only one (whole here, the
    model axis being 1), every moment block the ZeRO-3 one: cut over data
    where the parameter spec divides."""
    _, _, _, ranks = _run(world, "qwen-zero1-2x1")
    r = ranks[0]
    cut = 0
    for name, shape in r["moment_shapes"].items():
        p_shape = r["shapes"][name]
        assert len(shape) == len(p_shape)
        if shape != p_shape:
            cut += 1
            assert sum(a * 2 == b for a, b in zip(shape, p_shape)) == 1
    assert cut > 0
    assert ranks[1]["moment_shapes"] == r["moment_shapes"]


@pytest.mark.parametrize("resume", ["zero1-2x1", "zero3-1x2"])
def test_zero1_checkpoint_roundtrip(world, tmp_path, resume):
    """``Trainer(shardings={"params": ZeRO-1, "opt": ZeRO-3})`` on (2, 1)
    writes a whole checkpoint of the reference's layout; the same layout,
    and the default ZeRO-3 on (1, 2), resume it with the next step's loss
    and gradient norm of the uninterrupted run."""
    d = str(tmp_path / "ck")
    full = world.run("mesh_trainer", QWEN, (2, 1), 3, None, zero1=True)[0]
    world.run("mesh_trainer", QWEN, (2, 1), 2, d, ckpt_every=1, zero1=True)
    shape = (2, 1) if resume.startswith("zero1") else (1, 2)
    resumed = world.run("mesh_trainer", QWEN, shape, 3, d, ckpt_every=1,
                        zero1=resume.startswith("zero1"))[0]
    assert [m["step"] for m in resumed] == [2]
    for key in ("loss", "grad_norm"):
        assert resumed[0][key] == pytest.approx(full[2][key], rel=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flag", [True, False])
def test_rms_norm_under_rms_bf16_matches_jax(dtype, flag):
    """``rms_norm`` under ``DistContext(rms_bf16=flag)`` on a one-rank mesh
    of each package against the reference's: within 1e-6 relative in fp32
    and one bf16 ulp in bf16; with the flag off it is the fp32 form."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 64)) * 3.0).astype(np.float32)
    scale = (rng.standard_normal(64) * 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jmesh = jmake_mesh((1, 1), ("data", "model"))
    with jdist.use_dist(jdist.DistContext(jmesh, rms_bf16=flag)):
        want = np.asarray(jlayers.rms_norm(jnp.asarray(x, jdt),
                                           jnp.asarray(scale)).astype(
                                               jnp.float32))
    tm = tmesh.Mesh.abstract((1, 1), ("data", "model"))
    with tdist.use_dist(tdist.DistContext(tm, rms_bf16=flag)):
        got = tlayers.rms_norm(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(scale))
    assert got.dtype == tdt
    got = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        ulp = np.abs(want) * 2.0 ** -7
        assert (np.abs(got - want) <= np.maximum(ulp, 1e-30)).all()
    if not flag:
        plain = tlayers.rms_norm(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(scale))
        np.testing.assert_array_equal(plain.to(torch.float32).numpy(), got)


def test_rms_bf16_changes_bf16_numerics():
    """The flag is read: in bf16 the input-dtype form differs from the fp32
    form on the same inputs (it is not a layout hint)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((4, 256)) * 5).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    tm = tmesh.Mesh.abstract((1, 1), ("data", "model"))
    off = tlayers.rms_norm(x, scale)
    with tdist.use_dist(tdist.DistContext(tm, rms_bf16=True)):
        on = tlayers.rms_norm(x, scale)
    assert not torch.equal(on, off)


def test_opt_specs_must_refine_the_parameter_specs():
    """A moment spec that drops a cut of its parameter is refused."""
    assert sharding.refine_spec((None, "model"), ("data", "model")) == (
        "data", None)
    assert sharding.refine_spec(("data", None), ("data", None)) == (
        None, None)
    with pytest.raises(ValueError, match="does not refine"):
        sharding.refine_spec(("data", "model"), (None, "model"))
