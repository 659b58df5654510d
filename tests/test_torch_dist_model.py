"""The port's sharding rules, flash-decode, the expert-parallel MoE layer
and the model path on a mesh, held against the JAX package on the CPU.

  * ``expert_axis``, ``param_specs`` (``zero_stage`` 0 / 3, ``moe_ep`` on
    "dp" and on "model"), ``batch_specs`` and ``cache_specs`` equal the
    reference's, entry for entry, for every arch's smoke config, the
    reference computed in-process on a ``jax.sharding.AbstractMesh`` over
    ``jax.eval_shape`` trees;
  * ``flash_decode`` on 2 ranks, each holding half the cache rows, against
    the single-device decode attention and JAX's ``decode_attention``;
  * ``moe_mlp`` (ragged) under expert parallelism: output and gradients
    equal the single-device path's (reference ``tests/test_ep_gemm.py``);
  * ``llama4-scout-17b-a16e-smoke`` (4 experts) served on a (data 1,
    model 2) mesh -- experts cut over "model", the KV cache's sequence cut
    over "model", flash-decode -- through ``prefill`` and 4 scalar-position
    ``decode_step`` s: logits within 1e-5 (fp32) of the JAX model's
    single-device calls on the same bridged weights;
  * one comparison with the reference's own executors (``-m slow``): JAX's
    ``ep_ragged_moe`` and ``flash_decode`` on a fake 2-device mesh in a
    subprocess, against the port's 2-rank results.

The ranks are a gloo world of CPU processes (``torch_world``), started
once for this module; every call has a timeout.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core.dist import DistContext, use_dist  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from torch_world import World  # noqa: E402

CPU = torch.device("cpu")
LLAMA4 = "llama4-scout-17b-a16e-smoke"
MESHES = [((1, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(2, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _specs(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# The sharding rules against the reference's
# ---------------------------------------------------------------------------

SPEC_CASES = [(arch, i) for arch in list_archs() for i in range(len(MESHES))]


@pytest.mark.parametrize("arch,mesh_i", SPEC_CASES,
                         ids=[f"{a}-{'x'.join(map(str, MESHES[i][0]))}"
                              for a, i in SPEC_CASES])
def test_specs_match_reference(arch, mesh_i):
    shape, axes = MESHES[mesh_i]
    jmesh, tmesh = AbstractMesh(shape, axes), Mesh.abstract(shape, axes)
    jcfg = jget_config(arch + "-smoke")
    tcfg = get_config(arch + "-smoke")
    params = jax.eval_shape(lambda k: jmodel.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    variants = [dict(zero_stage=3), dict(zero_stage=0),
                dict(moe_ep=True, moe_ep_axis="dp"),
                dict(moe_ep=True, moe_ep_axis="model")]
    for kw in variants:
        assert sharding.param_specs(params, tmesh, **kw) == _specs(
            jsharding.param_specs(params, jmesh, **kw)), kw
    cache = jax.eval_shape(lambda: jmodel.make_cache(jcfg, 8, 32))
    assert sharding.cache_specs(tcfg, cache, tmesh) == _specs(
        jsharding.cache_specs(jcfg, cache, jmesh))
    batch = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32),
             "labels": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
    assert sharding.batch_specs(tcfg, batch, tmesh) == _specs(
        jsharding.batch_specs(jcfg, batch, jmesh))
    for ep_ax in ("dp", "model", "data", "nope"):
        for e in (None, tcfg.num_experts or 4, 3, 16):
            assert sharding.expert_axis(tmesh, True, ep_ax, e) == \
                jsharding.expert_axis(jmesh, True, ep_ax, e), (ep_ax, e)
        assert sharding.expert_axis(tmesh, False, ep_ax, 4) is None


def test_shard_tensor_and_serving_state():
    mesh = Mesh.abstract((1, 2), ("data", "model"))
    mesh.coords["model"] = 1
    full = torch.arange(24.0).reshape(4, 6)
    np.testing.assert_array_equal(
        sharding.shard_tensor(full, ("model", None), mesh).numpy(),
        full[2:].numpy())
    np.testing.assert_array_equal(
        sharding.shard_tensor(full, (None, "model"), mesh).numpy(),
        full[:, 3:].numpy())
    with pytest.raises(ValueError, match="divide"):
        sharding.shard_tensor(torch.zeros(3, 2), ("model", None), mesh)
    cfg = get_config(LLAMA4)
    ctx = DistContext(mesh, moe_ep_axis=sharding.expert_axis(
        mesh, True, "model", cfg.num_experts))
    whole = tmodel.init_params(cfg, 0, device=CPU)
    cut = tmodel.init_params(cfg, 0, device=CPU, dist=ctx)
    for a, b in zip(whole.layers, cut.layers):
        for name in ("w_gate", "w_up", "w_down"):
            assert torch.equal(getattr(a.moe, name)[2:],
                               getattr(b.moe, name))
        assert torch.equal(a.attn.wq, b.attn.wq)
    assert torch.equal(whole.embed, cut.embed)
    sharding.serving_state(whole, ctx)
    assert whole.layers[0].moe.w_up.shape[0] == 2


def test_make_cache_cuts_the_sequence_under_sp_decode():
    cfg = get_config(LLAMA4)
    mesh = Mesh.abstract((1, 2), ("data", "model"))
    with use_dist(DistContext(mesh, sp_decode=True)):
        assert tmodel.make_cache(cfg, 2, 80, device=CPU)["k"].shape[2] == 40
        with pytest.raises(ValueError, match="divide"):
            tmodel.make_cache(cfg, 2, 81, device=CPU)
    with use_dist(DistContext(mesh, sp_decode=False)):
        assert tmodel.make_cache(cfg, 2, 80, device=CPU)["k"].shape[2] == 80
    assert tmodel.make_cache(cfg, 2, 80, device=CPU)["k"].shape[2] == 80


# ---------------------------------------------------------------------------
# flash-decode, the EP MoE layer and the model path on 2 ranks
# ---------------------------------------------------------------------------

FD_CASES = [(5, 0), (30, 0), (17, 8), (31, -16), (0, 0)]


@pytest.mark.parametrize("pos,window", FD_CASES,
                         ids=[f"pos{p}-w{w}" for p, w in FD_CASES])
def test_flash_decode_matches_single_device_and_jax(world, pos, window):
    """Each rank holds 16 of the 32 cache rows; positions in one half, the
    other, and across; a sliding and a chunked window."""
    rng = np.random.default_rng(pos + 100)
    b, s, kvh, g, d = 2, 32, 2, 2, 16
    q = rng.standard_normal((b, 1, kvh * g, d)).astype(np.float32)
    ck = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    cv = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    want = np.asarray(jattention.decode_attention(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        q_pos=jnp.full((b,), pos, jnp.int32), window=window))
    for r in world.run("flash_decode", q, ck, cv, pos, window):
        _close(r["got"], r["want"])
        _close(r["got"], want)


def test_moe_ep_matches_single_device_forward_and_gradients(world):
    """``moe_mlp``'s ragged dispatch routes through ``ep_ragged_moe`` under
    a DistContext with an expert axis and agrees with the single-device
    path: output, dX, the router's gradient and each rank's expert dW."""
    rng = np.random.default_rng(4)
    d, f, e, t = 32, 64, 4, 24
    x = (rng.standard_normal((t, d)) * 0.5).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.3).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, d, f)) * d ** -0.5).astype(np.float32)
              for _ in range(2))
    wd = (rng.standard_normal((e, f, d)) * f ** -0.5).astype(np.float32)
    ct = rng.standard_normal((t, d)).astype(np.float32)
    out = world.run("moe_grads", x, router, wg, wu, wd, 2, ct)
    for s, r in enumerate(out):
        ep, one = r["ep"], r["one"]
        for key in ("y", "dx", "router"):
            _close(ep[key], one[key])
        for got, want in zip(ep["w"], one["w"]):
            _close(got, want[s * e // 2:(s + 1) * e // 2])


@functools.lru_cache(maxsize=None)
def _llama4():
    jcfg = dataclasses.replace(jget_config(LLAMA4), compute_dtype="float32")
    params = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, params


def test_llama4_smoke_on_two_ranks_matches_jax(world):
    """Prefill of 4 x 10 tokens and 4 scalar-position decode steps over a
    24-row cache (12 a rank), fed the JAX model's greedy tokens: logits
    within 1e-5 and the same greedy tokens; each rank holds 2 of the 4
    experts."""
    jcfg, params = _llama4()
    prompt = np.random.default_rng(3).integers(2, 512, (4, 10)).astype(
        np.int32)
    jl, jc = jax.jit(functools.partial(jmodel.prefill, cfg=jcfg))(
        params, batch={"tokens": jnp.asarray(prompt)},
        cache=jmodel.make_cache(jcfg, 4, 24))
    want = [np.asarray(jl)]
    steps = []
    jdec = jax.jit(functools.partial(jmodel.decode_step, cfg=jcfg))
    for i in range(4):
        nxt = np.asarray(jl.argmax(-1), np.int32)[:, None]
        steps.append(nxt)
        jl, jc = jdec(params, tokens=jnp.asarray(nxt), cache=jc,
                      pos=jnp.int32(10 + i))
        want.append(np.asarray(jl))
    tree = jax.tree.map(np.asarray, params)
    out = world.run("model_path", LLAMA4, tree, prompt,
                    np.concatenate(steps, axis=1), 24)
    for r in out:
        assert r["cache_rows"] == 12 and r["experts"] == 2
        for got, w in zip(r["logits"], want):
            _close(got, w)
            assert (got.argmax(-1) == w.argmax(-1)).all()


@pytest.mark.slow
def test_reference_executors_agree_with_the_port(world, tmp_path):
    """JAX's own ``ep_ragged_moe`` and ``flash_decode`` on a fake 2-device
    mesh (a subprocess), against the port's 2-rank executors on the same
    numpy inputs."""
    from helpers import run_with_devices
    rng = np.random.default_rng(8)
    d, f, g = 16, 24, 4
    sizes = [9, 0, 4, 6]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    x = rng.standard_normal((19, d)).astype(np.float32)
    wg, wu = (rng.standard_normal((g, d, f)).astype(np.float32) * 0.25
              for _ in range(2))
    wd = rng.standard_normal((g, f, d)).astype(np.float32) * 0.2
    b, s, kvh, gq, hd = 2, 32, 2, 2, 16
    q = rng.standard_normal((b, 1, kvh * gq, hd)).astype(np.float32)
    ck = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    cv = rng.standard_normal((b, s, kvh, hd)).astype(np.float32)
    inputs = tmp_path / "in.npz"
    np.savez(inputs, x=x, wg=wg, wu=wu, wd=wd, offs=offs, q=q, ck=ck, cv=cv)
    outputs = tmp_path / "out.npz"
    code = f"""
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.core.dist import DistContext
from repro.core.gemm import ep_ragged_moe
from repro.models.attention import flash_decode
z = np.load({str(inputs)!r})
mesh = make_mesh((2,), ("x",))
ring = ep_ragged_moe(jnp.asarray(z["x"]), jnp.asarray(z["wg"]),
                     jnp.asarray(z["wu"]), jnp.asarray(z["wd"]),
                     jnp.asarray(z["offs"]), mesh=mesh, axis="x",
                     schedule="ring")
gath = ep_ragged_moe(jnp.asarray(z["x"]), jnp.asarray(z["wg"]),
                     jnp.asarray(z["wu"]), jnp.asarray(z["wd"]),
                     jnp.asarray(z["offs"]), mesh=mesh, axis="x",
                     schedule="gather")
m2 = make_mesh((1, 2), ("data", "model"))
fd = flash_decode(jnp.asarray(z["q"]), jnp.asarray(z["ck"]),
                  jnp.asarray(z["cv"]), pos=jnp.int32(20), window=0,
                  dist=DistContext(mesh=m2))
np.savez({str(outputs)!r}, ring=np.asarray(ring), gath=np.asarray(gath),
         fd=np.asarray(fd))
print("ok")
"""
    assert "ok" in run_with_devices(code, n_devices=2, timeout=300)
    ref = np.load(outputs)
    for sched in ("ring", "gather"):
        got = world.run("ep", "moe", x, [wg, wu, wd], offs, schedule=sched)
        for r in got:
            _close(r["y"], ref["ring" if sched == "ring" else "gath"])
    for r in world.run("flash_decode", q, ck, cv, 20, 0):
        _close(r["got"], ref["fd"])
