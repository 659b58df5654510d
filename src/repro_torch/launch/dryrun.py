"""Production-mesh dry run: one step of every (arch x shape x mesh x
variant) cell, on an abstract 16 x 16 (or 2 x 16 x 16) mesh, with nothing
allocated on any device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
        --shape train_4k [--multi-pod] [--variant baseline] [--all] \
        [--skip-existing]

Results land in ``results/torch_dryrun/<arch>__<shape>__<mesh>__<variant>
.json``; the last line printed is ``done: N ok, N skipped, N failed``.

The reference lowers and compiles the step on 256 / 512 placeholder
devices and reads memory, cost and the collective schedule from the
compiled program.  The port has no compiler to ask: it runs **rank 0's own
step eagerly on the ``meta`` device** -- per-rank shapes, no storage, no
process group -- over ``launch.mesh.make_production_mesh``, an abstract
mesh on which every collective records itself and returns the shape it
would (``core.gemm.collective``: the other ranks are rank 0's twins).  The
state is rank 0's blocks under the port's sharding rules
(``abstract_state``; ``launch.sharding``), the step the one the trainer or
the server runs (``train.make_train_step`` / ``make_prefill_step`` /
``make_serve_step``) under ``DistContext(sharded_params=True)``.  On a
mesh small enough to run for real, the same step records the same
collectives (``chip_smoke.py`` [dryrun] holds them equal on the card).

What a cell reports:

  * ``memory``: ``argument_size``, the exact bytes of rank 0's arguments
    (parameter blocks, AdamW moments and step, the batch's rows, the cache
    blocks and the int32 ``pos`` of a decode step, as the reference's);
    ``output_size``, the bytes the step returns, the state it updates in
    place included (the reference's donated outputs); ``temp_size``, the
    most bytes of storage the step's own operations held at once
    (``MetaStep``, a dispatch mode that adds each new storage's bytes and
    drops them when it is freed); ``peak_memory`` = argument + temp, the
    reference's definition.  The kernels' plain versions run on ``meta``
    (``kernels.ftimm.kernel``): their fp32 operand copies count as
    temporaries, so ``temp_size`` bounds the kernels' from above;
  * ``perf_breakdown``: the analytic perf model's buckets
    (``roofline.step_perf``, the expert exchange priced off the axis the
    ``DistContext`` routes through, as the reference);
  * ``roofline``: the three terms (``roofline.analysis``): FLOPs and bytes
    from the perf model, the collective term from rank 0's recorded
    collectives, ``raw_cost["flops"]`` counted by ``FlopCounterMode``;
  * ``step_host_s``: the host seconds of the abstract step (the
    reference's ``compile_s`` has no counterpart).

Host reads the dry-run path avoids (``meta`` has no value to read):

  * the ragged all-to-all's split sizes (``collective.exchange_splits``,
    one read a call): an abstract mesh takes the dense exchange;
  * the EP ladder's agreed fault flag (``collective.agree_max``, one
    read a call): on an abstract mesh every rank is rank 0's twin, so
    its own flag is the agreement;
  * the decode position: a Python int here (the last cache row), where
    the reference passes a traced int32 scalar; its 4 bytes are counted;
  * the metrics the trainer reads after a step (loss, gradient norm) stay
    device tensors: the step never reads them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, applicable, get_config, list_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..core.dist import DistContext, use_dist
from ..core.gemm import collective
from ..models.model import init_params, make_cache
from ..models.transformer import init_cache
from ..optim.adamw import OptConfig, init_opt_state
from ..roofline.analysis import (build_roofline, collective_bytes,
                                 model_flops_estimate)
from ..roofline.perf_model import step_perf
from ..train.train_step import (make_prefill_step, make_serve_step,
                                make_train_step)
from .mesh import Mesh, make_production_mesh
from .sharding import (axis_size, batch_specs, block_shape, cache_specs,
                       dp_axes, expert_axis, named_specs, shard_opt_state,
                       shard_params)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "torch_dryrun"
META = torch.device("meta")

# The reference's hill-climb variants, knob for knob.
#   zero_stage: 3 = params + opt 2-D sharded (baseline); 1 = params TP-only
#               + opt still dp-sharded (ZeRO-1); 0 also for serve layouts.
VARIANTS: dict[str, dict] = {
    "baseline": {},
    "zero1": {"zero_stage": 1},
    "ep_moe": {"moe_ep": True},
    "zero1_ep": {"zero_stage": 1, "moe_ep": True},
    "zero1_ep_buf": {"zero_stage": 1, "moe_ep": True, "moe_buf_shard": True},
    "serve_tp": {"zero_stage": 0},
    "ssm_shard": {"ssm_head_shard": True},
    "zero1_ssm": {"zero_stage": 1, "ssm_head_shard": True},
    "rms_bf16": {"rms_bf16": True},
    "zero1_rms": {"zero_stage": 1, "rms_bf16": True},
    "moe_buf": {"moe_buf_shard": True},
    "sp_v2": {"rms_bf16": True, "sp_inputs": True},
    "sp_v2_zero1": {"rms_bf16": True, "sp_inputs": True, "zero_stage": 1},
    "best_moe": {"rms_bf16": True, "sp_inputs": True, "moe_ep": True,
                 "moe_buf_shard": True},
    "serve_tp_best": {"zero_stage": 0, "rms_bf16": True},
    # mesh re-balance: same 256 chips, trade TP degree for DP
    "mesh32x8": {"mesh": (32, 8)},
    "mesh64x4": {"mesh": (64, 4)},
    "mesh32x8_zero1": {"mesh": (32, 8), "zero_stage": 1},
    "mesh64x4_zero1": {"mesh": (64, 4), "zero_stage": 1},
    "mesh32x8_ep": {"mesh": (32, 8), "moe_ep": True},
    "mesh64x4_dots": {"mesh": (64, 4), "cfg": {"remat": "dots"}},
    "serve_bf16": {"zero_stage": 0, "cfg": {"param_dtype": "bfloat16"}},
    "mesh64x4_ep": {"mesh": (64, 4), "moe_ep": True},
    "l4_ep_model": {"mesh": (32, 8), "moe_ep": True, "moe_ep_axis": "model"},
    "l4_ep_model_bf16p": {"mesh": (32, 8), "moe_ep": True,
                          "moe_ep_axis": "model",
                          "cfg": {"param_dtype": "bfloat16"}},
}


def _broadcast(shapes) -> tuple:
    """``torch.broadcast_shapes`` of a few short tuples (raises alike)."""
    nd = max(len(sh) for sh in shapes)
    out = [1] * nd
    for sh in shapes:
        for i, n in enumerate(sh, nd - len(sh)):
            if n != 1:
                if out[i] not in (1, n):
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = n
    return tuple(out)


class MetaStep(TorchDispatchMode):
    """The dispatch mode an abstract step runs under.

    It tracks the bytes of the storages the operations inside the block
    allocate: ``live`` now, ``peak`` the most at once.  A storage counts
    from the operation that made it until it is freed; the storages of
    ``known`` tensors (the step's arguments) and of views of them never
    count.

    And it short-cuts the out-of-place pointwise operations on ``meta``
    tensors, whose ``meta`` kernels are Python references (most of an
    abstract step's host time): the result is an empty ``meta`` tensor of
    the broadcast shape, in the dtype the CPU kernel gives one-element
    stand-ins of the same dtypes (and dimensionality, which type promotion
    reads), memoized per (op, argument types).  Every other operation runs
    as it is."""

    _pointwise: dict = {}
    _dtypes: dict = {}

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        # The storages seen, by their address while they live (a freed
        # storage leaves, so a new one at its address counts anew).
        self._seen: set = set()
        self._known = [t.untyped_storage() for t in known]
        self._seen.update(st._cdata for st in self._known)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._pointwise_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self._track(out)
        else:
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self._track(t)
        return out

    def _pointwise_meta(self, func, args, kwargs):
        """The short-cut result of ``func``, or None where it does not
        apply."""
        pw = self._pointwise.get(func)
        if pw is None:
            pw = self._pointwise[func] = (torch.Tag.pointwise in func.tags
                                          and not func._schema.is_mutable)
        if not pw or "out" in kwargs:
            return None
        shapes, key = [], [func]
        for a in (*args, *kwargs.values()):
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta":
                    return None
                shapes.append(tuple(a.shape))
                key.append((a.dtype, a.ndim == 0))
            elif isinstance(a, (list, tuple)):
                return None
            else:
                key.append(type(a))
        if not shapes:
            return None
        key = (*key, *((k, v) for k, v in kwargs.items()
                       if not isinstance(v, torch.Tensor)))
        dtype = self._dtypes.get(key, False)
        if dtype is False:
            dtype = self._dtypes[key] = _twin_dtype(func, args, kwargs)
        if dtype is None:
            return None
        return torch.empty(_broadcast(shapes), dtype=dtype, device=META)


def _twin_dtype(func, args, kwargs):
    """The result dtype of ``func`` on CPU stand-ins, or None when its
    result is not one tensor."""
    def twin(a):
        if isinstance(a, torch.Tensor):
            return torch.zeros(() if a.ndim == 0 else (1,), dtype=a.dtype)
        return a
    try:    # outside every mode: the stand-ins are not the step's
        with _disable_current_modes():
            out = func(*tree_map(twin, args), **tree_map(twin, kwargs))
    except (RuntimeError, TypeError, NotImplementedError):
        return None     # the op's own path decides
    return out.dtype if isinstance(out, torch.Tensor) else None


def _unique_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors`` (a tree)."""
    seen, total = set(), 0
    for t in tree_leaves(tensors):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for every model input, the reference's batch
    dict (global shapes)."""
    b, s = shape.global_batch, shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind == "train":
        batch = {"tokens": sds((b, s), torch.int32),
                 "labels": sds((b, s), torch.int32),
                 "loss_mask": sds((b, s), torch.float32)}
    elif shape.kind == "prefill":
        batch = {"tokens": sds((b, s), torch.int32)}
    else:  # decode: one new token against a cache of seq_len
        batch = {"tokens": sds((b, 1), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = sds((b, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    if cfg.num_patches:
        batch["patch_embeds"] = sds((b, cfg.num_patches, cfg.d_model),
                                    torch.bfloat16)
    return batch


def abstract_state(cfg: ModelConfig, shape: ShapeConfig, with_opt: bool, *,
                   mesh: Mesh | None = None, zero_stage: int = 3,
                   moe_ep: bool = False, moe_ep_axis: str = "dp",
                   device: str | torch.device = META, seed: int = 0):
    """The model (parameters in ``cfg.param_dtype``, as the reference's
    ``jax.eval_shape(init_params)``) and, ``with_opt``, its AdamW state on
    ``meta``, nothing drawn; on a ``mesh`` cut to rank 0's blocks
    (``shard_params`` under ``param_specs`` at ``zero_stage``, the moments
    at ZeRO-3 as the reference's ``o_shard``).  -> (model, opt | None).
    On a real ``device`` the same state, drawn from ``seed`` and cut to
    this rank's blocks (the twin of a dry-run cell that runs)."""
    model = init_params(cfg, seed, device=device, dtype=cfg.param_dtype)
    if not with_opt:
        model.requires_grad_(False)
    full = dict(model.named_parameters())
    kw = dict(moe_ep=moe_ep, moe_ep_axis=moe_ep_axis)
    if mesh is not None:
        shard_params(model, named_specs(full, mesh, zero_stage=zero_stage,
                                        **kw), mesh)
    opt = None
    if with_opt:
        named = dict(model.named_parameters())
        opt = init_opt_state(named)
        if mesh is not None:
            shard_opt_state(opt, named, named_specs(full, mesh, zero_stage=3,
                                                    **kw), mesh)
    return model, opt


def _local_batch(cfg, shape, mesh, device, gen) -> tuple[dict, bool]:
    """This rank's rows of the batch under ``batch_specs`` (drawn tokens
    off ``meta``), and whether the data axes cut them (a batch they do not
    divide is whole everywhere)."""
    full = input_specs(cfg, shape)
    specs = batch_specs(cfg, full, mesh)
    local = {}
    for k, v in full.items():
        shp = block_shape(tuple(v.shape), specs[k], mesh)
        if device.type == "meta":
            local[k] = torch.empty(shp, dtype=v.dtype, device=META)
        elif v.dtype == torch.int32:
            local[k] = torch.randint(2, cfg.vocab_size, shp, generator=gen,
                                     dtype=torch.int32).to(device)
        else:
            local[k] = torch.ones(shp, dtype=v.dtype, device=device)
    return local, specs["tokens"][0] is not None


def _local_cache(cfg, shape, mesh, dist, rows: int, device) -> dict:
    """This rank's cache blocks as the model holds them (``make_cache``
    under ``dist``), checked against ``cache_specs`` of the whole cache."""
    with use_dist(dist):
        cache = make_cache(cfg, rows, shape.seq_len, device=device)
    whole = init_cache(cfg, shape.global_batch,
                       shape.seq_len + (cfg.num_patches or 0), META)
    specs = cache_specs(cfg, whole, mesh, head_shard=dist.ssm_head_shard)
    for k, t in cache.items():
        want = block_shape(tuple(whole[k].shape), specs[k], mesh)
        if tuple(t.shape) != want:
            raise AssertionError(f"cache {k}: the model holds "
                                 f"{tuple(t.shape)}, cache_specs says {want}")
    return cache


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run on one rank: the ``dist`` context,
    the ``step`` and its ``args``, the ``state`` (the arguments' tensors,
    as the reference counts them) and their exact ``argument_size``."""
    dist: DistContext
    step: object
    args: tuple
    state: list
    argument_size: int
    train: bool


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               variant: str = "baseline", *, seed: int = 0) -> Cell:
    """The step of (``cfg``, ``shape``, ``variant``) for this rank of
    ``mesh``, its state on ``mesh.device``: ``meta`` for the dry run (an
    abstract mesh), or a real device on a mesh that runs (its twin)."""
    knobs = dict(VARIANTS[variant])
    zero_stage = knobs.pop("zero_stage", 3)
    moe_ep = knobs.pop("moe_ep", False)
    moe_ep_axis = knobs.pop("moe_ep_axis", "dp")
    knobs.pop("mesh", None)
    knobs.pop("cfg", None)
    device = mesh.device
    gen = torch.Generator().manual_seed(seed + 1)
    batch, cut = _local_batch(cfg, shape, mesh, device, gen)
    dist = DistContext(mesh, dp_axes(mesh), "model",
                       moe_ep_axis=expert_axis(mesh, moe_ep, moe_ep_axis,
                                               cfg.num_experts or None),
                       sharded_params=True, batch_cut=cut, **knobs)
    train = shape.kind == "train"
    model, opt = abstract_state(cfg, shape, train, mesh=mesh,
                                zero_stage=zero_stage, moe_ep=moe_ep,
                                moe_ep_axis=moe_ep_axis, device=device,
                                seed=seed)
    params = list(model.parameters())
    if train:
        step = make_train_step(cfg, OptConfig())
        args = (model, opt, batch)
        state = [params, opt, batch]
    else:
        cache = _local_cache(cfg, shape, mesh, dist,
                             batch["tokens"].shape[0], device)
        if shape.kind == "prefill":
            step = make_prefill_step(cfg)
            args = (model, batch, cache)
            state = [params, batch, cache]
        else:   # the reference's serve_step reads the tokens alone
            pos = shape.seq_len + (cfg.num_patches or 0) - 1
            step = make_serve_step(cfg)
            args = (model, cache, batch["tokens"], pos)
            state = [params, cache, batch["tokens"]]
    arg_bytes = _unique_bytes(state) + (4 if shape.kind == "decode" else 0)
    return Cell(dist, step, args, state, arg_bytes, train)


def cell_name(arch: str, shape_name: str, multi_pod: bool,
              variant: str) -> str:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    return f"{arch}__{shape_name}__{mesh_name}__{variant}"


def run_cell(arch: str, shape_name, *, multi_pod: bool = False,
             variant: str = "baseline", save: bool = True,
             opt_overrides: dict | None = None, cfg: ModelConfig | None = None,
             mesh: Mesh | None = None, entries: list | None = None,
             count_flops: bool = True) -> dict:
    """One cell: rank 0's step on the abstract mesh, its memory, perf
    breakdown and roofline (the module docstring); saved under
    ``RESULTS`` when ``save``.  A cell ``configs.applicable`` rejects is
    "skipped" with its reason.  ``shape_name``: a ``SHAPES`` name or a
    ``ShapeConfig``; ``cfg`` / ``mesh``: a config and an abstract mesh to
    use instead of the arch's and the variant's (the twin of a smaller
    real run); ``entries``: a list that receives the recorded collectives;
    ``count_flops`` False leaves ``raw_cost`` empty (``FlopCounterMode``
    costs a third of the step's host time)."""
    knob_cfg = VARIANTS.get(variant, {}).get("cfg")
    if knob_cfg:
        opt_overrides = dict(opt_overrides or {}, **knob_cfg)
    cfg = cfg or get_config(arch)
    if opt_overrides:
        cfg = dataclasses.replace(cfg, **opt_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, reason = applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cellname = cell_name(arch, shape.name, multi_pod, variant)
    if not ok:
        result = {"cell": cellname, "status": "skipped", "reason": reason}
        if save:
            _save(cellname, result)
        return result
    if mesh is None:
        mesh_shape = VARIANTS[variant].get("mesh")
        mesh = (Mesh.abstract(tuple(mesh_shape), ("data", "model"),
                              device=META) if mesh_shape is not None
                else make_production_mesh(multi_pod=multi_pod))
    cell = build_cell(cfg, shape, mesh, variant)
    run = trace(lambda: cell.step(*cell.args), cell.state, cell.dist,
                count_flops=count_flops)
    out, rec = run["out"], run["entries"]
    if entries is not None:
        entries.extend(rec)

    arg_bytes = cell.argument_size
    mem_stats = {
        "argument_size": arg_bytes,
        "output_size": _unique_bytes([out[1:], cell.state[0]] if cell.train
                                     else out),
        "temp_size": run["temp_size"],
        "peak_memory": arg_bytes + run["temp_size"],
    }
    ep_shards = (axis_size(mesh, cell.dist.moe_ep_axis) if cfg.num_experts
                 else 1)
    perf = step_perf(cfg, shape, ep_shards=ep_shards)
    roof = build_roofline(
        arch=arch, shape=shape.name, mesh_name=mesh_name, chips=mesh.size,
        analytic_flops=perf.flops, analytic_bytes=perf.bytes_hbm,
        analytic_ici=perf.bytes_ici, coll=collective_bytes(rec),
        cost=None if run["flops"] is None else {"flops": run["flops"]},
        model_flops=model_flops_estimate(cfg, shape, shape.kind),
        memory_stats=mem_stats)
    result = {
        "cell": cellname, "status": "ok", "variant": variant,
        "device": "meta", "step_host_s": round(run["seconds"], 1),
        "memory": mem_stats,
        "perf_breakdown": {k: [round(x, 1) for x in v]
                           for k, v in perf.breakdown.items()},
        "roofline": roof.to_dict(),
    }
    if save:
        _save(cellname, result)
    return result


def trace(fn, state, dist: DistContext | None, *,
          count_flops: bool = True) -> dict:
    """Run ``fn()`` -- a step on ``meta`` tensors, over an abstract mesh --
    under ``dist``, recording its collectives, tracking the bytes its
    operations allocate beyond ``state`` (its arguments' tensors) and, with
    ``count_flops``, counting its FLOPs.  -> {"out", "entries",
    "temp_size", "flops" (None uncounted), "seconds" (host)}."""
    t0 = time.perf_counter()
    with use_dist(dist), collective.record() as rec, \
            (FlopCounterMode(display=False) if count_flops
             else contextlib.nullcontext()) as flops, \
            MetaStep(tree_leaves(state)) as live:
        out = fn()
    return {"out": out, "entries": list(rec), "temp_size": live.peak,
            "flops": float(flops.get_total_flops()) if count_flops else None,
            "seconds": time.perf_counter() - t0}


def _save(cellname: str, result: dict) -> None:
    RESULTS.mkdir(parents=True, exist_ok=True)
    with open(RESULTS / f"{cellname}.json", "w") as f:
        json.dump(result, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell for the given mesh")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all required")
    n = {"ok": 0, "skipped": 0, "failed": 0}
    for arch, shape in cells:
        cellname = cell_name(arch, shape, args.multi_pod, args.variant)
        path = RESULTS / f"{cellname}.json"
        if args.skip_existing and path.exists():
            prior = json.loads(path.read_text())
            if prior.get("status") in ("ok", "skipped"):
                print(f"[skip-existing] {cellname}")
                continue
        try:
            r = run_cell(arch, shape, multi_pod=args.multi_pod,
                         variant=args.variant)
        except Exception as e:  # noqa: BLE001 -- recorded per cell
            n["failed"] += 1
            _save(cellname, {"cell": cellname, "status": "failed",
                             "error": repr(e),
                             "trace": traceback.format_exc()[-4000:]})
            print(f"[FAIL] {cellname}: {e!r}")
            continue
        n[r["status"]] += 1
        if r["status"] == "ok":
            roof = r["roofline"]
            print(f"[ok {r['step_host_s']}s] {cellname} "
                  f"dominant={roof['dominant']} "
                  f"t_bound={roof['t_bound']:.3e}s "
                  f"mem/dev={r['memory']['peak_memory'] / 2**30:.2f}GiB")
        else:
            print(f"[skipped] {cellname}: {r['reason']}")
    print(f"done: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['failed']} failed")
    return 1 if n["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
