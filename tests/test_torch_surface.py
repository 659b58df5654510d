"""The port's public surface against the JAX package's, read from the
sources alone (``ast``; neither package is imported).

Every public top-level name of a module of ``src/repro/`` (its functions,
classes, assignments and ``__all__`` entries) and every public method or
field of its public classes must exist in the module of
``src/repro_torch/`` at the same relative path, or stand in one of the two
tables below: ``COUNTERPARTS`` names the port's counterpart as
``module:name`` (asserted to exist), ``NOT_NEEDED`` says in one line why
the port needs none.  A name the reference gains without either fails."""
import ast
import functools
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# Reference modules the port has no file for.
MODULES_NOT_NEEDED = {
    "core/compat.py": "wraps JAX APIs that moved between JAX versions; the "
                      "port calls PyTorch directly",
}

COUNTERPARTS = {
    # The Hopper card in place of the TPU.
    "core/gemm/cmr.py:TpuSpec": "core/gemm/cmr.py:HopperSpec",
    "core/gemm/cmr.py:TPU_V5E": "core/gemm/cmr.py:H100",
    "core/gemm/__init__.py:TpuSpec": "core/gemm/cmr.py:HopperSpec",
    "core/gemm/__init__.py:TPU_V5E": "core/gemm/cmr.py:H100",
    "core/gemm/cmr.py:PlanEstimate.vmem_bytes":
        "core/gemm/cmr.py:PlanEstimate.smem_bytes",
    "core/gemm/cmr.py:PlanEstimate.mxu_fraction":
        "core/gemm/cmr.py:PlanEstimate.occupancy",
    "core/gemm/cmr.py:EpEstimate.ici_bytes":
        "core/gemm/cmr.py:EpEstimate.link_bytes",
    "core/gemm/tuner.py:Placement.ici_bytes":
        "core/gemm/tuner.py:Placement.link_bytes",
    # The plan hierarchy: one dataclass per family, no common base.
    "core/gemm/tuner.py:Plan": "core/gemm/tuner.py:GemmPlan",
    "core/gemm/tuner.py:Plan.est": "core/gemm/tuner.py:GemmPlan.est",
    "core/gemm/tuner.py:Plan.mode": "core/gemm/tuner.py:GemmPlan.mode",
    "core/gemm/tuner.py:Plan.placement":
        "core/gemm/tuner.py:GemmPlan.placement",
    "core/gemm/tuner.py:Plan.strategy":
        "core/gemm/tuner.py:GemmPlan.strategy",
    "core/gemm/tuner.py:Plan.t_total": "core/gemm/tuner.py:GemmPlan.t_total",
    "core/gemm/__init__.py:Plan": "core/gemm/tuner.py:GemmPlan",
    # The static contracts, restated for the CUDA kernels.
    "analysis/contracts.py:vmem_footprint":
        "analysis/contracts.py:smem_footprint",
    "analysis/__init__.py:vmem_footprint":
        "analysis/contracts.py:smem_footprint",
    "analysis/contracts.py:masked_operand_count":
        "analysis/contracts.py:masked_operands",
    "analysis/__init__.py:masked_operand_count":
        "analysis/contracts.py:masked_operands",
    # One writer per ragged row replaces the sorted visit list.
    "analysis/contracts.py:check_ragged_visits":
        "analysis/contracts.py:check_ragged_rows",
    "analysis/contracts.py:check_ragged_visit_plan":
        "analysis/contracts.py:check_ragged_rows",
    "analysis/__init__.py:check_ragged_visits":
        "analysis/contracts.py:check_ragged_rows",
    "analysis/__init__.py:check_ragged_visit_plan":
        "analysis/contracts.py:check_ragged_rows",
    "analysis/__init__.py:check_placement":
        "analysis/contracts.py:check_placement",
    # The kernels: the batched kernel is the grouped one, and the
    # package's kernels live in its kernel module.
    "kernels/ftimm/kernel.py:ftimm_gemm_batched":
        "kernels/ftimm/kernel.py:ftimm_gemm_grouped",
    "kernels/ftimm/__init__.py:ftimm_gemm_batched":
        "kernels/ftimm/kernel.py:ftimm_gemm_grouped",
    "kernels/ftimm/__init__.py:ftimm_gemm":
        "kernels/ftimm/kernel.py:ftimm_gemm",
    "kernels/ftimm/__init__.py:ftimm_gemm_grouped":
        "kernels/ftimm/kernel.py:ftimm_gemm_grouped",
    "kernels/ftimm/__init__.py:ftimm_gemm_grouped_swiglu":
        "kernels/ftimm/kernel.py:ftimm_gemm_grouped_swiglu",
    "kernels/ftimm/__init__.py:ftimm_gemm_ragged":
        "kernels/ftimm/kernel.py:ftimm_gemm_ragged",
    "kernels/ftimm/__init__.py:ftimm_gemm_ragged_dw":
        "kernels/ftimm/kernel.py:ftimm_gemm_ragged_dw",
    "kernels/ftimm/__init__.py:ftimm_gemm_ragged_swiglu":
        "kernels/ftimm/kernel.py:ftimm_gemm_ragged_swiglu",
    "kernels/ftimm/__init__.py:ftimm_gemm_splitk":
        "kernels/ftimm/kernel.py:ftimm_gemm_splitk",
    "kernels/ftimm/__init__.py:ftimm_gemm_swiglu":
        "kernels/ftimm/kernel.py:ftimm_gemm_swiglu",
    "kernels/ftimm/__init__.py:batched_gemm_swiglu":
        "kernels/ftimm/ops.py:batched_gemm_swiglu",
    "kernels/ftimm/__init__.py:ragged_gemm": "kernels/ftimm/ops.py:ragged_gemm",
    "kernels/ftimm/__init__.py:ragged_gemm_dw":
        "kernels/ftimm/ops.py:ragged_gemm_dw",
    "kernels/ftimm/__init__.py:ragged_gemm_swiglu":
        "kernels/ftimm/ops.py:ragged_gemm_swiglu",
    # The EP exchange: one all_to_all_single with split sizes.
    "core/gemm/collective.py:primitive_dispatch":
        "core/gemm/collective.py:raw_all_to_all",
    "core/gemm/collective.py:primitive_combine":
        "core/gemm/collective.py:raw_all_to_all",
    # Models and data.
    "models/transformer.py:layer_windows": "configs/base.py:ModelConfig.windows",
    "models/transformer.py:init_lm_params": "models/model.py:init_params",
    "serve/__init__.py:flash_decode": "models/attention.py:flash_decode",
}

NOT_NEEDED = {
    "core/dist.py:shard_act": "eager PyTorch has no layout constraint: the "
                              "executors carry the layout",
    "core/gemm/dispatch.py:clear_dispatch_caches":
        "clears jit caches; the port's dispatch is eager and keeps none",
    "core/gemm/distributed.py:clear_executor_caches":
        "clears jit caches; the port's executors are eager and keep none",
    "core/gemm/autotune.py:default_engine":
        "picks among JAX's pallas / interpret / xla engines; the port has "
        "one, the CUDA kernel (the plain version on the CPU)",
    "core/gemm/tuner.py:PlacementOption.cached_local":
        "a jit-keyed memo; the port's planners are lru-cached per signature",
    "core/gemm/tuner.py:GemmPlan.edge":
        "the TPU's pad-or-mask choice; the CUDA kernels always mask edges",
    "core/gemm/tuner.py:MoeDispatchPlan.est":
        "the TPU's tiling of the dispatch rows; the port prices the rows "
        "with the expert GEMMs' own planners",
    "core/gemm/tuner.py:MoeDispatchPlan.mode":
        "only the measured TPU tiling has a mode; the port's plan is rows "
        "and placement",
    "analysis/contracts.py:block_aligned":
        "the TPU's (8, 128) pad / zero-copy rule; the CUDA kernels mask "
        "edges",
    "analysis/__init__.py:block_aligned":
        "the TPU's (8, 128) pad / zero-copy rule; the CUDA kernels mask "
        "edges",
    "analysis/contracts.py:KernelContract.store_dims":
        "Pallas BlockSpec index maps; the CUDA contract is the launch grid "
        "(kernel.launch_grid)",
    "analysis/contracts.py:KernelContract.reduction_dims":
        "Pallas grid axes; the CUDA kernels reduce inside one CTA",
    "analysis/contracts.py:KernelContract.ordered_rmw":
        "the sorted ragged visit list's read-modify-write; one writer per "
        "ragged row has none",
    "analysis/contracts.py:KernelContract.needs_k_mask":
        "the K masks are checked in the CUDA sources "
        "(check_contraction_masking)",
    "kernels/ftimm/kernel.py:DimOrder":
        "the Pallas grid's index maps; the CUDA grid order is the "
        "dim_order string",
    "kernels/ftimm/ops.py:sublane":
        "the TPU's dtype-aware sublane padding; the CUDA kernels mask edges",
    "kernels/ftimm/__init__.py:sublane":
        "the TPU's dtype-aware sublane padding; the CUDA kernels mask edges",
    "core/gemm/collective.py:combine_rows":
        "the dense-window fallback's combine; all_to_all_single returns the "
        "rows in place",
    "core/gemm/collective.py:dispatch_payload":
        "the dense-window fallback's payload; all_to_all_single takes split "
        "sizes",
    "core/gemm/collective.py:window_from_payload":
        "the dense-window fallback's unpacking; all_to_all_single takes "
        "split sizes",
    "launch/sharding.py:to_shardings":
        "builds jax NamedShardings; the port's specs are applied by "
        "shard_params and the executors",
    "models/layers.py:he_init": "a JAX initializer; the port draws weights "
                                "in its init_*_block functions",
    "models/layers.py:zeros_init": "a JAX initializer; the port draws "
                                   "weights in its init_*_block functions",
    "data/pipeline.py:SyntheticLM.make_global_batch":
        "assembles a jax.Array across hosts; a port rank takes its rows "
        "from the batch itself",
    "serve/kv_pages.py:PagedKV.update":
        "the functional (donated) page write of jit; the port writes the "
        "pages in place",
}


def _targets(node) -> list[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [n for e in node.elts for n in _targets(e)]
    return []


def _statements(body):
    """Top-level statements, looking inside if / try / with blocks."""
    for node in body:
        if isinstance(node, ast.Try):
            blocks = [node.body, node.orelse, node.finalbody,
                      *(h.body for h in node.handlers)]
        elif isinstance(node, ast.If):
            blocks = [node.body, node.orelse]
        elif isinstance(node, ast.With):
            blocks = [node.body]
        else:
            yield node
            continue
        for block in blocks:
            yield from _statements(block)


def _members(cls: ast.ClassDef) -> set[str]:
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.AnnAssign):
            out.update(_targets(node.target))
        elif isinstance(node, ast.Assign):
            out.update(n for t in node.targets for n in _targets(t))
    return {f"{cls.name}.{m}" for m in out if not m.startswith("_")}


def surface(source: str, *, imports: bool = False) -> set[str]:
    """The public names a module's source defines: functions, classes and
    their public members ("Class.member"), assignments, ``__all__``
    entries; with ``imports`` the names it imports too."""
    out = set()
    for node in _statements(ast.parse(source).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            if not node.name.startswith("_"):
                out |= _members(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names = [n for t in targets for n in _targets(t)]
            out.update(names)
            if "__all__" in names and isinstance(node.value,
                                                 (ast.List, ast.Tuple)):
                out.update(e.value for e in node.value.elts
                           if isinstance(e, ast.Constant))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not n.startswith("_")}


@functools.lru_cache(maxsize=None)
def _port_surface(rel: str) -> frozenset[str]:
    path = PORT / rel
    names = surface(path.read_text(), imports=True)
    if path.name == "__init__.py":      # a package's submodules
        names |= {p.stem for p in path.parent.glob("*.py")}
        names |= {p.parent.name for p in path.parent.glob("*/__init__.py")}
    return frozenset(names)


def missing_names(rel: str, ref_source: str) -> set[str]:
    """The reference module's public names that neither the port's module
    nor a table entry covers (an entry for a class covers its members)."""
    exempt = {key.split(":", 1)[1] for key in (*COUNTERPARTS, *NOT_NEEDED)
              if key.split(":", 1)[0] == rel}
    return {name for name in surface(ref_source) - _port_surface(rel)
            if name not in exempt and name.split(".")[0] not in exempt}


@functools.lru_cache(maxsize=None)
def _ref_surface(rel: str) -> frozenset[str]:
    return frozenset(surface((REF / rel).read_text()))


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_names_have_a_port_counterpart(rel):
    if rel in MODULES_NOT_NEEDED:
        assert not (PORT / rel).exists(), f"{rel} is ported now"
        return
    assert (PORT / rel).exists(), f"no port module for {rel}"
    assert not missing_names(rel, (REF / rel).read_text())


def test_counterparts_exist_in_the_port():
    for key, target in COUNTERPARTS.items():
        rel, name = target.split(":")
        assert name in _port_surface(rel), (key, target)


def test_every_table_entry_is_a_reference_name_the_port_lacks():
    for key in (*COUNTERPARTS, *NOT_NEEDED):
        rel, name = key.split(":")
        assert name in _ref_surface(rel), key
        assert name not in _port_surface(rel), f"{key}: ported, drop it"
    assert all(len(why) > 20 for why in (*NOT_NEEDED.values(),
                                         *MODULES_NOT_NEEDED.values()))


@pytest.mark.parametrize("addition", [
    "def brand_new_public_name():\n    pass\n",
    "class BrandNew:\n    def method(self):\n        pass\n",
    "LIMIT = 3\n"])
def test_a_new_reference_name_without_a_counterpart_fails(addition):
    rel = "core/gemm/tuner.py"
    source = (REF / rel).read_text() + "\n\n" + addition
    assert missing_names(rel, source)
