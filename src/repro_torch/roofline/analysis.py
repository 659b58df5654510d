"""Roofline of one step on H100s: three terms, as the reference's.

    compute    = FLOPs / (chips x peak bf16 FLOP/s)
    memory     = device-memory bytes / (chips x memory bandwidth)
    collective = wire bytes of one rank's collectives / NVLink rate

with the rates of ``core.gemm.cmr.H100`` (989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s, 18 NVLinks of 25 GB/s a direction = 450 GB/s a GPU
sends; NVIDIA's H100 SXM data sheet).  FLOPs and bytes come from the
analytic perf model (``roofline.perf_model``), divided over the cards.

The collective term reads the collectives the step issued on rank 0
(``core.gemm.collective.record``: the production-mesh dry run,
``launch.dryrun``, runs the step on an abstract mesh and records them)
where the reference parses the compiled HLO: ``collective_bytes`` sums
them by op with the reference's wire convention -- a collective's
result-tensor bytes, x2 for an all-reduce (the reduce and broadcast
phases of a ring).  The recorded entries are already one rank's and
already multiplied out over the layers (the stack is a Python loop), so
no trip count is read.  The rate is one GPU's NVLink: an 8-GPU HGX node is
one NVLink domain, and a 16-wide model axis spans two of them, whose
traffic crosses the slower inter-node network -- so the term is a lower
bound, and no inter-node rate is assumed here.

``raw_cost`` holds the FLOPs ``torch.utils.flop_counter.FlopCounterMode``
counted over the abstract step (the plain versions' products: the ragged
ones' masked passes count every group over every row, so this exceeds
the kernels' work); XLA's "bytes accessed" has no counterpart and is
left out.  The perf model's expert-parallel exchange (``step_perf(
ep_shards=)``'s ``moe_a2a`` bucket) is carried as
``bytes_per_device_ici``, reported beside the terms and not priced.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..core.gemm.cmr import H100, HopperSpec

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")


def collective_bytes(entries) -> dict[str, float]:
    """The reference's dict over recorded collectives (each with ``op``
    and ``bytes``, as ``core.gemm.collective.Collective``): the result
    bytes of each op summed, and each op's count as ``n_<op>``."""
    out = {op: 0.0 for op in COLL_OPS}
    counts = {op: 0.0 for op in COLL_OPS}
    for e in entries:
        out[e.op] += float(e.bytes)
        counts[e.op] += 1.0
    out.update({f"n_{op}": counts[op] for op in COLL_OPS})
    return out


def wire_bytes(coll: dict) -> float:
    """The reference's convention: result bytes, x2 for an all-reduce."""
    return (2.0 * coll.get("all-reduce", 0.0)
            + sum(coll.get(op, 0.0) for op in COLL_OPS
                  if op != "all-reduce"))


@dataclass
class Roofline:
    """The roofline of one (arch x shape) cell on ``chips`` cards.
    flops / bytes come from the analytic perf model
    (``roofline.perf_model``), divided over the cards."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device_hbm: float
    bytes_per_device_ici: float = 0.0   # the perf model's moe_a2a bytes
    coll_bytes_wire: float = 0.0
    coll_by_type: dict = field(default_factory=dict)
    raw_cost: dict = field(default_factory=dict)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: float = 0.0            # 6*N_active*D (train) / 2*N*D (inf)
    peak_memory_per_device: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Ideal step time with perfect overlap: the largest term."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS over the counted FLOPs (catches remat and padding)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS / (chips x H100 bf16 peak x t_bound): the share of
        the cards' bf16 peak spent on useful model math at the bound."""
        if not self.t_bound:
            return 0.0
        return self.model_flops / (self.chips * H100.peak_flops_bf16
                                   * self.t_bound)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(dominant=self.dominant, t_bound=self.t_bound,
                 useful_fraction=self.useful_fraction,
                 roofline_fraction=self.roofline_fraction)
        return d


def build_roofline(*, arch: str, shape: str, analytic_flops: float,
                   analytic_bytes: float, model_flops: float,
                   analytic_ici: float = 0.0,
                   mesh_name: str = "1xH100", chips: int = 1,
                   coll: dict | None = None, cost: dict | None = None,
                   memory_stats: dict | None = None,
                   spec: HopperSpec = H100) -> Roofline:
    """The three-term roofline.  ``coll``: one rank's ``collective_bytes``
    (none: the collective term is 0); ``cost``: the counted FLOPs
    (``{"flops": ...}``); ``memory_stats``: the dry run's memory dict,
    whose ``peak_memory`` is carried; ``analytic_ici``: the perf model's
    interconnect bytes, divided over the cards as the others."""
    coll = dict(coll or {})
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=analytic_flops / chips,
        bytes_per_device_hbm=analytic_bytes / chips,
        bytes_per_device_ici=analytic_ici / chips,
        coll_bytes_wire=wire_bytes(coll), coll_by_type=coll,
        raw_cost={k: v for k, v in (cost or {}).items() if k == "flops"},
        model_flops=model_flops)
    r.t_compute = r.flops_per_device / spec.peak_flops_bf16
    r.t_memory = r.bytes_per_device_hbm / spec.hbm_bw
    r.t_collective = r.coll_bytes_wire / spec.link_bw
    if memory_stats:
        r.peak_memory_per_device = memory_stats.get("peak_memory", 0.0)
    return r


def model_flops_estimate(cfg, shape, kind: str) -> float:
    """MODEL_FLOPS: 6*N*D for training (N = active params, D = tokens);
    2*N*D for an inference forward."""
    n = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n * shape.tokens
    if kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch   # decode: one token per sequence

