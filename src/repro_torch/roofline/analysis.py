"""Roofline of one step on one H100, from the analytic perf model.

    compute = FLOPs / (chips x peak bf16 FLOP/s)
    memory  = device-memory bytes / (chips x memory bandwidth)

with the rates of ``core.gemm.cmr.H100`` (989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s; NVIDIA's H100 SXM data sheet).  The reference's third
term, the collective time, comes from the collectives of the compiled
program (its ``collective_bytes`` over the lowered HLO).  The port has no
lowered program yet -- lowering on the production mesh is Queue 1 item
10.5, slice 17 -- so ``t_collective`` stays 0 and ``coll_by_type`` empty.
The perf model's expert-parallel exchange (``step_perf(ep_shards=)``'s
``moe_a2a`` bucket) is carried as ``bytes_per_device_ici``, reported
beside the two terms and not priced into the bound.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

from ..core.gemm.cmr import H100, HopperSpec


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
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    model_flops: float = 0.0            # 6*N_active*D (train) / 2*N*D (inf)

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
                   spec: HopperSpec = H100) -> Roofline:
    """The two-term roofline (the collective term stays 0 until slice 17
    lowers a step); ``analytic_ici``: the perf model's interconnect bytes
    (``Perf.bytes_ici``), divided over the cards as the others."""
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=analytic_flops / chips,
        bytes_per_device_hbm=analytic_bytes / chips,
        bytes_per_device_ici=analytic_ici / chips,
        model_flops=model_flops)
    r.t_compute = r.flops_per_device / spec.peak_flops_bf16
    r.t_memory = r.bytes_per_device_hbm / spec.hbm_bw
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

