"""Roofline of one step on one H100, from the analytic perf model.

    compute = FLOPs / (chips x peak bf16 FLOP/s)
    memory  = device-memory bytes / (chips x memory bandwidth)

with the rates of ``core.gemm.cmr.H100`` (989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s; NVIDIA's H100 SXM data sheet).  The reference's third
term, the collective time from the compiled program's collectives, comes
with the port's distributed layer: until then it is 0 and ``coll_by_type``
is empty.
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
                   mesh_name: str = "1xH100", chips: int = 1,
                   spec: HopperSpec = H100) -> Roofline:
    """The two-term roofline (the collective term is 0 on one card)."""
    r = Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=analytic_flops / chips,
        bytes_per_device_hbm=analytic_bytes / chips,
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

