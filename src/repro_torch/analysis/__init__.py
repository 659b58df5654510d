"""Static analysis of the port's kernels and GEMM plans.

``contracts`` proves plans safe for the Hopper kernels without launching
one; ``sweep`` is the CLI ratchet (``python -m repro_torch.analysis.sweep``)
that checks the full candidate space for the paper's irregular shapes and
every registry config.
"""
from .contracts import (
    ContractError,
    KernelContract,
    RecordKey,
    Violation,
    assert_plan,
    check_blocks,
    check_budget,
    check_contraction_masking,
    check_epilogue_vectors,
    check_plan,
    check_ragged_rows,
    check_record,
    check_schedule,
    errors,
    masked_operands,
    parse_key,
    plan_kernel,
    smem_footprint,
    variant_contract,
    verify_contract,
)

__all__ = [
    "ContractError",
    "KernelContract",
    "RecordKey",
    "Violation",
    "assert_plan",
    "check_blocks",
    "check_budget",
    "check_contraction_masking",
    "check_epilogue_vectors",
    "check_plan",
    "check_ragged_rows",
    "check_record",
    "check_schedule",
    "errors",
    "masked_operands",
    "parse_key",
    "plan_kernel",
    "smem_footprint",
    "variant_contract",
    "verify_contract",
]
