"""Shape classification for irregular GEMMs (paper §III-A).

The paper defines three irregular types for C += A x B with at least one of
M, K sufficiently large and N <= 96 (<= 3 x 32-lane vregs on FT-m7032):

    T1: M >> K ~ N      tall-and-skinny x small
    T2: K >> M ~ N      skinny-and-tall x tall-and-skinny
    T3: M ~ K >> N      large regular x tall-and-skinny

TPU adaptation: the natural "skinny" unit is one 128-wide lane tile, so the
skinny threshold defaults to 128 instead of 96; the "much larger" ratio is
kept at the paper's implied order-of-magnitude gap (default 8x).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class GemmClass(enum.Enum):
    REGULAR = "regular"
    T1_TALL_SMALL = "t1_tall_small"        # M >> K ~ N
    T2_SKINNY_TALL = "t2_skinny_tall"      # K >> M ~ N
    T3_REGULAR_TALL = "t3_regular_tall"    # M ~ K >> N


@dataclass(frozen=True)
class ShapeThresholds:
    skinny: int = 128      # "N is small" boundary (one lane tile)
    ratio: float = 8.0     # "much larger than" factor


def classify(m: int, k: int, n: int,
             th: ShapeThresholds = ShapeThresholds()) -> GemmClass:
    """Classify a GEMM shape into the paper's taxonomy."""
    r = th.ratio
    n_small = n <= th.skinny
    if n_small and m >= r * max(k, n) and k <= th.skinny * 4:
        return GemmClass.T1_TALL_SMALL
    if n_small and k >= r * max(m, n) and m <= th.skinny * 4:
        return GemmClass.T2_SKINNY_TALL
    if n_small and m >= r * n and k >= r * n:
        return GemmClass.T3_REGULAR_TALL
    return GemmClass.REGULAR


def is_irregular(m: int, k: int, n: int,
                 th: ShapeThresholds = ShapeThresholds()) -> bool:
    return classify(m, k, n, th) is not GemmClass.REGULAR


# The paper's three irregular families (§III-A), TPU-adapted sizes — 21
# shapes, every one classified T1/T2/T3.  Single source of truth, shared by
# the measured sweep (``benchmarks.autotune``) and the static verification
# ratchet (``repro.analysis.sweep``).
PAPER_IRREGULAR_SHAPES: tuple[tuple[str, int, int, int], ...] = (
    # T1: M >> K ~ N (tall-and-skinny x small)
    ("t1_64k_32", 65536, 32, 32),
    ("t1_64k_64", 65536, 64, 64),
    ("t1_64k_128", 65536, 128, 128),
    ("t1_256k_32", 262144, 32, 32),
    ("t1_256k_64", 262144, 64, 64),
    ("t1_256k_128", 262144, 128, 128),
    ("t1_1m_32", 1048576, 32, 32),
    ("t1_1m_64", 1048576, 64, 64),
    ("t1_1m_128", 1048576, 128, 128),
    # T2: K >> M ~ N (skinny-and-tall x tall-and-skinny)
    ("t2_32_64k", 32, 65536, 32),
    ("t2_32_256k", 32, 262144, 64),
    ("t2_64_1m", 64, 1048576, 64),
    ("t2_128_512k", 128, 524288, 128),
    ("t2_32_1m", 32, 1048576, 32),
    ("t2_64_64k", 64, 65536, 128),
    # T3: M ~ K >> N (large regular x tall-and-skinny)
    ("t3_4k_32", 4096, 4096, 32),
    ("t3_8k_64", 8192, 8192, 64),
    ("t3_8k_96", 8192, 8192, 96),
    ("t3_16k_32", 16384, 16384, 32),
    ("t3_20k_32", 20480, 20480, 32),
    ("t3_20k_96", 20480, 20480, 96),
)
