"""--arch registry of the port: the architectures it can run.

Only the dense decoder on the serving path is ported so far; every other
architecture of the reference raises until its family is ported.
"""
from __future__ import annotations

from .base import ModelConfig, smoke_config
from .qwen3_1p7b import CONFIG as _qwen17

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [_qwen17]}


def get_config(name: str) -> ModelConfig:
    """Resolve an arch name; ``<arch>-smoke`` shrinks it for CPU tests."""
    base = name[:-len("-smoke")] if name.endswith("-smoke") else name
    if base not in ARCHS:
        raise KeyError(f"{name!r} is not ported yet (the port runs "
                       f"{sorted(ARCHS)}, each optionally with -smoke)")
    cfg = ARCHS[base]
    return smoke_config(cfg) if base != name else cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
