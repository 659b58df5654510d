"""--arch registry of the port: the architectures it can run.

The dense decoder and the two MoE decoders on the serving path are ported;
every other architecture of the reference raises until its family is
ported, and so do the reference's quantization suffixes (``-w8`` / ``-w4``
/ ``-int8``), which come with quantization.
"""
from __future__ import annotations

from .base import ModelConfig, smoke_config
from .llama4_scout_17b_a16e import CONFIG as _llama4
from .mixtral_8x7b import CONFIG as _mixtral
from .qwen3_1p7b import CONFIG as _qwen17

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [_qwen17, _mixtral,
                                                     _llama4]}

_QUANT_SUFFIXES = ("w8", "w4", "int8")


def get_config(name: str) -> ModelConfig:
    """Resolve an arch name; ``<arch>-smoke`` shrinks it for CPU tests."""
    base = name[:-len("-smoke")] if name.endswith("-smoke") else name
    if base.rsplit("-", 1)[-1] in _QUANT_SUFFIXES:
        raise KeyError(f"{name!r}: quantized variants are not ported yet")
    if base not in ARCHS:
        raise KeyError(f"{name!r} is not ported yet (the port runs "
                       f"{sorted(ARCHS)}, each optionally with -smoke)")
    cfg = ARCHS[base]
    return smoke_config(cfg) if base != name else cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
