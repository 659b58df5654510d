"""--arch registry of the port: the reference's ten architectures.

The dense decoders (qwen3-1.7b, qwen3-8b, gemma3-4b with its 5:1
sliding-window pattern, minitron-4b), the two MoE decoders, the
attention-free SSM (mamba2-370m), the hybrid (zamba2-7b), the
encoder-decoder (whisper-base) and the vision-language decoder
(llava-next-34b); ``list_archs()`` equals the reference's.  The
reference's variant suffixes compose in either order: ``-smoke`` and
``-w8`` / ``-w4`` / ``-int8`` (``ModelConfig.quant``, the quantized ragged
experts).  As in the reference, the dense family ignores
``quant``, and capacity dispatch with it raises in the forward pass.
"""
from __future__ import annotations

from dataclasses import replace

from .base import ModelConfig, smoke_config
from .gemma3_4b import CONFIG as _gemma3
from .llama4_scout_17b_a16e import CONFIG as _llama4
from .llava_next_34b import CONFIG as _llava
from .mamba2_370m import CONFIG as _mamba2
from .minitron_4b import CONFIG as _minitron
from .mixtral_8x7b import CONFIG as _mixtral
from .qwen3_1p7b import CONFIG as _qwen17
from .qwen3_8b import CONFIG as _qwen8
from .whisper_base import CONFIG as _whisper
from .zamba2_7b import CONFIG as _zamba2

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    _qwen17, _qwen8, _gemma3, _minitron, _mixtral, _llama4, _mamba2,
    _zamba2, _whisper, _llava]}

_QUANT_SUFFIXES = ("w8", "w4", "int8")


def get_config(name: str) -> ModelConfig:
    """Resolve an arch name with its variant suffixes, in either order:
    ``<arch>-smoke`` shrinks it for CPU tests, ``<arch>-w8`` / ``-w4`` /
    ``-int8`` sets ``quant`` (``llama4-scout-17b-a16e-w8-smoke`` and
    ``...-smoke-w8`` are one config)."""
    base, quant, smoke = name, "none", False
    while True:
        if base.endswith("-smoke") and not smoke:
            base, smoke = base[:-len("-smoke")], True
            continue
        tail = base.rsplit("-", 1)[-1]
        if tail in _QUANT_SUFFIXES and quant == "none":
            base, quant = base[:-len(tail) - 1], tail
            continue
        break
    if base not in ARCHS:
        raise KeyError(f"unknown architecture {name!r} (the port runs "
                       f"{sorted(ARCHS)}, each optionally with -smoke and "
                       f"one of {_QUANT_SUFFIXES})")
    cfg = ARCHS[base]
    if smoke:
        cfg = smoke_config(cfg)
    return replace(cfg, quant=quant) if quant != "none" else cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
