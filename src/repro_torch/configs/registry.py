"""--arch registry of the port: the architectures it can run.

The dense decoder, the two MoE decoders, the attention-free SSM
(mamba2-370m), the hybrid (zamba2-7b), the encoder-decoder
(whisper-base) and the vision-language decoder (llava-next-34b) are
ported; every other architecture of the reference raises until it is.  The
reference's variant suffixes compose in either order: ``-smoke`` and
``-w8`` / ``-w4`` / ``-int8`` (``ModelConfig.quant``, the quantized ragged
experts).  As in the reference, the dense family ignores
``quant``, and capacity dispatch with it raises in the forward pass.
"""
from __future__ import annotations

from dataclasses import replace

from .base import ModelConfig, smoke_config
from .llama4_scout_17b_a16e import CONFIG as _llama4
from .llava_next_34b import CONFIG as _llava
from .mamba2_370m import CONFIG as _mamba2
from .mixtral_8x7b import CONFIG as _mixtral
from .qwen3_1p7b import CONFIG as _qwen17
from .whisper_base import CONFIG as _whisper
from .zamba2_7b import CONFIG as _zamba2

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [
    _qwen17, _mixtral, _llama4, _mamba2, _zamba2, _whisper, _llava]}

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
        raise KeyError(f"{name!r} is not ported yet (the port runs "
                       f"{sorted(ARCHS)}, each optionally with -smoke and "
                       f"one of {_QUANT_SUFFIXES})")
    cfg = ARCHS[base]
    if smoke:
        cfg = smoke_config(cfg)
    return replace(cfg, quant=quant) if quant != "none" else cfg


def list_archs() -> list[str]:
    return sorted(ARCHS)
