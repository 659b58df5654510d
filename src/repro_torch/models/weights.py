"""Carry a parameter tree of the reference layout into the port's modules.

The tree is the dense LM's parameter dict as numpy arrays, with the layer
leaves stacked on a leading (L,) axis:

    {"embed": (V_pad, D), "final_norm": (D,),
     "layers": {"ln1": (L, D), "ln2": (L, D),
                "attn": {"wq": (L, D, H*hd), "wk": (L, D, KVH*hd),
                         "wv": (L, D, KVH*hd), "wo": (L, H*hd, D),
                         ["q_norm": (L, hd), "k_norm": (L, hd)]},
                "mlp": {"w_gate": (L, D, F), "w_up": (L, D, F),
                        "w_down": (L, F, D)}}}

and in the MoE family ``layers.moe`` in place of ``layers.mlp``:

    {"router": (L, D, E), "w_gate": (L, E, D, F), "w_up": (L, E, D, F),
     "w_down": (L, E, F, D)}

The SSM family's layers are Mamba2 blocks,

    {"ln": (L, D),
     "ssm": {"in_proj": (L, D, 2·Di + 2N + H), "conv_w": (L, 4, Di + 2N),
             "conv_b": (L, Di + 2N), "A_log": (L, H), "D_skip": (L, H),
             "dt_bias": (L, H), "norm": (L, Di), "out_proj": (L, Di, D)}}

and the hybrid adds ``shared_attn``, one dense block's dict without the
(L,) axis.  The encoder-decoder's decoder layers add the cross-attention,

    {"ln_cross": (L, D), "cross": {"wq", "wk", "wv", "wo"}}   (no qk-norm)

and the model adds ``encoder`` (dense layers stacked on (L_enc,)),
``enc_norm`` (D,) and ``frame_proj`` (D, D); the vision-language model adds
``patch_proj`` (D, D).

Projection weights, the conv taps and the embedding table come in the
config's compute dtype for serving; with a ``dtype`` they are training
masters in that dtype that require grad (cast at use, as in the
reference).  Norm scales (``enc_norm`` and ``ln_cross`` too) and the
SSM's A_log / D_skip / dt_bias stay fp32.  ``to_numpy_tree`` is the
inverse: tensors keyed by the model's parameter names (its parameters,
``to_numpy_params``, or the optimizer's moments) back to the tree, so
tests and checkpoints compare leaf by leaf with the reference;
``load_numpy_tree`` copies a tree back
into such tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import AttentionParams
from .model import DenseLM
from .moe import MoEParams
from .ssm import SSMParams
from .transformer import (RECURRENT_FAMILIES, DenseBlock, MLPParams, SSMBlock,
                          as_dtype, check_family, compute_dtype)


def from_numpy_params(tree: dict, cfg: ModelConfig,
                      device: str | torch.device,
                      dtype: str | torch.dtype | None = None) -> DenseLM:
    check_family(cfg)
    device = torch.device(device)
    rg = dtype is not None
    cdt = as_dtype(dtype) if rg else compute_dtype(cfg)
    f32 = torch.float32

    def t(x, dtype):
        return torch.tensor(np.asarray(x, np.float32)).to(device, dtype)

    def attention(a: dict, pick, qk_norm: bool) -> AttentionParams:
        norms = ({"q_norm": t(pick(a["q_norm"]), f32),
                  "k_norm": t(pick(a["k_norm"]), f32)} if qk_norm else {})
        return AttentionParams(*(t(pick(a[n]), cdt)
                                 for n in ("wq", "wk", "wv", "wo")),
                               **norms, requires_grad=rg)

    def dense_block(node: dict, pick) -> DenseBlock:
        """A DenseBlock from ``node``, each leaf taken through ``pick``
        (one layer of a stacked leaf, or the leaf itself)."""
        attn = attention(node["attn"], pick, cfg.qk_norm)
        ffn = ({"ln_cross": t(pick(node["ln_cross"]), f32),
                "cross": attention(node["cross"], pick, False)}
               if "cross" in node else {})
        if "moe" in node:
            ffn["moe"] = MoEParams(*(t(pick(node["moe"][n]), cdt) for n in (
                "router", "w_gate", "w_up", "w_down")), requires_grad=rg)
        else:
            ffn["mlp"] = MLPParams(*(t(pick(node["mlp"][n]), cdt) for n in (
                "w_gate", "w_up", "w_down")), requires_grad=rg)
        return DenseBlock(t(pick(node["ln1"]), f32), attn,
                          t(pick(node["ln2"]), f32), **ffn, requires_grad=rg)

    def ssm_block(i: int) -> SSMBlock:
        mixer = tree["layers"]["ssm"]
        dtypes = {"in_proj": cdt, "conv_w": cdt, "conv_b": cdt,
                  "A_log": f32, "D_skip": f32, "dt_bias": f32, "norm": f32,
                  "out_proj": cdt}
        return SSMBlock(t(tree["layers"]["ln"][i], f32),
                        SSMParams(**{n: t(mixer[n][i], d)
                                     for n, d in dtypes.items()},
                                  requires_grad=rg),
                        requires_grad=rg)

    if cfg.family in RECURRENT_FAMILIES:
        blocks = [ssm_block(i) for i in range(cfg.num_layers)]
    else:
        blocks = [dense_block(tree["layers"], lambda x, i=i: x[i])
                  for i in range(cfg.num_layers)]
    extra = {}
    if cfg.family == "hybrid":
        extra["shared_attn"] = dense_block(tree["shared_attn"], lambda x: x)
    if cfg.family == "encdec":
        extra["encoder"] = [dense_block(tree["encoder"], lambda x, i=i: x[i])
                            for i in range(cfg.encoder_layers)]
        extra["enc_norm"] = t(tree["enc_norm"], f32)
    for name in ("frame_proj", "patch_proj"):
        if name in tree:
            extra[name] = t(tree[name], cdt)
    return DenseLM(t(tree["embed"], cdt), t(tree["final_norm"], f32), blocks,
                   requires_grad=rg, **extra)


def _tree_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """A parameter name of the port (``layers.3.attn.wq``,
    ``encoder.1.mlp.w_up``) -> its path in the reference tree (``("layers",
    "attn", "wq")``) and layer index."""
    parts = name.split(".")
    if parts[0] in ("layers", "encoder"):
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def to_numpy_tree(named: dict[str, torch.Tensor]) -> dict:
    """Tensors keyed by the port's parameter names -> the reference's tree
    of numpy arrays, each layer leaf stacked on a leading (L,) axis (the
    dtype kept).  Every leaf is a copy: later in-place updates of the
    tensors (AdamW's) never reach the tree."""
    stacked: dict[tuple[str, ...], dict[int, np.ndarray]] = {}
    tree: dict = {}
    for name, value in named.items():
        path, layer = _tree_path(name)
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value.detach().to("cpu", copy=True).numpy()
        else:   # np.stack below copies
            stacked.setdefault(path, {})[layer] = value.detach().cpu().numpy()
    for path, per_layer in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([per_layer[i] for i in sorted(per_layer)])
    return tree


def load_numpy_tree(named: dict[str, torch.Tensor], tree: dict) -> None:
    """The inverse of ``to_numpy_tree``, in place: copy each leaf of the
    reference-layout ``tree`` into the tensor of that name (its dtype and
    device kept)."""
    with torch.no_grad():
        for name, dst in named.items():
            path, layer = _tree_path(name)
            node = tree
            for key in path:
                node = node[key]
            src = node if layer is None else node[layer]
            dst.copy_(torch.as_tensor(np.asarray(src)))


def to_numpy_params(model: DenseLM) -> dict:
    """The model's parameters as the reference's tree of numpy arrays."""
    return to_numpy_tree(dict(model.named_parameters()))
