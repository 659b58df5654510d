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

Projection weights and the embedding table come in the config's compute
dtype for serving; with a ``dtype`` they are training masters in that
dtype that require grad (cast at use, as in the reference).  Norm scales
stay fp32.  ``to_numpy_tree`` is the inverse: tensors keyed by the
model's parameter names (its parameters, ``to_numpy_params``, or the
optimizer's moments) back to the tree, so tests and checkpoints compare
leaf by leaf with the reference; ``load_numpy_tree`` copies a tree back
into such tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import AttentionParams
from .model import DenseLM
from .moe import MoEParams
from .transformer import (DenseBlock, MLPParams, as_dtype, check_family,
                          compute_dtype)


def from_numpy_params(tree: dict, cfg: ModelConfig,
                      device: str | torch.device,
                      dtype: str | torch.dtype | None = None) -> DenseLM:
    check_family(cfg)
    device = torch.device(device)
    rg = dtype is not None
    cdt = as_dtype(dtype) if rg else compute_dtype(cfg)

    def t(x, dtype):
        return torch.tensor(np.asarray(x, np.float32)).to(device, dtype)

    lay = tree["layers"]
    blocks = []
    for i in range(cfg.num_layers):
        a = lay["attn"]
        norms = ({"q_norm": t(a["q_norm"][i], torch.float32),
                  "k_norm": t(a["k_norm"][i], torch.float32)}
                 if cfg.qk_norm else {})
        attn = AttentionParams(t(a["wq"][i], cdt), t(a["wk"][i], cdt),
                               t(a["wv"][i], cdt), t(a["wo"][i], cdt),
                               **norms, requires_grad=rg)
        if cfg.family == "moe":
            m = lay["moe"]
            ffn = {"moe": MoEParams(*(t(m[n][i], cdt) for n in (
                "router", "w_gate", "w_up", "w_down")), requires_grad=rg)}
        else:
            m = lay["mlp"]
            ffn = {"mlp": MLPParams(t(m["w_gate"][i], cdt),
                                    t(m["w_up"][i], cdt),
                                    t(m["w_down"][i], cdt), requires_grad=rg)}
        blocks.append(DenseBlock(t(lay["ln1"][i], torch.float32), attn,
                                 t(lay["ln2"][i], torch.float32), **ffn,
                                 requires_grad=rg))
    return DenseLM(t(tree["embed"], cdt), t(tree["final_norm"], torch.float32),
                   blocks, requires_grad=rg)


def _tree_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """A parameter name of the port (``layers.3.attn.wq``) -> its path in
    the reference tree (``("layers", "attn", "wq")``) and layer index."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("layers", *parts[2:]), int(parts[1])
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
