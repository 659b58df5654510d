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

Projection weights and the embedding table are cast to the config's
compute dtype once, here; norm scales stay fp32.  The reference keeps fp32
masters and casts at every use, which gives the same values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import AttentionParams
from .model import DenseLM
from .moe import MoEParams
from .transformer import DenseBlock, MLPParams, check_family, compute_dtype


def from_numpy_params(tree: dict, cfg: ModelConfig,
                      device: str | torch.device) -> DenseLM:
    check_family(cfg)
    device = torch.device(device)
    cdt = compute_dtype(cfg)

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
                               **norms)
        if cfg.family == "moe":
            m = lay["moe"]
            ffn = {"moe": MoEParams(*(t(m[n][i], cdt) for n in (
                "router", "w_gate", "w_up", "w_down")))}
        else:
            m = lay["mlp"]
            ffn = {"mlp": MLPParams(t(m["w_gate"][i], cdt),
                                    t(m["w_up"][i], cdt),
                                    t(m["w_down"][i], cdt))}
        blocks.append(DenseBlock(t(lay["ln1"][i], torch.float32), attn,
                                 t(lay["ln2"][i], torch.float32), **ffn))
    return DenseLM(t(tree["embed"], cdt), t(tree["final_norm"], torch.float32),
                   blocks)
