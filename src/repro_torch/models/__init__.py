from . import attention, layers, model, moe, transformer, weights
from .model import (DenseLM, decode_step, forward_train, init_params,
                    loss_fn, make_cache, prefill, prefill_bucket)
from .weights import from_numpy_params, to_numpy_params

__all__ = [
    "attention", "layers", "model", "moe", "transformer", "weights", "DenseLM",
    "decode_step", "forward_train", "init_params", "loss_fn", "make_cache",
    "prefill", "prefill_bucket", "from_numpy_params", "to_numpy_params",
]
