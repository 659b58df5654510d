"""The optimizer (AdamW, ``adamw``) and the int8 error-feedback gradient
all-reduce (``compression``)."""
from .adamw import (OptConfig, apply_updates, global_norm, init_opt_state,
                    schedule)
from .compression import compress_allreduce, init_error_state

__all__ = ["OptConfig", "apply_updates", "compress_allreduce", "global_norm",
           "init_error_state", "init_opt_state", "schedule"]
