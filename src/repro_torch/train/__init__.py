from .train_step import make_prefill_step, make_serve_step, make_train_step
from .trainer import Trainer

__all__ = ["Trainer", "make_prefill_step", "make_serve_step",
           "make_train_step"]
