from .train_step import make_train_step
from .trainer import Trainer

__all__ = ["Trainer", "make_train_step"]
