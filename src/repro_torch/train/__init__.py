"""The LM trainer: ``make_train_step`` and the host loop ``TrainLoop``."""
from .trainer import TrainConfig, TrainLoop, make_train_step  # noqa: F401
