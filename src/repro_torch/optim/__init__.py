"""Optimizer: AdamW with fp32 master weights, the LR schedule, and int8
error-feedback gradient compression over the port's ``Mesh``."""
from . import adamw, grad_compress, schedule  # noqa: F401
from .adamw import (AdamWConfig, abstract_opt_state, adamw_update,  # noqa: F401
                    init_opt_state)
