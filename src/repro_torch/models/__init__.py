"""The LM family of the serving path: schemas, layers, MoE, state-space
mixers, the decoder-only and encoder-decoder forwards and the ``Model``
API, as plain functions on nested dicts of tensors."""
from . import api, encdec, layers, moe, schema, sharding, ssm, transformer  # noqa: F401
from .api import Model  # noqa: F401
from .transformer import LayerDesc, ModelConfig  # noqa: F401
