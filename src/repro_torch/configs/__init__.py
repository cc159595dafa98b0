"""Model and deployment configs: the ten LM architectures of the serving
path (``registry.ARCHS``, ``--arch <id>``), their assigned input shapes
(``shapes.SHAPES``) and the paper's ANN deployment
(``decouplevs_ann.py``). The arch files are data, copied from the
reference's with the port's config classes."""
from . import shapes  # noqa: F401
from .registry import (ARCHS, get_config, preset_config,  # noqa: F401
                       reduce_config)
from .shapes import SHAPES, ShapeSpec, applicable  # noqa: F401
