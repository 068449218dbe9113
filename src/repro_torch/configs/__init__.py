from .base import ModelConfig, MoEConfig, SSMConfig, reduced  # noqa: F401
from .archs import ARCHS, get_arch  # noqa: F401
from .shapes import SHAPES, ShapeSpec, applicable, cells  # noqa: F401
