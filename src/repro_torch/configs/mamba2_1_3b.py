"""--arch config module (exact dims in archs.py)."""
from .archs import MAMBA2_1_3B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
