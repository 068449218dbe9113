"""--arch config module (exact dims in archs.py)."""
from .archs import SMOLLM_135M as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
