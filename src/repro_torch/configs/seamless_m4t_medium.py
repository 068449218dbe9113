"""--arch config module (exact dims in archs.py)."""
from .archs import SEAMLESS_M4T_MEDIUM as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
