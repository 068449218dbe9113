"""--arch config module (exact dims in archs.py)."""
from .archs import MISTRAL_LARGE_123B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
