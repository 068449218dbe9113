"""--arch config module (exact dims in archs.py)."""
from .archs import QWEN2_7B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
