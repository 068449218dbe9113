"""--arch config module (exact dims in archs.py)."""
from .archs import QWEN3_MOE_30B_A3B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
