"""--arch config module (exact dims in archs.py)."""
from .archs import LLAMA_32_VISION_11B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
