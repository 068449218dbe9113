"""--arch config module (exact dims in archs.py)."""
from .archs import MIXTRAL_8X22B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
