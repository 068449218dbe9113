"""--arch config module (exact dims in archs.py)."""
from .archs import NEMOTRON_4_340B as CONFIG  # noqa: F401
from .base import reduced

SMOKE = reduced(CONFIG)
