"""The sim-step CUDA library, built and loaded with ctypes.

``load()`` compiles ``csrc/simstep.cu`` for ``sm_90a`` at first use
(``repro_torch.kernels.nvcc``) and caches the handle. Like the
water-filling library it keeps ``--fmad=false``: the sim's f64 step must
be bitwise equal to the numpy sim, so no multiply-add may be contracted.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import BASE_FLAGS, Library

SOURCE = Path(__file__).resolve().parent / "csrc" / "simstep.cu"
NVCC_FLAGS = BASE_FLAGS + ("--fmad=false",)
_P = ctypes.c_void_p
_I = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    lib.sim_pre_f64.argtypes = [_P, _I, _P]
    lib.sim_pre_f64.restype = _I
    lib.sim_post_f64.argtypes = [_P, _P, _P]
    lib.sim_post_f64.restype = _I
    lib.simstep_args_bytes.argtypes = []
    lib.simstep_args_bytes.restype = ctypes.c_size_t


LIBRARY = Library(SOURCE, NVCC_FLAGS, _declare)


def load() -> ctypes.CDLL:
    """The library, built and loaded at first call."""
    return LIBRARY.load()
