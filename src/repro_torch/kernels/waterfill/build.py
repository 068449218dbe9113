"""The water-filling CUDA library, built and loaded with ctypes.

``load()`` compiles ``csrc/waterfill.cu`` for ``sm_90a`` at first use
(``repro_torch.kernels.nvcc``) and caches the handle. This library alone
keeps ``--fmad=false``: its f64 kernel must be bitwise equal to the numpy
sim, so no multiply-add may be contracted.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from ..nvcc import BASE_FLAGS, Library

SOURCE = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"
NVCC_FLAGS = BASE_FLAGS + ("--fmad=false",)
_P = ctypes.c_void_p
_I = ctypes.c_int
_WATERFILL_ARGS = [_P] * 17 + [_I] * 5 + [_P]


def _declare(lib: ctypes.CDLL) -> None:
    for name in ("waterfill_f64_shared", "waterfill_f32"):
        fn = getattr(lib, name)
        fn.argtypes = _WATERFILL_ARGS
        fn.restype = _I
    for name in ("waterfill_f64_cluster", "waterfill_f32_cluster"):
        # + the lane scratch before `out`, the clocks before the stream
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 18 + [_I] * 5 + [_P, _P]
        fn.restype = _I
    lib.segsum_ordered_f64.argtypes = [_P, _P, _P, _P, _I, _P]
    lib.segsum_ordered_f64.restype = _I
    lib.f64_add_chain.argtypes = [_P, _P, _I, _P]
    lib.f64_add_chain.restype = _I
    lib.waterfill_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.waterfill_smem_bytes.restype = ctypes.c_size_t
    lib.waterfill_shared_smem_bytes.argtypes = [_I, _I, _I]
    lib.waterfill_shared_smem_bytes.restype = ctypes.c_size_t
    lib.waterfill_smem_limit.argtypes = [_I]
    lib.waterfill_smem_limit.restype = ctypes.c_size_t
    lib.waterfill_scratch_bytes.argtypes = [_I, _I]
    lib.waterfill_scratch_bytes.restype = ctypes.c_size_t
    lib.waterfill_cluster_smem_bytes.argtypes = [_I] * 6
    lib.waterfill_cluster_smem_bytes.restype = ctypes.c_size_t
    lib.waterfill_cluster_plan.argtypes = [_I] * 5
    lib.waterfill_cluster_plan.restype = _I
    lib.waterfill_cluster_max.argtypes = []
    lib.waterfill_cluster_max.restype = _I


def _declare_clocked(lib: ctypes.CDLL) -> None:
    _declare(lib)
    # + the clocks before the stream
    lib.waterfill_f64_clocked.argtypes = [_P] * 17 + [_I] * 5 + [_P, _P]
    lib.waterfill_f64_clocked.restype = _I


LIBRARY = Library(SOURCE, NVCC_FLAGS, _declare)
# the same source with the staged kernel's clock probes compiled in
# (``waterfill_f64_clocked``): a per-pass split, never the sim's path
CLOCKED = Library(SOURCE, NVCC_FLAGS + ("-DWATERFILL_CLOCKS",),
                  _declare_clocked)


def load() -> ctypes.CDLL:
    """The library, built and loaded at first call."""
    return LIBRARY.load()


def load_clocked() -> ctypes.CDLL:
    """The library with ``waterfill_f64_clocked``, built at first call."""
    return CLOCKED.load()


def build_info() -> dict:
    """Seconds the last build in this process took and ptxas's report."""
    return {"build_s": LIBRARY.build_s, "ptxas": LIBRARY.ptxas}
