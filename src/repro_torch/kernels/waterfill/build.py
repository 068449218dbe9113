"""Build the water-filling CUDA library and load it with ctypes.

``load()`` compiles ``csrc/waterfill.cu`` with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, into ``_build/``
beside this file (listed in ``.gitignore``), and caches the handle. The
library's name carries a hash of the source and the flags, so an edited
source builds anew. Nothing here runs at import time: the CPU tests import
this module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
_P = ctypes.c_void_p
_I = ctypes.c_int
_WATERFILL_ARGS = [_P] * 17 + [_I] * 5 + [_P]


class _Loaded:
    """The one loaded library of this process, and how it was built."""

    lib: ctypes.CDLL | None = None
    build_s: float = 0.0
    ptxas: str = ""


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then /usr/local/cuda, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return found


def build() -> Path:
    """Compile the library unless this source and these flags already
    have one; returns its path."""
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libwaterfill_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)
    _Loaded.build_s = time.perf_counter() - t0
    _Loaded.ptxas = proc.stderr
    return out


def load() -> ctypes.CDLL:
    """The library, built and loaded at first call."""
    if _Loaded.lib is not None:
        return _Loaded.lib
    lib = ctypes.CDLL(str(build()))
    for name in ("waterfill_f64", "waterfill_f32"):
        fn = getattr(lib, name)
        fn.argtypes = _WATERFILL_ARGS
        fn.restype = _I
    lib.segsum_ordered_f64.argtypes = [_P, _P, _P, _P, _I, _P]
    lib.segsum_ordered_f64.restype = _I
    lib.waterfill_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.waterfill_smem_bytes.restype = ctypes.c_size_t
    lib.waterfill_smem_limit.argtypes = [_I]
    lib.waterfill_smem_limit.restype = ctypes.c_size_t
    _Loaded.lib = lib
    return lib


def build_info() -> dict:
    """Seconds the last build in this process took and ptxas's report."""
    return {"build_s": _Loaded.build_s, "ptxas": _Loaded.ptxas}
