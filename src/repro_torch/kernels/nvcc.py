"""Build a kernel source with ``nvcc`` and load it with ctypes.

Every CUDA library of the port is one ``csrc/*.cu`` file with a plain C
interface, which may include headers beside it or in the ``csrc/`` of
another kernel package (``deps``). A ``Library`` compiles
its source for ``sm_90a`` into a shared library at first use, into
``_build/`` beside its package (listed in ``.gitignore``), and caches the
handle. The library's name carries a hash
of the flags and of every file in the source's ``csrc/`` directory and in
its ``deps``, so an edited source or header builds anew.
``build_all`` starts one ``nvcc`` per library at once and waits for all.
Nothing here runs at import time: the CPU tests import the kernels'
modules on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


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


class Library:
    """One ``.cu`` source, its flags, and the C signatures it exports.

    ``declare(lib)`` sets ``argtypes``/``restype`` on the loaded handle.
    After a build in this process ``build_s`` holds nvcc's seconds and
    ``ptxas`` its ``-Xptxas -v`` report."""

    def __init__(self, source: Path, flags: tuple[str, ...],
                 declare: Callable[[ctypes.CDLL], None],
                 deps: tuple[Path, ...] = ()):
        self.source = Path(source)
        self.flags = flags
        self.declare = declare
        self.deps = tuple(Path(d) for d in deps)  # other csrc/ it includes
        self.build_dir = self.source.parent.parent / "_build"
        self.lib: ctypes.CDLL | None = None
        self.build_s = 0.0
        self.ptxas = ""

    def path(self) -> Path:
        """The library's file, named by a hash of the flags and of every
        file in the source's directory and its ``deps`` (by name and
        content), so that an edited header builds anew too."""
        h = hashlib.sha256(" ".join(self.flags).encode())
        for d in (self.source.parent, *self.deps):
            for f in sorted(d.rglob("*")):
                if f.is_file() and "__pycache__" not in f.parts:
                    h.update(f.relative_to(d.parent).as_posix().encode())
                    h.update(f.read_bytes())
        tag = h.hexdigest()[:16]
        return self.build_dir / f"lib{self.source.stem}_{tag}.so"

    def start(self) -> tuple[subprocess.Popen, Path, float] | None:
        """Start nvcc unless the library is built; (process, tmp, t0)."""
        out = self.path()
        if out.exists():
            return None
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *self.flags, "-Xptxas", "-v", "-o", str(tmp),
               str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, time.perf_counter()

    def finish(self, started) -> Path:
        """Wait for a build that ``start`` began; returns the library path."""
        out = self.path()
        if started is None:
            return out
        proc, tmp, t0 = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} with code "
                f"{proc.returncode}:\n{err}"
            )
        os.replace(tmp, out)
        self.build_s = time.perf_counter() - t0
        self.ptxas = err
        return out

    def load(self) -> ctypes.CDLL:
        """The library, built and loaded at first call."""
        if self.lib is None:
            lib = ctypes.CDLL(str(self.finish(self.start())))
            self.declare(lib)
            self.lib = lib
        return self.lib


def build_all(libs: list[Library]) -> None:
    """Build every library not yet built, one nvcc each, all at once, and
    load them."""
    started = [(lib, lib.start()) for lib in libs if lib.lib is None]
    for lib, s in started:
        lib.finish(s)
    for lib in libs:
        lib.load()
