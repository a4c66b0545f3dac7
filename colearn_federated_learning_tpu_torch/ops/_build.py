"""Build a CUDA source of ``ops/csrc`` and load it.

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, in the repository's
``build/`` directory, and loaded with ``ctypes``. The library's name
carries a digest of the source and the flags, so an edited source is
rebuilt. The compiler's output (``-Xptxas -v``: registers, spills) is
kept beside the library as ``*.log``. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC}")


class _PendingBuild:
    """One running ``nvcc``; :meth:`finish` waits for it."""

    def __init__(self, source: Path, out: Path):
        self.source, self.out = source, out
        self.tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        self.cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(self.tmp),
                    str(source)]
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def finish(self) -> Path:
        stdout, stderr = self.proc.communicate()
        self.out.with_suffix(".log").write_text(
            " ".join(self.cmd) + "\n" + stdout + stderr)
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({self.proc.returncode}) on "
                               f"{self.source}:\n{stderr}")
        os.replace(self.tmp, self.out)
        return self.out


class CudaLibrary:
    """The library built from ``csrc/<source_name>``; ``bind`` sets the
    argument and return types of its C functions once it is loaded."""

    def __init__(self, source_name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source_name
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        digest = hashlib.sha1(self.source.read_bytes()
                              + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"libcolearn_{self.source.stem}_{digest[:12]}.so"

    def start_build(self) -> Optional[_PendingBuild]:
        """Start ``nvcc`` unless a build of this exact source exists."""
        out = self.path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return _PendingBuild(self.source, out)

    def build(self) -> Path:
        pending = self.start_build()
        return pending.finish() if pending is not None else self.path()

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            lib.colearn_cuda_error_string.argtypes = [ctypes.c_int]
            lib.colearn_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, rc: int, fn_name: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if rc != 0:
            msg = self.load().colearn_cuda_error_string(rc).decode()
            raise RuntimeError(f"{fn_name} launch failed: {msg} ({rc})")


def build_all(libraries: Sequence[CudaLibrary]) -> None:
    """Build every library not built yet, one ``nvcc`` each, in parallel."""
    pending = [p for p in (lib.start_build() for lib in libraries)
               if p is not None]
    errors = []
    for p in pending:
        try:
            p.finish()
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
