"""Build and load the hand-written CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface; ``nvcc``
compiles them for ``sm_90a`` into one shared library, loaded with
``ctypes``.  The build happens at first use, into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), and the library file is
named by a hash of the sources and flags, so an edit rebuilds it.  There is
no prebuilt library and no fallback: without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each entry point, in the order of csrc/bgmv.cu
SIGNATURES = {
    "bgmv_matmul_launch": (_P,) * 7 + (_I,) * 6 + (_P,),
    "bgmv_gemv_launch": (_P,) * 8 + (_I,) * 7 + (_P,),
}

_lib = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the BGMV kernels build only where the CUDA "
            "toolkit is installed (PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libbgmv_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists.  The
    compiler's report (registers, shared memory, spills per kernel) is kept
    beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *cu],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and cached per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
