"""Build and load the hand-written CUDA kernels.

The sources under ``kernels/csrc/`` have a plain C interface; ``nvcc``
compiles each ``.cu`` file for ``sm_90a`` to an object, all of them at
once in parallel, and links the objects into one shared library, loaded
with ``ctypes``.  The build happens at first use, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), and the library
file is named by a hash of the sources and flags, so an edit rebuilds it.
There is no prebuilt library and no fallback: without ``nvcc`` the build
raises.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of each entry point, in the order of its csrc/*.cu file
SIGNATURES = {
    # csrc/bgmv.cu
    "bgmv_matmul_launch": (_P,) * 7 + (_I,) * 6 + (_P,),
    "bgmv_gemv_launch": (_P,) * 8 + (_I,) * 7 + (_P,),
    "bgmv_matmul_quant_launch": (_P,) * 8 + (_I,) * 9 + (_P,),
    "bgmv_gemv_quant_launch": (_P,) * 9 + (_I,) * 10 + (_P,),
    # csrc/lora_matmul.cu
    "lora_fwd_launch": (_P,) * 6 + (_I,) * 4 + (_F, _I, _P),
    "lora_bwd_dx_launch": (_P,) * 6 + (_I,) * 4 + (_F, _I, _P),
    "lora_bwd_da_launch": (_P,) * 4 + (_I,) * 5 + (_F, _I, _P),
    "lora_bwd_db_launch": (_P,) * 4 + (_I,) * 5 + (_F, _I, _P),
    "quant_matmul_launch": (_P,) * 5 + (_I,) * 9 + (_P,),
    "lora_fwd_quant_launch": (_P,) * 7 + (_I,) * 4 + (_F,) + (_I,) * 4 + (_P,),
    "lora_bwd_dx_quant_launch": (_P,) * 7 + (_I,) * 4 + (_F,) + (_I,) * 4
    + (_P,),
    "quant_matmul_dx_launch": (_P,) * 4 + (_I,) * 7 + (_P,),
    # csrc/paged_attention.cu
    "paged_attention_launch": (_P,) * 7 + (_I,) * 8 + (_F, _F, _I, _P),
}

_lib = None


def _sources() -> list:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists: one nvcc
    per ``.cu`` file, all started together, then one link.  The compiler's
    report (registers, shared memory, spills per kernel) is kept beside the
    library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            procs.append((src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for name, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = os.path.join(tmpdir, out.name)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
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
