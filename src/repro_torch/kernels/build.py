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
import time
from concurrent.futures import ThreadPoolExecutor
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
    "bgmv_matmul_launch": (_P,) * 8 + (_I,) * 10 + (_P,),
    "bgmv_gemv_launch": (_P,) * 8 + (_I,) * 7 + (_P,),
    "bgmv_matmul_quant_launch": (_P,) * 9 + (_I,) * 13 + (_P,),
    "bgmv_gemv_quant_launch": (_P,) * 9 + (_I,) * 10 + (_P,),
    # csrc/lora_matmul.cu
    "lora_fwd_launch": (_P,) * 7 + (_I,) * 8 + (_F, _I, _P),
    "quant_matmul_launch": (_P,) * 5 + (_I,) * 9 + (_P,),
    "lora_fwd_quant_launch": (_P,) * 8 + (_I,) * 8 + (_F,) + (_I,) * 4 + (_P,),
    # csrc/lora_grads.cu
    "lora_bwd_da_launch": (_P,) * 3 + (_I,) * 5 + (_F, _I, _P),
    "lora_bwd_db_launch": (_P,) * 3 + (_I,) * 5 + (_F, _I, _P),
    "lora_grads_max_clusters": (_I,),
    # csrc/dense_dx.cu
    "lora_bwd_dx_launch": (_P,) * 7 + (_I,) * 8 + (_F, _I, _P),
    # csrc/packed_dx.cu
    "lora_bwd_dx_quant_launch": (_P,) * 8 + (_I,) * 8 + (_F,) + (_I,) * 4
    + (_P,),
    "quant_matmul_dx_launch": (_P,) * 5 + (_I,) * 9 + (_P,),
    # csrc/paged_attention.cu
    "paged_attention_launch": (_P,) * 8 + (_I,) * 11 + (_F, _F, _I, _P),
    # csrc/rglru_scan.cu
    "rglru_scan_launch": (_P,) * 3 + (_I,) * 4 + (_P,),
    "rglru_scan_bwd_launch": (_P,) * 5 + (_I,) * 4 + (_P,),
    # csrc/flash_attention.cu
    "flash_attention_launch": (_P,) * 4 + (_I,) * 7 + (_F, _I, _P),
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


def _compile(src: Path, obj: str):
    """(name, seconds, returncode, output) of one nvcc of ``src``."""
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    return src.name, time.monotonic() - t0, proc.returncode, proc.stdout


def build() -> Path:
    """Compile the sources unless the library for them exists: one nvcc
    per ``.cu`` file, all started together, then one link.  The compiler's
    report (registers, shared memory, spills per kernel) and each file's
    compile time are kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        srcs = [src for src in _sources() if src.suffix == ".cu"]
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in srcs]
        with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
            done = list(pool.map(_compile, srcs, objs))
        log, failed = [], []
        for name, seconds, rc, text in done:
            log.append(f"== {name} ({seconds:.1f} s)\n{text}")
            if rc != 0:
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
