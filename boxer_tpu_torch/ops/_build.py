"""Build and load the port's CUDA kernels.

`csrc/*.cu` is compiled with `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, and loaded with `ctypes`. The build runs at
first use, into `build/kernels/<hash>/` beside the package, where the hash
covers the sources and the flags, so a changed source rebuilds. Importing
this module needs no `nvcc` and no card; only `library()` does.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIB_NAME = "libboxer_kernels.so"

_lib = None
build_log = ""          # nvcc's output (with -Xptxas -v) from the last build


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build() -> Path:
    """Compile the kernels if this exact source set is not built yet;
    returns the library's path."""
    global build_log
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # the library links its own CUDA runtime, so each call names its card
        lib.quad_sample_reduce.argtypes = [i32, vp, i32, i64, vp, vp, vp, vp,
                                           i32, vp, i32, i32, vp]
        lib.quad_sample_reduce.restype = i32
        lib.flash_attention_fwd.argtypes = [i32, vp, vp, vp, vp, vp, i32, i32,
                                            i32, i32, i32, ctypes.c_float, vp]
        lib.flash_attention_fwd.restype = i32
        _lib = lib
    return _lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
