"""Build and load the port's CUDA kernels.

`csrc/*.cu` is compiled with `nvcc` for Hopper (`sm_90a`), one `nvcc -c`
per source, all started together, and linked into one shared library with a
plain C interface, loaded with `ctypes`. The build runs at first use, into
`build/kernels/<hash>/` beside the package, where the hash covers the
sources and the flags, so a changed source rebuilds. Importing this module
needs no `nvcc` and no card; only `library()` does.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of `csrc` (by default the package's) if this
    exact source set is not built yet; returns the library's path."""
    global build_log
    sources = sorted(Path(csrc).glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}"
    objs = [out_dir / f".{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    build_log = "".join(logs)
    failed = [src.name for src, proc in zip(sources, procs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out_dir / f".{_LIB_NAME}.{tag}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    build_log += proc.stdout + proc.stderr
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{build_log}")
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
                                           i32, i32, vp, i32, i32, vp]
        lib.quad_sample_reduce.restype = i32
        lib.flash_attention_fwd.argtypes = [i32, vp, vp, vp, vp, vp, i32, i32,
                                            i32, i32, i32, ctypes.c_float, vp]
        lib.flash_attention_fwd.restype = i32
        lib.scatter_accum.argtypes = [i32, vp, vp, i32, i32, vp, vp, i64, vp,
                                      i32, vp, i32, i32, vp]
        lib.scatter_accum.restype = i32
        lib.scatter_rows_scratch_words.argtypes = [i64, i32]
        lib.scatter_rows_scratch_words.restype = i64
        lib.scatter_rows_segmented.argtypes = [i32, vp, vp, i32, vp, i64, i32,
                                               vp, vp]
        lib.scatter_rows_segmented.restype = i32
        lib.hungarian_scratch_bytes.argtypes = [i64, i32, i32, i32]
        lib.hungarian_scratch_bytes.restype = i64
        lib.hungarian_max_active_clusters.argtypes = [i32, i32, i32, i32]
        lib.hungarian_max_active_clusters.restype = i32
        lib.hungarian_solve.argtypes = [i32, vp, vp, vp, i64, i32, i32, i32,
                                        vp, vp, vp]
        lib.hungarian_solve.restype = i32
        lib.instance_sample_reduce.argtypes = [
            i32, i32, vp, vp, vp, vp, ctypes.POINTER(i32), i32, vp, vp, vp,
            vp, vp, vp, i32, i32, i32, i32, vp]
        lib.instance_sample_reduce.restype = i32
        lib.instance_sample_tile.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
        lib.instance_sample_tile.restype = i32
        strides = ctypes.POINTER(i64)
        lib.box_sample_reduce.argtypes = [
            i32, i32, vp, ctypes.POINTER(i32), i32, vp, strides, vp, strides,
            vp, strides, vp, i32, i32, i32, i32, i32, vp]
        lib.box_sample_reduce.restype = i32
        _lib = lib
    return _lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
