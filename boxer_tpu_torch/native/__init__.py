"""The native host runtime: the voxelizer, the BEV box collision test and
the COCO RLE counts in C++ (`voxelizer.cpp`, `rle.cpp`, copies of the JAX
package's sources) behind ctypes.

The library is built with g++ at first use, with the JAX package's
Makefile flags, into `build/native/<hash>/` beside the package, where the
hash covers the sources and the flags; importing this package builds
nothing. A missing compiler or a failed build raises with the compiler's
output: there is no fall back to numpy. The functions keep the contracts of
the numpy versions (`dataset/processor/voxelizer.py:points_to_voxel`,
`dataset/helper/database_sampler.py:box_collision_test`,
`utils/rle.py:mask_to_rle_counts`) and give the same results bitwise.
Nothing in the package calls them yet.
"""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent
SOURCES = ("voxelizer.cpp", "rle.cpp")
BUILD_ROOT = SRC.parent.parent / "build" / "native"
CXX = "g++"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]
_LIB_NAME = "libboxer_native.so"

_lib = None


def build() -> Path:
    """Compile the sources if this exact source set and flags are not built
    yet; returns the library's path. Raises if the compiler is missing or
    fails."""
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / _LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    # a build of its own per process, renamed into place: workers may build
    # at once
    tmp = out_dir / f".{_LIB_NAME}.{os.getpid()}"
    try:
        proc = subprocess.run([CXX, *CXXFLAGS, "-shared", "-o", str(tmp),
                               *(str(SRC / n) for n in SOURCES)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native: the compiler {CXX!r} was not found; the "
                           "native library needs g++") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native: {CXX} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64, i32 = ctypes.c_int64, ctypes.c_int
        lib.points_to_voxel.argtypes = [f32p, i64, i32, f32p, f32p, i32, i32,
                                        i32, f32p, i32p, i32p]
        lib.points_to_voxel.restype = i32
        lib.box_collision_test.argtypes = [f32p, i64, i32, f32p, i64, u8p]
        lib.box_collision_test.restype = None
        lib.mask_to_rle_counts.argtypes = [u8p, i64, i64,
                                           ctypes.POINTER(ctypes.c_uint32)]
        lib.mask_to_rle_counts.restype = i64
        _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def points_to_voxel_native(points: np.ndarray, voxel_size, pc_range,
                           max_points: int = 35, reverse: bool = True,
                           max_voxels: int = 20000
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`points_to_voxel` in C++: points (N, F>=3) -> (voxels (V,
    max_points, F) f32, coords (V, 3) int32, [z, y, x] if reverse,
    num_points_per_voxel (V,) int32)."""
    lib = library()
    points = np.ascontiguousarray(points, np.float32)
    vs = np.ascontiguousarray(voxel_size, np.float32)
    rng = np.ascontiguousarray(pc_range, np.float32)
    n, f = points.shape
    voxels = np.zeros((max_voxels, max_points, f), np.float32)
    coords = np.zeros((max_voxels, 3), np.int32)
    num_points = np.zeros((max_voxels,), np.int32)
    nv = lib.points_to_voxel(
        _ptr(points, ctypes.c_float), n, f, _ptr(vs, ctypes.c_float),
        _ptr(rng, ctypes.c_float), max_points, max_voxels, int(reverse),
        _ptr(voxels, ctypes.c_float), _ptr(coords, ctypes.c_int32),
        _ptr(num_points, ctypes.c_int32))
    return voxels[:nv], coords[:nv], num_points[:nv]


def box_collision_test_native(boxes: np.ndarray,
                              qboxes: np.ndarray) -> np.ndarray:
    """`box_collision_test` in C++: boxes (N, 7+), qboxes (M, 7+) with the
    heading last -> (N, M) bool, True where the BEV rectangles overlap."""
    lib = library()
    boxes = np.ascontiguousarray(boxes, np.float32)
    qboxes = np.ascontiguousarray(qboxes, np.float32)
    n, d = boxes.shape
    if qboxes.shape[1] != d:
        raise ValueError(f"box_collision_test_native: boxes of {d} and "
                         f"{qboxes.shape[1]} columns")
    out = np.zeros((n, len(qboxes)), np.uint8)
    lib.box_collision_test(_ptr(boxes, ctypes.c_float), n, d,
                           _ptr(qboxes, ctypes.c_float), len(qboxes),
                           _ptr(out, ctypes.c_uint8))
    return out.astype(bool)


def mask_to_rle_counts_native(mask: np.ndarray) -> List[int]:
    """`mask_to_rle_counts` in C++: a binary (H, W) mask -> its
    uncompressed COCO counts (column-major runs, starting with a run of
    0s)."""
    lib = library()
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    counts = np.zeros((h * w + 1,), np.uint32)
    n = lib.mask_to_rle_counts(_ptr(mask, ctypes.c_uint8), h, w,
                               _ptr(counts, ctypes.c_uint32))
    return counts[:n].tolist()
