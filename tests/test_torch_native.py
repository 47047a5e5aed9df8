"""The port's native runtime (`boxer_tpu_torch/native`: the C++ voxelizer,
BEV collision test and RLE counts, built with g++ at first use) bitwise
against the port's numpy versions and the JAX package's, on the cases of
`tests/test_voxelizer.py:62-99`; its build raises without a compiler or on
a failed compile; importing it builds nothing, and the JAX package's
prebuilt library is never loaded.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from boxer_tpu.dataset.helper.database_sampler import \
    box_collision_test as jax_box_collision_test
from boxer_tpu.dataset.processor.voxelizer import \
    points_to_voxel as jax_points_to_voxel
from boxer_tpu.utils.rle import mask_to_rle_counts as jax_mask_to_rle_counts

from boxer_tpu_torch import native
from boxer_tpu_torch.dataset.helper.database_sampler import box_collision_test
from boxer_tpu_torch.dataset.processor.voxelizer import points_to_voxel
from boxer_tpu_torch.utils.rle import mask_to_rle_counts

ROOT = Path(__file__).resolve().parents[1]
VOXEL_SIZE = (0.32, 0.32, 6.0)
PC_RANGE = (-5.12, -5.12, -3.0, 5.12, 5.12, 3.0)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("seed,n,max_points,max_voxels",
                         [(3, 5000, 8, 2000), (0, 2000, 5, 1000),
                          (1, 2000, 3, 50), (2, 2000, 5, 1000)])
def test_voxelizer_is_bitwise_numpy(seed, n, max_points, max_voxels):
    pts = np.random.RandomState(seed).uniform(-6, 6, (n, 5)).astype(
        np.float32)
    got = native.points_to_voxel_native(pts, VOXEL_SIZE, PC_RANGE,
                                        max_points=max_points,
                                        max_voxels=max_voxels)
    kw = dict(max_points=max_points, max_voxels=max_voxels)
    _equal(got, points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, **kw))
    _equal(got, jax_points_to_voxel(pts, VOXEL_SIZE, PC_RANGE, **kw))
    assert len(got[0]) > 0


def _boxes(rng, n):
    return np.concatenate([
        rng.uniform(-10, 10, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(1, 4, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], axis=1).astype(np.float32)


@pytest.mark.parametrize("n,m", [(12, 9), (60, 40)])
def test_collision_is_bitwise_numpy(n, m):
    rng = np.random.RandomState(0)
    boxes, qboxes = _boxes(rng, n), _boxes(rng, m)
    got = native.box_collision_test_native(boxes, qboxes)
    want = box_collision_test(boxes, qboxes)
    assert got.dtype == want.dtype == bool and 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_box_collision_test(boxes, qboxes))


@pytest.mark.parametrize("shape,p", [((37, 53), 0.6), ((64, 48), 0.02)])
def test_rle_is_bitwise_numpy(shape, p):
    mask = np.random.RandomState(1).rand(*shape) > p
    got = native.mask_to_rle_counts_native(mask)
    assert got == mask_to_rle_counts(mask) == jax_mask_to_rle_counts(mask)
    assert native.mask_to_rle_counts_native(np.ones((3, 2), bool)) == [0, 6]


def test_a_missing_or_failing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    monkeypatch.undo()
    for name in native.SOURCES:
        (tmp_path / name).write_text("int broken(\n")
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()


def test_import_builds_nothing_and_the_jax_library_is_never_loaded():
    """In a fresh process: importing the package runs no compiler; a call
    builds or loads the port's own library under build/native/, and the
    JAX package's libboxer_native.so is not mapped."""
    code = (
        "import subprocess\n"
        "real = subprocess.run\n"
        "def boom(*a, **k): raise AssertionError('a compiler ran')\n"
        "subprocess.run = boom\n"
        "import boxer_tpu_torch.native as n\n"
        "assert n._lib is None\n"
        "subprocess.run = real\n"
        "import numpy as np\n"
        "assert n.mask_to_rle_counts_native(np.eye(3, dtype=bool)) == "
        "[0, 1, 3, 1, 3, 1]\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'build/native/' in maps, 'the port library is not mapped'\n"
        "assert 'boxer_tpu/native' not in maps\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert native.build().parent.parent == ROOT / "build" / "native"
