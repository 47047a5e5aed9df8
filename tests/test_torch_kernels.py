"""The port's kernels (boxer_tpu_torch/ops) against the JAX package's Pallas
kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in the TPU interpret mode (as tests/test_flash_attention.py
does), with the gathered rows `g = table[idx]` taken in numpy. Both
accumulate in f32 and differ only in summation order: rel err <= 1e-5.

The cases that compare a CUDA kernel with its plain version need a card
(marker `gpu`) and skip without one. jax is imported only inside the JAX
cases, so on a card without jax they run with
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_kernels.py`.
"""

import numpy as np
import pytest
import torch

from boxer_tpu_torch.ops.combine_reduce import (quad_sample_reduce_plain,
                                                quad_sample_reduce_raw,
                                                quad_sample_reduce_w4)
from boxer_tpu_torch.ops.flash_attention import (NEG_INF, flash_attention,
                                                 flash_attention_plain)

RTOL = 1e-5


def _rel_err(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1e-6, np.abs(b).max())


@pytest.fixture()
def interp():
    """Pallas interpret mode, with the combine kernels' build caches
    cleared so no interpret-mode callable outlives the test."""
    from jax.experimental.pallas import tpu as pltpu

    import boxer_tpu.ops.pallas.combine_reduce as cr

    caches = (cr._build_call, cr._build_call_onepass,
              cr._build_call_onepass_raw)
    for f in caches:
        f.cache_clear()
    with pltpu.force_tpu_interpret_mode():
        yield cr
    for f in caches:
        f.cache_clear()


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _quad_case(p, m, rows, seed):
    rs = np.random.RandomState(seed)
    table = rs.randn(rows, 128).astype(np.float32)
    idx = rs.randint(0, rows, size=(p, m)).astype(np.int32)
    lx, ly, wt = rs.rand(3, p, m).astype(np.float32)
    w4 = rs.rand(p, 4, m).astype(np.float32)
    return table, idx, lx, ly, wt, w4


def _flash_case(bh, lq, lkv, d, masked, seed):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(bh, n, d).astype(np.float32) * 0.5
               for n in (lq, lkv, lkv))
    mask = (np.where(rs.rand(bh, lkv) < 0.2, NEG_INF, 0.0).astype(np.float32)
            if masked else None)
    return q, k, v, mask


def test_k1_raw_matches_pallas(interp):
    """K1: P=4 raw weights, M=3000 (not a multiple of the 2048 block)."""
    import jax.numpy as jnp

    p, m = 4, 3000
    table, idx, lx, ly, wt, _ = _quad_case(p, m, rows=700, seed=0)
    g = table[idx.reshape(-1)]
    want = interp.fused_combine_reduce_raw(
        jnp.asarray(g), jnp.asarray(lx), jnp.asarray(ly), jnp.asarray(wt), p, m)
    got = quad_sample_reduce_raw(torch.from_numpy(table), torch.from_numpy(idx),
                                 torch.from_numpy(lx), torch.from_numpy(ly),
                                 torch.from_numpy(wt))
    assert got.shape == (m, 32) and got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("p", [196, 16])
def test_k2_w4_matches_pallas(interp, p):
    """K2: precomputed corner weights; P > 8 takes the accumulator-carry
    Pallas kernel."""
    import jax.numpy as jnp

    m = 600
    table, idx, _, _, _, w4 = _quad_case(p, m, rows=900, seed=p)
    g = table[idx.reshape(-1)]
    want = interp.fused_combine_reduce(jnp.asarray(g), jnp.asarray(w4), p, m)
    got = quad_sample_reduce_w4(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(w4))
    assert _rel_err(got.numpy(), want) <= RTOL


@pytest.mark.parametrize("masked", [False, True])
def test_k3_matches_pallas(masked):
    """K3 at the decoder's shape (BH=8, L=300, D=32)."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from boxer_tpu.ops.pallas import flash_attention as fa

    q, k, v, mask = _flash_case(8, 300, 300, 32, masked, seed=int(masked))
    with pltpu.force_tpu_interpret_mode():
        want = fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  None if mask is None else jnp.asarray(mask))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          None if mask is None else torch.from_numpy(mask))
    assert _rel_err(got.numpy(), np.asarray(want)) <= RTOL


def test_cpu_tensors_take_the_plain_version_only():
    """A CPU call launches nothing; a device that is neither CPU nor CUDA
    raises instead of falling back."""
    table, idx, lx, ly, wt, w4 = (torch.from_numpy(a)
                                  for a in _quad_case(2, 10, 50, seed=3))
    wrappers = (quad_sample_reduce_raw, quad_sample_reduce_w4, flash_attention)
    launches = [f.launches for f in wrappers]
    quad_sample_reduce_raw(table, idx, lx, ly, wt)
    quad_sample_reduce_w4(table, idx, w4)
    flash_attention(table[None, :8, :32], table[None, :8, :32],
                    table[None, :8, :32])
    assert [f.launches for f in wrappers] == launches
    meta = [t.to("meta") for t in (table, idx, lx, ly, wt, w4)]
    with pytest.raises(ValueError):
        quad_sample_reduce_raw(*meta[:5])
    with pytest.raises(ValueError):
        quad_sample_reduce_w4(meta[0], meta[1], meta[5])
    with pytest.raises(ValueError):
        flash_attention(*(table[None, :8, :32].to("meta"),) * 3)
    with pytest.raises(IndexError):
        quad_sample_reduce_w4(table, idx + 50, w4)


@pytest.mark.gpu
@pytest.mark.parametrize("raw", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quad_sample_reduce_cuda_matches_plain(cuda, raw, dtype):
    p = 4 if raw else 196
    m = 2400 + 3
    table, idx, lx, ly, wt, w4 = (torch.from_numpy(a).to(cuda)
                                  for a in _quad_case(p, m, 5000, seed=7))
    table = table.to(dtype)
    wrapper = quad_sample_reduce_raw if raw else quad_sample_reduce_w4
    before = wrapper.launches
    if raw:
        got = wrapper(table, idx, lx, ly, wt)
        want = quad_sample_reduce_plain(table, idx, lx=lx, ly=ly, wt=wt)
    else:
        got = wrapper(table, idx, w4)
        want = quad_sample_reduce_plain(table, idx, w4=w4)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert _rel_err(got.cpu().numpy(), want.cpu().numpy()) <= RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_flash_attention_cuda_matches_plain(cuda, masked, dtype, rtol):
    q, k, v, mask = _flash_case(8, 300, 257, 32, masked, seed=5)
    q, k, v = (torch.from_numpy(a).to(cuda, dtype) for a in (q, k, v))
    mask = None if mask is None else torch.from_numpy(mask).to(cuda)
    got = flash_attention(q, k, v, mask)
    want = flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel_err(got.float().cpu().numpy(),
                    want.float().cpu().numpy()) <= rtol
