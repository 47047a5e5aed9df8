"""K10, the pillar net's one-launch inference forward (`ops/pillar_net.py`),
and its routing in `nn/point_pillar.py:PillarFeatureNet`.

On the CPU the wrapper runs its plain version, which is the training path's
code, so the two agree bitwise; the wrapper's checks raise on what the
kernel is not built for (on the meta device, which reaches every check and
then the device's); a tiny BoxeR-3D's inference forward calls the wrapper
once and its training forward never.

The cases that need a card (marker `gpu`) hold the kernel against the plain
version on the card at the shipped config's widths (5 features, filters
64 and 128, the Waymo range and 0.32 m pillars): ragged pillar counts, 0,
1, 2 and 20 points a pillar, one-point pillars (near-constant groups), far
pillars at +-75 m, P 20 (the shipped config's) and 7 and 32, bf16 and f32
weights. The weights are bf16-exact, so the two types differ only in the
activations' rounding. A pillar's error is the relative norm of its
output's difference. f32 weights: 1e-4 (both sum in f32 in
another order). bf16: 1e-2, within the 2% that the bf16 pillar net keeps
of its f32 run (`test_torch_boxer3d_reference.py:
test_pillar_net_takes_raw_coordinates_in_f32`): both round layer 1's output
and their own to bf16, and the plain version rounds layer 2's product to
bf16 before the norm, where the kernel keeps it in f32; the kernel in bf16
is also held to the plain version in f32 at that 2%. Two launches are
bitwise equal. On a card without jax:
`python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_pillar_net.py`.
"""

import math

import numpy as np
import pytest
import torch

from boxer_tpu_torch.nn import point_pillar
from boxer_tpu_torch.ops import pillar_net
from boxer_tpu_torch.ops.pillar_net import (pillar_features,
                                            pillar_features_plain)
from boxer_tpu_torch.tools.bench_kernels import pillar_err

PC_RANGE = (-75.0, -75.0, -3.0, 75.0, 75.0, 5.0)
VOXEL = (0.32, 0.32, 8.0)
GRID = (469, 469)


def make_net(seed=3, filters=(64, 128), features=5):
    """The shipped reader's widths with bf16-exact seeded weights: kernels
    normal over sqrt(fan-in), norm weights and biases 1 + 0.1 normal."""
    net = point_pillar.PillarFeatureNet(features, filters, VOXEL, PC_RANGE)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            z = torch.randn(p.shape, generator=g)
            p.copy_((z / math.sqrt(p.shape[1]) if p.dim() == 2
                     else 1 + 0.1 * z).bfloat16().float())
    return net.eval()


def make_pillars(v, p, seed, far=False):
    """v pillars of p points on distinct cells of the 469x469 grid: counts
    one in five each 0, 1, 2 and p, the rest uniform in 1..p; points inside
    their cell, z about the ground, intensity and elongation in [0, 1),
    padding rows zero. With `far` every pillar lies more than 60 m out in x
    or y. Returns (features (V, P, 5) f32, num_voxels (V,) int32, coors
    (V, 4) int32 [b, z, y, x]), CPU tensors."""
    rs = np.random.RandomState(seed)
    nx, ny = GRID
    if far:
        edge = int(60.0 / VOXEL[0])
        cells = np.array([c for c in range(nx * ny)
                          if min(c % nx, nx - 1 - c % nx,
                                 c // nx, ny - 1 - c // nx) < nx // 2 - edge])
        cell = rs.choice(cells, v, replace=False)
    else:
        cell = rs.choice(nx * ny, v, replace=False)
    ix, iy = cell % nx, cell // nx
    kind = rs.randint(0, 5, v)
    n = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                  [0, 1, 2, p], rs.randint(1, p + 1, v)).astype(np.int32)
    x = (ix[:, None] + rs.rand(v, p)) * VOXEL[0] + PC_RANGE[0]
    y = (iy[:, None] + rs.rand(v, p)) * VOXEL[1] + PC_RANGE[1]
    feats = np.stack([x, y, rs.normal(0.0, 1.0, (v, p)), rs.rand(v, p),
                      rs.rand(v, p)], -1).astype(np.float32)
    feats[np.arange(p)[None, :] >= n[:, None]] = 0.0
    coors = np.stack([np.zeros(v), np.zeros(v), iy, ix], 1).astype(np.int32)
    return (torch.from_numpy(feats), torch.from_numpy(n),
            torch.from_numpy(coors))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_is_the_training_forward(dtype):
    """On the CPU the wrapper and the module's training path run the same
    code: bitwise equal, in f32 and in bf16 weights."""
    net = make_net().to(dtype)
    feats, n, coors = make_pillars(300, 20, seed=1)
    with torch.no_grad():
        want = net(feats, n, coors)
        got = pillar_features(feats, n, coors, VOXEL, PC_RANGE,
                              net.pfn_layers)
        routed = net(feats, n, coors, inference=True)
    assert got.shape == (300, 128) and got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(routed, want)
    assert torch.equal(got, pillar_features_plain(
        feats, n, coors, VOXEL, PC_RANGE, net.pfn_layers))
    assert (got[n == 0] == -1e9).all()


def _meta_case(change):
    """Arguments on the meta device (past every check but the device's),
    with one changed by `change`."""
    net = make_net().to("meta")
    args = dict(features=torch.empty(40, 20, 5, device="meta"),
                num_voxels=torch.empty(40, dtype=torch.int32, device="meta"),
                coors=torch.empty(40, 4, dtype=torch.int32, device="meta"),
                voxel_size=VOXEL, pc_range=PC_RANGE, layers=net.pfn_layers)
    change(args)
    return args


def _set(key, fn):
    return lambda a: a.__setitem__(key, fn(a))


UNSUPPORTED = {
    "device": (ValueError, lambda a: None),
    "bf16 points": (TypeError, _set("features", lambda a: a["features"].to(
        torch.bfloat16))),
    "33 points": (ValueError, _set("features", lambda a: torch.empty(
        40, 33, 5, device="meta"))),
    "4 features": (ValueError, _set("features", lambda a: torch.empty(
        40, 20, 4, device="meta"))),
    "int64 counts": (TypeError, _set("num_voxels", lambda a: a[
        "num_voxels"].long())),
    "short coors": (ValueError, _set("coors", lambda a: a["coors"][:39])),
    "strided points": (ValueError, _set("features", lambda a: torch.empty(
        40, 20, 10, device="meta")[..., ::2])),
    "filters 32, 64": (ValueError, _set("layers", lambda a: make_net(
        filters=(32, 64)).to("meta").pfn_layers)),
    "three layers": (ValueError, _set("layers", lambda a: make_net(
        filters=(64, 64, 128)).to("meta").pfn_layers)),
    "f16 weights": (TypeError, _set("layers", lambda a: make_net().to(
        "meta", torch.float16).pfn_layers)),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_wrapper_raises_on_unsupported_arguments(case):
    """Each thing the kernel is not built for raises before a launch: the
    device (neither CPU nor CUDA), the points' dtype, P above 32, other
    than 5 features, counts or coordinates not int32 or of another length,
    strided points, other filters or layer counts, f16 weights."""
    err, change = UNSUPPORTED[case]
    before = pillar_features.launches
    with pytest.raises(err):
        pillar_features(**_meta_case(change))
    assert pillar_features.launches == before


def test_wrapper_raises_on_mixed_weight_dtypes():
    net = make_net().to("meta")
    net.pfn_layers[1].norm.to(torch.bfloat16)
    args = _meta_case(lambda a: None)
    with pytest.raises(ValueError, match="one dtype"):
        pillar_features(**dict(args, layers=net.pfn_layers))


def test_inference_forward_calls_pillar_features_once(monkeypatch):
    """A tiny BoxeR-3D on the CPU: its inference forward reaches the
    pillar net through `pillar_features` once, its training-path forward
    (inference=False) never; the outputs match the unpatched model's."""
    from boxer_tpu_torch.models.boxer3d import BoxeR3D

    backbone = {"type": "pointpillar", "params": {
        "hidden_dim": 32, "position_encoding": "fixed", "ref_size": 4,
        "return_layers": 2,
        "reader": {"num_input_features": 5, "num_filters": [16, 32],
                   "voxel_size": [0.32, 0.32, 6.0],
                   "pc_range": [-5.12, -5.12, -3.0, 5.12, 5.12, 3.0]},
        "neck": {"num_layers": [1, 1, 1], "ds_strides": [1, 2, 2],
                 "ds_filters": [32, 64, 64]}}}
    model = BoxeR3D(num_classes=2, hidden_dim=32, nhead=8, num_level=2,
                    enc_layers=1, dec_layers=1, dim_feedforward=64,
                    num_queries=8, backbone_cfg=backbone).init_weights(0)
    rs = np.random.RandomState(4)
    v, p = 48, 4
    cells = np.concatenate([rs.choice(32 * 32, v // 2, replace=False)
                            for _ in range(2)])
    n = rs.randint(0, p + 1, v).astype(np.int32)
    vox = rs.randn(v, p, 5).astype(np.float32)
    vox[np.arange(p)[None, :] >= n[:, None]] = 0.0
    coors = np.stack([np.repeat([0, 1], v // 2), np.zeros(v), cells // 32,
                      cells % 32], 1).astype(np.int32)
    args = (torch.from_numpy(vox), torch.from_numpy(coors),
            torch.from_numpy(n), (32, 32), 2)
    with torch.no_grad():
        want = model(*args, inference=True)["pred_logits"]
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return pillar_net.pillar_features(*a, **kw)

    monkeypatch.setattr(point_pillar, "pillar_features", counted)
    with torch.no_grad():
        got = model(*args, inference=True)["pred_logits"]
        assert calls == [(v, p, 5)]
        model(*args, inference=False)
    assert len(calls) == 1
    assert torch.equal(got, want)


# the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K10 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("v,p,far", [(1237, 20, False), (20011, 20, False),
                                     (1237, 20, True), (613, 7, False),
                                     (613, 32, True)])
def test_kernel_matches_plain(cuda, v, p, far, dtype):
    net = make_net().to(cuda, dtype)
    args = [t.to(cuda) for t in make_pillars(v, p, seed=v + p, far=far)]
    layers = net.pfn_layers
    with torch.no_grad():
        before = pillar_features.launches
        got = pillar_features(*args, VOXEL, PC_RANGE, layers)
        again = pillar_features(*args, VOXEL, PC_RANGE, layers)
        torch.cuda.synchronize()
        assert pillar_features.launches == before + 2
        want = pillar_features_plain(*args, VOXEL, PC_RANGE, layers)
        exact = pillar_features_plain(*args, VOXEL, PC_RANGE,
                                      make_net().to(cuda).pfn_layers)
    assert got.shape == (v, 128) and got.dtype == dtype and got.is_cuda
    assert got.grad_fn is None
    assert torch.equal(got, again)
    n = args[1]
    assert (got[n == 0] == torch.tensor(-1e9, dtype=dtype)).all()
    assert bool(torch.isfinite(got.float()).all())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert pillar_err(got, want) <= tol
    assert pillar_err(got, exact) <= (2e-2 if dtype == torch.bfloat16
                                      else 1e-4)


@pytest.mark.gpu
def test_one_point_pillars_on_card(cuda):
    """Every pillar of one point, where layer 1's groups hold one value
    and P - 1 zeros and layer 2's rows but the first repeat the max."""
    net = make_net().to(cuda, torch.bfloat16)
    feats, n, coors = make_pillars(2000, 20, seed=9)
    n = torch.ones_like(n)
    feats[:, 1:] = 0.0
    args = [t.to(cuda) for t in (feats, n, coors)]
    with torch.no_grad():
        got = pillar_features(*args, VOXEL, PC_RANGE, net.pfn_layers)
        want = pillar_features_plain(*args, VOXEL, PC_RANGE, net.pfn_layers)
    assert pillar_err(got, want) <= 1e-2


@pytest.mark.gpu
def test_inference_forward_routes_to_kernel_on_card(cuda):
    """`PillarFeatureNet.forward(inference=True)` on a CUDA tensor launches
    K10 once; inference=False launches nothing and keeps autograd."""
    net = make_net().to(cuda, torch.bfloat16)
    args = [t.to(cuda) for t in make_pillars(500, 20, seed=5)]
    before = pillar_features.launches
    with torch.no_grad():
        net(*args, inference=True)
    assert pillar_features.launches == before + 1
    out = net(*args)
    assert pillar_features.launches == before + 1
    assert out.grad_fn is not None
