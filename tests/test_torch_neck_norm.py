"""K11, the BEV neck's GroupNorm + ReLU at inference
(`ops/group_norm.py`), and its routing in `nn/backbone3d.py:ConvNet`.

On the CPU: the plain version against torch's `nn.GroupNorm(32, C)` and
ReLU on the NCHW tensor (f32 1e-5; bf16 1e-2, each rounds its f32 result
once, from sums in another order), and the wrapper on a CPU tensor is the
plain version; the wrapper's checks raise on what the kernel does not take
(on the CPU and on the meta device, which passes every check but the
device's); the inference neck on a CPU tensor against the training neck
(the same convolutions in another layout: 1e-5) with NHWC-contiguous
levels; a tiny BoxeR-3D's inference forward calls the wrapper once a
convolution, each call in its own `boxer.neck.norm` span, and its training
forward never.

The cases that need a card (marker `gpu`) hold the kernel against the
plain version on the card: the pp3d.infer_b4 cell's three shapes (batch 4:
256 x 469 x 469, 512 x 235 x 235, 1024 x 118 x 118) in bf16 (1e-2: one
bf16 rounding each) with two launches bitwise equal, a small odd shape in
bf16 and f32 (f32 1e-5), groups of mean 50 and spread 1 against the plain
version in float64 (1e-5 in f32: the variance must not cancel), the types
under bf16 autocast with f32 weights (f32 out, as torch's route gives),
and the inference neck on the card: 8 launches under 8 `boxer.neck.norm`
spans for the shipped 2 + 4 + 2 convolutions, and none of torch's
GroupNorm or cuDNN's layout transposes inside `boxer.neck`. On a card
without jax: `python -m pytest --noconftest -p no:cacheprovider -m gpu
tests/test_torch_neck_norm.py`.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)

import pytest
import torch
from torch import nn

from boxer_tpu_torch.nn import backbone3d
from boxer_tpu_torch.nn.backbone3d import ConvNet
from boxer_tpu_torch.ops import group_norm as gn
from boxer_tpu_torch.ops.group_norm import (group_norm_relu,
                                            group_norm_relu_plain)

EPS = 1e-6
# the pp3d.infer_b4 cell's eight calls: (C, H, W) x calls, batch 4
CELL_SHAPES = ((256, 469, 469), (512, 235, 235), (1024, 118, 118))
CELL_BATCH = 4


def rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def make_case(b, h, w, c, dtype=torch.float32, wdtype=None, seed=0,
              mean=0.5, std=2.0, device="cpu"):
    """x (B, H, W, C) with per-channel offsets about `mean`, weight 1 + 0.1
    normal, bias 0.1 normal, made in f32 on `device` from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x = (mean + std * randn(b, h, w, c) + 0.2 * randn(c)).to(dtype)
    wdtype = wdtype or dtype
    return x, (1 + 0.1 * randn(c)).to(wdtype), (0.1 * randn(c)).to(wdtype)


def torch_route(x, weight, bias):
    """torch's GroupNorm(32, C) and ReLU on the NCHW tensor, back to NHWC."""
    norm = nn.GroupNorm(32, x.shape[3], eps=EPS).to(x.device, weight.dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
        y = torch.relu(norm(x.permute(0, 3, 1, 2).contiguous()))
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 256, 1024])
def test_plain_is_torch_group_norm_relu(c, dtype):
    x, weight, bias = make_case(2, 9, 7, c, dtype, seed=c)
    want = torch_route(x, weight, bias)
    got = group_norm_relu_plain(x, weight, bias, EPS)
    assert got.shape == x.shape and got.dtype == dtype
    assert rel_err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)
    assert torch.equal(group_norm_relu(x, weight, bias, EPS), got)
    assert (got >= 0).all() and (got == 0).any()


def test_plain_under_f32_weights_returns_f32():
    """bf16 x with f32 weights (a bf16 convolution under autocast): f32."""
    x, weight, bias = make_case(1, 5, 6, 64, torch.bfloat16, torch.float32)
    got = group_norm_relu(x, weight, bias, EPS)
    assert got.dtype == torch.float32
    assert rel_err(got, torch_route(x.float(), weight, bias)) <= 1e-5


def _set(key, fn):
    return lambda a: a.__setitem__(key, fn(a))


UNSUPPORTED = {
    "C 48": (ValueError, _set("x", lambda a: torch.randn(1, 4, 4, 48))),
    "C 1056": (ValueError, _set("x", lambda a: torch.randn(1, 2, 2, 1056))),
    "NCHW": (ValueError, _set("x", lambda a: torch.randn(
        1, 64, 4, 5).permute(0, 2, 3, 1))),
    "3 dims": (ValueError, _set("x", lambda a: a["x"][0])),
    "empty": (ValueError, _set("x", lambda a: a["x"][:, :0])),
    "short weight": (ValueError, _set("weight", lambda a: a["weight"][:32])),
    "mixed weight and bias": (TypeError, _set("bias", lambda a: a[
        "bias"].bfloat16())),
    "f32 x, bf16 weights": (TypeError, lambda a: a.update(
        weight=a["weight"].bfloat16(), bias=a["bias"].bfloat16())),
    "f16 x": (TypeError, _set("x", lambda a: a["x"].half())),
    "strided weight": (ValueError, _set("weight", lambda a: torch.randn(
        128)[::2])),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_wrapper_raises_on_unsupported_arguments(case):
    """Each thing the kernel does not take raises, on a CPU tensor too: C
    not a multiple of 32 or above 1024, x not NHWC-contiguous, not 4-D or
    empty, a weight of another length or strided, mixed types (weight and
    bias, or bf16 weights on f32 x), f16."""
    err, change = UNSUPPORTED[case]
    x, weight, bias = make_case(1, 4, 5, 64)
    args = dict(x=x, weight=weight, bias=bias)
    change(args)
    before = group_norm_relu.launches
    with pytest.raises(err):
        group_norm_relu(**args, eps=EPS)
    assert group_norm_relu.launches == before


def test_wrapper_raises_on_other_devices():
    """The meta device passes every check but the device's."""
    x, weight, bias = (t.to("meta") for t in make_case(1, 4, 5, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        group_norm_relu(x, weight, bias, EPS)


def test_tiles_cover_each_frame():
    """Tiles a frame at the cell's shapes on 132 SMs, 2 blocks an SM, and
    on frames of few rows."""
    for _, h, w in CELL_SHAPES:
        assert gn.tiles(132, CELL_BATCH, h * w) == 66
    assert gn.tiles(132, 1, 63) == 1
    assert gn.tiles(132, 16, 32 * 40) == 17
    assert gn.tiles(132, 1, 20) == 1


def make_neck(in_channels=16, num_layers=(1, 2, 1),
              filters=(32, 64, 64), seed=0):
    net = ConvNet(in_channels, num_layers, (1, 2, 2), filters)
    net.reset_parameters_(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 1:
                p.copy_((1.0 if name.endswith("weight") else 0.0)
                        + 0.1 * torch.randn(p.shape, generator=gen))
    return net.eval()


def test_inference_neck_is_the_training_neck_on_cpu():
    """The same convolutions channels-last and the plain version against
    the modules: 1e-5, every level NHWC-contiguous."""
    net = make_neck()
    canvas = torch.randn(2, 15, 17, 16, generator=torch.Generator()
                         .manual_seed(3))
    with torch.no_grad():
        want = net(canvas.permute(0, 3, 1, 2))
        got = net(canvas.permute(0, 3, 1, 2), inference=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.permute(0, 2, 3, 1).is_contiguous()
        assert rel_err(g, w) <= 1e-5


def tiny_boxer3d():
    from boxer_tpu_torch.models.boxer3d import BoxeR3D

    backbone = {"type": "pointpillar", "params": {
        "hidden_dim": 32, "position_encoding": "fixed", "ref_size": 4,
        "return_layers": 2,
        "reader": {"num_input_features": 5, "num_filters": [16, 32],
                   "voxel_size": [0.32, 0.32, 6.0],
                   "pc_range": [-5.12, -5.12, -3.0, 5.12, 5.12, 3.0]},
        "neck": {"num_layers": [2, 4, 2], "ds_strides": [1, 2, 2],
                 "ds_filters": [32, 64, 64]}}}
    model = BoxeR3D(num_classes=2, hidden_dim=32, nhead=8, num_level=2,
                    enc_layers=1, dec_layers=1, dim_feedforward=64,
                    num_queries=8, backbone_cfg=backbone).init_weights(0)
    gen = torch.Generator().manual_seed(4)
    v, p = 48, 4
    cells = torch.cat([torch.randperm(32 * 32, generator=gen)[:v // 2]
                       for _ in range(2)])
    n = torch.randint(0, p + 1, (v,), generator=gen, dtype=torch.int32)
    vox = torch.randn(v, p, 5, generator=gen)
    vox[torch.arange(p)[None, :] >= n[:, None]] = 0.0
    coors = torch.stack([torch.arange(2).repeat_interleave(v // 2),
                         torch.zeros(v, dtype=torch.long), cells // 32,
                         cells % 32], 1).int()
    return model, (vox, coors, n, (32, 32), 2)


def test_inference_forward_calls_group_norm_relu_once_a_conv(monkeypatch):
    """A tiny BoxeR-3D with the shipped neck's 2 + 4 + 2 convolutions on
    the CPU: its inference forward reaches each GroupNorm + ReLU through
    `group_norm_relu` (8 calls, each in a `boxer.neck.norm` span of its
    own), its training forward never; the outputs match the unpatched
    model's."""
    from torch.profiler import ProfilerActivity, profile

    model, args = tiny_boxer3d()
    with torch.no_grad():
        want = model(*args, inference=True)["pred_logits"]
    calls = []

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return gn.group_norm_relu(*a, **kw)

    monkeypatch.setattr(backbone3d, "group_norm_relu", counted)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        got = model(*args, inference=True)["pred_logits"]
    assert calls == [(2, 32, 32, 32)] * 2 + [(2, 16, 16, 64)] * 4 + [
        (2, 8, 8, 64)] * 2
    assert sum(e.name == "boxer.neck.norm" for e in prof.events()) == 8
    assert torch.equal(got, want)
    with torch.no_grad():
        model(*args, inference=False)
    model.train()
    model(*args, inference=False, train=True)["pred_logits"].sum().backward()
    assert len(calls) == 8
    assert model.backbone.neck.blocks[0][1].weight.grad is not None


# the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K11 has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("c,h,w", CELL_SHAPES)
def test_kernel_matches_plain_at_the_cell_shapes(cuda, c, h, w):
    x, weight, bias = make_case(CELL_BATCH, h, w, c, torch.bfloat16,
                                seed=c, device=cuda)
    before = group_norm_relu.launches
    got = group_norm_relu(x, weight, bias, EPS)
    again = group_norm_relu(x, weight, bias, EPS)
    torch.cuda.synchronize()
    assert group_norm_relu.launches == before + 2
    want = group_norm_relu_plain(x, weight, bias, EPS)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous() and got.grad_fn is None
    assert torch.equal(got, again)
    assert rel_err(got, want) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [64, 96, 2 * 32 * 3])
def test_kernel_matches_plain_at_small_odd_shapes(cuda, c, dtype):
    """B 1, 7 x 9 pixels: fewer rows than a tile; C 96 and 192 give 3 and
    6 channels a group, so vectors of 1 and 2 channels."""
    x, weight, bias = make_case(1, 7, 9, c, dtype, seed=c, device=cuda)
    got = group_norm_relu(x, weight, bias, EPS)
    want = group_norm_relu_plain(x, weight, bias, EPS)
    assert got.dtype == dtype
    assert rel_err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variance_of_groups_far_from_zero(cuda, dtype):
    """Mean 50, spread 1, at the stage-1 width of one frame: against the
    plain version in float64 on the same input."""
    x, weight, bias = make_case(1, 469, 469, 256, dtype, mean=50.0,
                                std=1.0, seed=5, device=cuda)
    got = group_norm_relu(x, weight, bias, EPS)
    want = group_norm_relu_plain(x.double(), weight.double(),
                                 bias.double(), EPS)
    assert rel_err(got, want) <= (1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
def test_types_under_autocast_with_f32_weights(cuda):
    """An f32 neck under bf16 autocast: the convolutions give bf16, the
    norm f32 on both routes; the routes agree to bf16's rounding."""
    net = make_neck(filters=(64, 128, 128)).to(cuda)
    canvas = torch.randn(2, 40, 36, 16, device=cuda)
    x, weight, bias = make_case(2, 6, 5, 64, torch.bfloat16, torch.float32,
                                device=cuda)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        want = net(canvas.permute(0, 3, 1, 2))
        got = net(canvas.permute(0, 3, 1, 2), inference=True)
        direct = group_norm_relu(x, weight, bias, EPS)
    assert direct.dtype == torch.float32
    assert rel_err(direct, group_norm_relu_plain(x, weight, bias, EPS)) \
        <= 1e-5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert g.permute(0, 2, 3, 1).is_contiguous()
        assert rel_err(g, w) <= 3e-2


@pytest.mark.gpu
def test_inference_neck_routes_to_kernel_on_card(cuda):
    """The shipped neck's 2 + 4 + 2 convolutions in bf16 at small widths:
    8 launches, each inside a `boxer.neck.norm` span; no torch GroupNorm
    statistics and no cuDNN layout transposes in the neck; the training
    route launches nothing and keeps autograd."""
    from torch.profiler import ProfilerActivity, profile

    from boxer_tpu_torch.utils.timer import span

    net = make_neck(128, (2, 4, 2), (256, 512, 1024)).to(cuda,
                                                         torch.bfloat16)
    canvas = torch.randn(1, 64, 64, 128, device=cuda, dtype=torch.bfloat16)
    x = canvas.permute(0, 3, 1, 2)
    with torch.no_grad():
        net(x, inference=True)
        torch.cuda.synchronize()
        before = group_norm_relu.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with span("boxer.neck"):
                net(x, inference=True)
            torch.cuda.synchronize()
    assert group_norm_relu.launches == before + 8
    kinds = torch.autograd.DeviceType
    assert sum(e.name == "boxer.neck.norm" and e.device_type == kinds.CPU
               for e in prof.events()) == 8
    names = {e.name for e in prof.events() if e.device_type == kinds.CUDA}
    assert any("apply_kernel" in n for n in names), sorted(names)
    banned = [n for n in names if any(k in n for k in (
        "RowwiseMoments", "nchwToNhwc", "nhwcToNchw"))]
    assert banned == []
    out = net(x)
    assert group_norm_relu.launches == before + 8
    assert out[-1].grad_fn is not None
