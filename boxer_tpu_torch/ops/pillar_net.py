"""The pillar net's forward at inference (K10), one launch a call.

`pillar_features_plain` is `nn/point_pillar.py:PillarFeatureNet`'s forward:
each point decorated with its offset from the pillar's point mean and from
the pillar's centre, then the PFN layers, the first in f32 (that module's
docstring). The training path runs it, autograd through `group_norm`'s two
passes; so does `pillar_features` on a CPU tensor.

`pillar_features` launches the kernel, `csrc/pillar_net.cu`, on a CUDA
tensor, for the shapes it is built for: 5 raw features a point, at most 32
points a pillar, and two PFN layers of 64 and 128 filters (GroupNorm of
32 groups, flax's eps), the shipped Waymo config's. Anything else on CUDA
raises; there is no other fallback. Its output has no `grad_fn`: the
kernel has no backward, so a caller that needs a gradient takes the plain
version (`PillarFeatureNet.forward(inference=False)`). It differs from the
plain version in rounding alone: layer 2's product reaches its norm in f32
where the plain version rounds it to the weights' type first, and the sums
go in another order. The source's note has the design.
"""

import ctypes

import torch

from boxer_tpu_torch.ops import _build

# the shapes the kernel is built for
NUM_FEATURES = 5
MAX_POINTS = 32
FILTERS = (64, 128)
GROUPS = 32


def pillar_features_plain(features, num_voxels, coors, voxel_size, pc_range,
                          layers):
    """features: (V, P, F); num_voxels: (V,) points per pillar; coors: (V,
    4) [b, z, y, x]; layers: the PFN layers (`nn/point_pillar.py:PFNLayer`).
    Returns (V, num_filters[-1]) in the last layer's type, or autocast's."""
    features = features.float()
    p = features.shape[1]
    denom = num_voxels.float().clamp(min=1.0)
    points_mean = features[:, :, :3].sum(dim=1, keepdim=True) / denom[
        :, None, None]
    f_cluster = features[:, :, :3] - points_mean
    vx, vy = voxel_size[0], voxel_size[1]
    x_offset = vx / 2 + pc_range[0]
    y_offset = vy / 2 + pc_range[1]
    fx = features[:, :, 0] - (coors[:, 3].float()[:, None] * vx + x_offset)
    fy = features[:, :, 1] - (coors[:, 2].float()[:, None] * vy + y_offset)
    x = torch.cat([features, f_cluster, torch.stack([fx, fy], dim=-1)],
                  dim=-1)
    point_mask = (torch.arange(p, device=features.device)[None, :]
                  < num_voxels[:, None])
    x = x.masked_fill(~point_mask[..., None], 0.0)
    first, *rest = layers
    with torch.autocast(x.device.type, enabled=False):
        x = first(x, point_mask, weight=first.linear.weight.float())
    x = x.to(first.linear.weight.dtype)
    for layer in rest:
        x = layer(x, point_mask)
    return x.squeeze(1)


def _params(layers, device):
    """The six parameters the kernel reads, each checked: layer 1's kernel
    (32, 10), norm weight and bias, layer 2's kernel (128, 64), norm weight
    and bias, all in one dtype (bf16 or f32), contiguous, on `device`."""
    name = "pillar_features"
    if len(layers) != len(FILTERS):
        raise ValueError(f"{name}: {len(layers)} PFN layers, the kernel is "
                         f"built for {len(FILTERS)}")
    want_in = NUM_FEATURES + 5
    params = []
    for i, (layer, filters) in enumerate(zip(layers, FILTERS)):
        out = filters if layer.last_layer else filters // 2
        shape, norm = tuple(layer.linear.weight.shape), layer.norm
        if (layer.last_layer != (i == len(FILTERS) - 1)
                or shape != (out, want_in) or layer.linear.bias is not None
                or norm.num_groups != GROUPS or norm.num_channels != out
                or not norm.affine):
            raise ValueError(
                f"{name}: layer {i} is Linear{shape} with GroupNorm("
                f"{norm.num_groups}, {norm.num_channels}); the kernel is "
                f"built for filters {FILTERS} on {NUM_FEATURES} features, "
                f"{GROUPS} groups")
        want_in = 2 * out
        params += [layer.linear.weight, layer.norm.weight, layer.norm.bias]
    dtype = params[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: weights' dtype {dtype}")
    for t in params:
        if t.dtype != dtype or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: the PFN layers' parameters must share "
                             f"one dtype and the points' device, contiguous")
    return params, [float(layer.norm.eps) for layer in layers]


def _launch(features, num_voxels, coors, voxel_size, pc_range, layers):
    """Check the arguments and launch the kernel; returns (V, 128)."""
    name = "pillar_features"
    if (features.dim() != 3 or features.shape[2] != NUM_FEATURES
            or not 1 <= features.shape[1] <= MAX_POINTS):
        raise ValueError(f"{name}: features must be (V, P <= {MAX_POINTS}, "
                         f"{NUM_FEATURES}), got {tuple(features.shape)}")
    v, p = features.shape[:2]
    if features.dtype != torch.float32:
        raise TypeError(f"{name}: features must be f32, got "
                        f"{features.dtype}")
    if num_voxels.shape != (v,) or coors.shape != (v, 4):
        raise ValueError(f"{name}: num_voxels ({v},) and coors ({v}, 4), got "
                         f"{tuple(num_voxels.shape)} and "
                         f"{tuple(coors.shape)}")
    for t in (num_voxels, coors):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: num_voxels and coors must be int32, "
                            f"got {t.dtype}")
    for t in (features, num_voxels, coors):
        if t.device != features.device:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    params, eps = _params(layers, features.device)
    if not features.is_cuda:
        raise ValueError(f"{name}: unsupported device {features.device}")
    out = torch.empty((v, FILTERS[-1]), dtype=params[0].dtype,
                      device=features.device)
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    f32 = ctypes.c_float
    lib = _build.library()
    with torch.cuda.device(features.device):
        err = lib.pillar_net(
            features.device.index, int(params[0].dtype == torch.bfloat16),
            features.data_ptr(), num_voxels.data_ptr(), coors.data_ptr(), v,
            p, f32(vx), f32(vy), f32(vx / 2 + pc_range[0]),
            f32(vy / 2 + pc_range[1]), f32(eps[0]), f32(eps[1]),
            *(t.data_ptr() for t in params), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, name)
    return out


def pillar_features(features, num_voxels, coors, voxel_size, pc_range,
                    layers):
    """K10. features: (V, P <= 32, 5) f32; num_voxels: (V,) int32; coors:
    (V, 4) int32 [b, z, y, x], all contiguous; layers: the two PFN layers
    of filters (64, 128), their parameters bf16 or f32. Returns (V, 128) in
    the weights' type, with no `grad_fn`. On a CPU tensor the plain
    version."""
    if features.device.type == "cpu":
        return pillar_features_plain(features, num_voxels, coors, voxel_size,
                                     pc_range, layers)
    out = _launch(features, num_voxels, coors, voxel_size, pc_range, layers)
    pillar_features.launches += 1
    return out


pillar_features.launches = 0
