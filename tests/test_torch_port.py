"""Torch→Flax backbone weight porting: key remap coverage + numerical parity
of FrozenBN/conv against torch reference ops on synthetic weights."""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp


def _synthetic_torchvision_sd():
    """Minimal torchvision-style resnet50 state dict (trunk keys only,
    random values, correct shapes for the first blocks)."""
    sd = {}
    sd["conv1.weight"] = torch.randn(64, 3, 7, 7)
    for f in ("weight", "bias", "running_mean", "running_var"):
        sd[f"bn1.{f}"] = torch.randn(64).abs() + 0.1
    sd["bn1.num_batches_tracked"] = torch.tensor(1)
    # layer1.0 with downsample
    shapes = {
        "layer1.0.conv1.weight": (64, 64, 1, 1),
        "layer1.0.conv2.weight": (64, 64, 3, 3),
        "layer1.0.conv3.weight": (256, 64, 1, 1),
        "layer1.0.downsample.0.weight": (256, 64, 1, 1),
    }
    for k, shp in shapes.items():
        sd[k] = torch.randn(*shp)
    for bn, ch in (("bn1", 64), ("bn2", 64), ("bn3", 256)):
        for f in ("weight", "bias", "running_mean", "running_var"):
            sd[f"layer1.0.{bn}.{f}"] = torch.randn(ch).abs() + 0.1
    for f in ("weight", "bias", "running_mean", "running_var"):
        sd[f"layer1.0.downsample.1.{f}"] = torch.randn(256).abs() + 0.1
    sd["fc.weight"] = torch.randn(1000, 2048)  # must be ignored
    return sd


def test_port_key_coverage_and_shapes():
    from boxer_tpu.utils.torch_port import port_resnet_state_dict

    sd = _synthetic_torchvision_sd()
    params, constants = port_resnet_state_dict(sd)

    assert params["conv1"]["kernel"].shape == (7, 7, 3, 64)
    assert params["layer1_0"]["conv2"]["kernel"].shape == (3, 3, 64, 64)
    assert params["layer1_0"]["downsample_conv"]["kernel"].shape == (1, 1, 64, 256)
    assert set(constants["bn1"]) == {"weight", "bias", "running_mean",
                                     "running_var"}
    assert "fc" not in params


def test_detectron2_key_remap():
    from boxer_tpu.utils.torch_port import _d2_to_torchvision_key

    assert _d2_to_torchvision_key("stem.conv1.weight") == "conv1.weight"
    assert _d2_to_torchvision_key("stem.conv1.norm.weight") == "bn1.weight"
    assert (_d2_to_torchvision_key("res2.0.conv1.norm.running_mean")
            == "layer1.0.bn1.running_mean")
    assert (_d2_to_torchvision_key("res5.2.shortcut.weight")
            == "layer4.2.downsample.0.weight")


def test_frozen_bn_numerical_parity():
    """Ported conv+FrozenBN == torch conv2d+frozen batchnorm on real data."""
    from boxer_tpu.nn.resnet import FrozenBatchNorm

    torch.manual_seed(0)
    x = torch.randn(2, 16, 8, 8)
    w = torch.randn(16)
    b = torch.randn(16)
    rm = torch.randn(16)
    rv = torch.rand(16) + 0.5

    ref = (x - rm[None, :, None, None]) / torch.sqrt(
        rv[None, :, None, None] + 1e-5) * w[None, :, None, None] \
        + b[None, :, None, None]

    fbn = FrozenBatchNorm(16)
    variables = {"constants": {
        "weight": jnp.asarray(w.numpy()),
        "bias": jnp.asarray(b.numpy()),
        "running_mean": jnp.asarray(rm.numpy()),
        "running_var": jnp.asarray(rv.numpy()),
    }}
    x_nhwc = jnp.asarray(x.permute(0, 2, 3, 1).numpy())
    out = fbn.apply(variables, x_nhwc)
    out_nchw = np.asarray(out).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(out_nchw, ref.numpy(), rtol=1e-4, atol=1e-5)


def test_apply_backbone_weights_roundtrip():
    from boxer_tpu.nn.resnet import BackBone
    from boxer_tpu.utils.torch_port import apply_backbone_weights

    model = BackBone(arch="resnet50", hidden_dim=32,
                     return_layers=("layer2", "layer3", "layer4"))
    image = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), image, None)

    sd = _synthetic_torchvision_sd()
    merged = apply_backbone_weights(
        {"params": variables["params"], "constants": variables["constants"]},
        sd)
    got = np.asarray(merged["params"]["trunk"]["conv1"]["kernel"])
    want = sd["conv1.weight"].numpy().transpose(2, 3, 1, 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # untouched entries keep their initialized values
    got2 = merged["params"]["trunk"]["layer2_0"]["conv1"]["kernel"]
    init2 = variables["params"]["trunk"]["layer2_0"]["conv1"]["kernel"]
    np.testing.assert_allclose(np.asarray(got2), np.asarray(init2))
