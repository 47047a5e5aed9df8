"""`benchmark/counts` against torch's own FLOP counter on the port's models
at a small size, and the sampling bytes against a count by hand."""

import json

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT
from torch.utils.flop_counter import FlopCounterMode

import counts

CONV = {"convolution"}
MATMUL = {"mm", "addmm", "bmm", "baddbmm"}


def _by_kind(mode):
    """FlopCounterMode's totals of convolutions and of matrix products."""
    got = {"conv": 0, "matmul": 0}
    for op, n in mode.get_flop_counts()["Global"].items():
        name = str(op).split(".")[-1]
        if name in CONV:
            got["conv"] += n
        elif name in MATMUL:
            got["matmul"] += n
    return got


def _counted(fn):
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        fn()
    return _by_kind(mode)


@pytest.mark.parametrize("use_mask", [True, False])
def test_boxer2d_flops_match_torch(use_mask):
    from boxer_tpu_torch.models.boxer2d import BoxeR2D

    cfg = json.loads((BENCH / "configs/boxer2d_r50_segm.json").read_text())
    model_cfg = dict(cfg["model"], num_queries=40, enc_layers=2, dec_layers=2,
                     use_mask=use_mask)
    model = BoxeR2D(**model_cfg).init_weights(0).eval()
    hw, topk = (96, 128), 15
    image = torch.randn(1, *hw, 3)
    mask = torch.zeros(1, *hw, dtype=torch.bool)
    got = _counted(lambda: model(image, mask, postprocess={
        "canvas_hw": hw, "topk": topk}))
    want = counts.boxer2d_forward(dict(model_cfg, **cfg["shapes"]), hw, topk)
    assert got["conv"] == counts.total(want, {"conv"})
    assert got["matmul"] == counts.total(want, {"matmul"})


def test_sampling_bytes_by_hand():
    # box attention: value (2, 100, 8, 32) bf16, grids (2, 8, 4, 4, 300)
    assert counts.box_attention_bytes(
        (2, 100, 8, 32), torch.bfloat16, (2, 8, 4, 4, 300)) == (
        2 * 100 * 8 * 32 * 2 + 3 * (2 * 8 * 4 * 4 * 300) * 4
        + 2 * 8 * 300 * 32 * 2)
    # instance attention, f32 value, k 14: four grids, two outputs
    assert counts.instance_attention_bytes(
        (1, 50, 8, 32), torch.float32, (1, 8, 4, 196, 300), 14) == (
        1 * 50 * 8 * 32 * 4 + 4 * (8 * 4 * 196 * 300) * 4
        + (8 * 300 * 32 + 300 * 196 * 8 * 32) * 4)


def test_k4_bound_is_the_kernel_tables():
    """K4's bound at its segm shape: chip_smoke.py:k4_bound's value on the
    same taps, and the 0.0298 ms of the port's kernel table."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _, taps, rows = chip_smoke.segm_instance_case(
        "cpu", np.random.RandomState(0))
    gx = taps[0]
    mine = counts.k4_bound_ms(rows, tuple(gx.shape), torch.bfloat16)
    theirs, kind = chip_smoke.k4_bound(rows, gx, torch.bfloat16)
    assert kind == "bytes"
    assert mine == pytest.approx(theirs, rel=1e-12)
    assert round(mine, 4) == 0.0298
