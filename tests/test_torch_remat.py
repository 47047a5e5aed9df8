"""Remat (`nn/box_transformer.py`: the encoder layers, and a segm model's
decoder layers, under non-reentrant checkpoint with the sampling-saving
policy) against the same step without it, on the CPU.

The tiny model of `tests/test_torch_train.py` (r10, hidden 64 in 2 heads, 1
encoder and 2 decoder layers) on its 64x96 batch, segm and detection, at
dropout 0 and at 0.1 under one key: the pre-clip gradients of one step
with remat on and off within max abs 1e-6 of each other, every loss term
equal. With remat on each rematerialised layer runs its forward twice (the
recompute), and the sampling op's forward (K2's plain version here) runs
as many times as without remat: its output is saved, not recomputed; the
backward scatters (K5/K6's plain version) run as many times too.
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget)
import importlib

import pytest
import torch

from test_torch_train import TINY, _batch, _port_setup, _to_torch

from boxer_tpu_torch.nn import box_transformer as bt
from boxer_tpu_torch.nn.dropout import Dropout

ba = importlib.import_module("boxer_tpu_torch.ops.box_attention")


def _counted(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)


def _step(monkeypatch, use_mask, dropout, remat):
    counts = {}
    _counted(monkeypatch, ba, "quad_sample_reduce_w4", counts)
    _counted(monkeypatch, ba, "scatter_add_rows_weighted_dw4", counts)
    for cls in (bt.EncoderLayer, bt.DecoderLayer):
        _counted(monkeypatch, cls, "forward", counts)
    state, step = _port_setup(use_mask, seed=4)
    for mod in state.model.modules():
        if isinstance(mod, Dropout):
            mod.rate = dropout
    state.model.transformer.remat = remat
    _, stats = step(state, _to_torch(_batch(use_mask)), update=5)
    monkeypatch.undo()
    return stats, counts


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["p0", "p0.1"])
@pytest.mark.parametrize("use_mask", [True, False], ids=["segm", "det"])
def test_remat_gradients_equal(monkeypatch, use_mask, dropout):
    on, n_on = _step(monkeypatch, use_mask, dropout, remat=True)
    off, n_off = _step(monkeypatch, use_mask, dropout, remat=False)
    losses = [k for k in off if k.startswith("loss_")]
    assert losses and all(on[k] == off[k] for k in losses)
    worst = max(float((on["_grads"][n] - g).abs().max())
                for n, g in off["_grads"].items() if g is not None)
    assert worst <= 1e-6, worst
    dec = TINY["dec_layers"]
    assert n_off["forward"] == TINY["enc_layers"] + dec
    assert n_on["forward"] == 2 * TINY["enc_layers"] + dec * (
        2 if use_mask else 1)
    levels = 4 * (TINY["enc_layers"] + dec)
    assert n_on["quad_sample_reduce_w4"] == n_off["quad_sample_reduce_w4"]
    assert n_off["quad_sample_reduce_w4"] == levels
    assert n_on["scatter_add_rows_weighted_dw4"] == n_off[
        "scatter_add_rows_weighted_dw4"] == levels
