"""Ranges that the benchmark opens around calls into the port, from its own
files: the sampling ops as `boxer_tpu_torch/nn/attention.py` binds them,
each call's bytes counted from its argument shapes (`counts`)."""

import contextlib

import torch

import counts

BOX_RANGE = "sampling.box_attention"
INSTANCE_RANGE = "sampling.instance_attention"


@contextlib.contextmanager
def sampling_ranges(calls: list):
    """Inside, every box- and instance-attention call of the port runs in a
    profiler range of its own and appends its bytes to `calls`."""
    from boxer_tpu_torch.nn import attention

    box, inst = attention.box_attention_qminor, attention.instance_attention_qminor

    def box_ranged(value, shapes, gx, gy, attn_weight, *args, **kw):
        calls.append(counts.box_attention_bytes(value.shape, value.dtype,
                                                gx.shape))
        with torch.profiler.record_function(BOX_RANGE):
            return box(value, shapes, gx, gy, attn_weight, *args, **kw)

    def inst_ranged(value, shapes, gx, gy, spatial, level, kernel_size,
                    *args, **kw):
        calls.append(counts.instance_attention_bytes(
            value.shape, value.dtype, gx.shape, kernel_size))
        with torch.profiler.record_function(INSTANCE_RANGE):
            return inst(value, shapes, gx, gy, spatial, level, kernel_size,
                        *args, **kw)

    attention.box_attention_qminor = box_ranged
    attention.instance_attention_qminor = inst_ranged
    try:
        yield
    finally:
        attention.box_attention_qminor = box
        attention.instance_attention_qminor = inst
