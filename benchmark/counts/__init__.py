"""What the benchmark's configurations need, counted from their shapes.

FLOPs by layer of a BoxeR-2D inference forward at any batch
and input size, and the bytes that a sampling call must move, so that the
model-FLOP utilisation and the sampling ops' roofline share read the same
whatever implements the work: a kernel, a library call or plain torch.
A multiply-add counts 2 FLOPs; biases, norms, activations and softmaxes are
not counted. Each layer's count is split by kind: "conv" (convolutions),
"matmul" (Linears, attention products, the mask paste) and "sampling"
(the bilinear taps: 4 corners of a head's channels, then the weighted sum).

The peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, 700 W).
"""

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def conv_out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def _conv(hw, cin, cout, k):
    return 2 * hw[0] * hw[1] * cin * cout * k * k


def _add(counts, layer, kind, flops):
    counts.setdefault(layer, {}).setdefault(kind, 0)
    counts[layer][kind] += int(flops)


def resnet(counts, blocks, hw):
    """A torchvision-layout bottleneck ResNet at input (H, W): its convs
    into counts["backbone"]; returns the (H, W) and channels after each
    stage."""
    h = (conv_out(hw[0], 7, 2, 3), conv_out(hw[1], 7, 2, 3))
    _add(counts, "backbone", "conv", _conv(h, 3, 64, 7))
    h = (conv_out(h[0], 3, 2, 1), conv_out(h[1], 3, 2, 1))
    inplanes, planes, stages = 64, 64, []
    for i, n in enumerate(blocks):
        stride = 1 if i == 0 else 2
        for j in range(n):
            s = stride if j == 0 else 1
            out = (conv_out(h[0], 3, s, 1), conv_out(h[1], 3, s, 1))
            f = (_conv(h, inplanes, planes, 1) + _conv(out, planes, planes, 3)
                 + _conv(out, planes, 4 * planes, 1))
            if j == 0:
                f += _conv(out, inplanes, 4 * planes, 1)
            _add(counts, "backbone", "conv", f)
            h, inplanes = out, 4 * planes
        stages.append((h, inplanes))
        planes *= 2
    return stages


def _linear(rows, cin, cout):
    return 2 * rows * cin * cout


def _sampling(taps, ch):
    """Bilinear taps: 4 corners of ch channels, then the weighted sum."""
    return taps * ch * (4 * 2 + 2)


def _self_attention(counts, layer, nq, d):
    _add(counts, layer, "matmul", _linear(nq, d, 3 * d) + _linear(nq, d, d)
         + 2 * 2 * nq * nq * d)


def _ffn(counts, layer, rows, d, dff):
    _add(counts, layer, "matmul", _linear(rows, d, dff) + _linear(rows, dff, d))


def _sampling_attention(counts, layer, rows, tokens, d, nh, nl, npt,
                        n_box, n_attn):
    """Value projection over the tokens sampled, box and weight heads and
    the output projection over the rows that sample, the taps."""
    _add(counts, layer, "matmul", _linear(tokens, d, d)
         + _linear(rows, d, n_box) + _linear(rows, d, n_attn)
         + _linear(rows, d, d))
    _add(counts, layer, "sampling", _sampling(rows * nh * nl * npt, d // nh))


def boxer2d_forward(cfg: dict, hw, topk: int = 100) -> dict:
    """One image's BoxeR-2D inference forward at canvas hw = (H, W), with
    the deferred top-k mask decode and paste when cfg["use_mask"]:
    {layer: {kind: FLOPs}}."""
    d, nh, nl = cfg["hidden_dim"], cfg["nhead"], cfg["num_level"]
    dff, nq, nc = cfg["dim_feedforward"], cfg["num_queries"], cfg["num_classes"]
    counts = {}
    stages = resnet(counts, cfg["resnet_blocks"], hw)
    levels = []
    for (lhw, c) in stages[1:]:
        _add(counts, "input_proj", "conv", _conv(lhw, c, d, 1))
        levels.append(lhw)
    lhw, c = stages[-1]
    for i in range(len(levels), nl):
        lhw = (conv_out(lhw[0], 3, 2, 1), conv_out(lhw[1], 3, 2, 1))
        _add(counts, "input_proj", "conv",
             _conv(lhw, c if i == len(levels) else d, d, 3))
        levels.append(lhw)
    s = sum(h * w for h, w in levels)

    k = cfg["box_kernel"]
    for _ in range(cfg["enc_layers"]):
        _sampling_attention(counts, "encoder", s, s, d, nh, nl, k * k,
                            nh * nl * 4, nh * nl * k * k)
        _ffn(counts, "encoder", s, d, dff)

    _add(counts, "proposals", "matmul", _linear(s, d, 1)
         + _linear(nq, d, d) * 2 + _linear(nq, d, 4) + _linear(nq, d, d))

    use_mask = cfg["use_mask"]
    ki = cfg["instance_kernel"] if use_mask else k
    for i in range(cfg["dec_layers"]):
        _self_attention(counts, "decoder", nq, d)
        _sampling_attention(counts, "decoder", nq, s, d, nh, nl, ki * ki,
                            nh * nl * 4, nh * nl * (4 if use_mask else k * k))
        if use_mask and i == cfg["dec_layers"] - 1:
            # the instance attention's second sum, the mask RoI
            _add(counts, "decoder", "sampling", nq * nh * nl * ki * ki
                 * (d // nh) * 2)
        _ffn(counts, "decoder", nq, d, dff)

    _add(counts, "heads", "matmul", _linear(nq, d, nc) + _linear(nq, d, d) * 2
         + _linear(nq, d, 4))
    if use_mask:
        roi, s2 = topk * ki * ki, 2 * ki
        _add(counts, "mask_decode", "matmul", _linear(roi, d, d))
        _ffn(counts, "mask_decode", roi, d, dff)
        # the 2x2/2 transposed conv, the 1x1 conv, the selected channel
        _add(counts, "mask_decode", "conv", topk * (_conv((ki, ki), d, d, 2)
                                                    + _conv((s2, s2), d, d, 1)))
        _add(counts, "mask_decode", "matmul", 2 * topk * s2 * s2 * d)
        # paste: (H, s) @ (s, s), then (H, s) @ (s, W) a mask
        _add(counts, "paste", "matmul", 2 * topk * hw[0] * s2 * (s2 + hw[1]))
    return counts


def total(counts: dict, kinds=None) -> int:
    """The sum over layers of the given kinds (all by default)."""
    return sum(f for by_kind in counts.values() for kind, f in by_kind.items()
               if kinds is None or kind in kinds)


def _size(dtype) -> int:
    return 4 if str(dtype).endswith("float32") else 2


def box_attention_bytes(value_shape, value_dtype, grid_shape) -> int:
    """Bytes a box-attention sampling call must move: the value (B, S, H,
    Ch) read once, gx, gy and the tap weights (B, H, L, P, LQ) f32 read
    once, the output (B, H, LQ, Ch) in the value's type written once."""
    b, _, nh, ch = value_shape
    lq = grid_shape[-1]
    n = 1
    for x in value_shape:
        n *= x
    g = 1
    for x in grid_shape:
        g *= x
    return n * _size(value_dtype) + 3 * g * 4 + b * nh * lq * ch * _size(
        value_dtype)


def instance_attention_bytes(value_shape, value_dtype, grid_shape,
                             kernel_size: int) -> int:
    """As `box_attention_bytes` for the dual-output instance attention: four
    f32 grids (gx, gy, spatial and level weights) and both outputs, the
    attention output (B, H, LQ, Ch) and the mask RoI (B, LQ, k, k, H*Ch)."""
    b, _, nh, ch = value_shape
    lq = grid_shape[-1]
    n = 1
    for x in value_shape:
        n *= x
    g = 1
    for x in grid_shape:
        g *= x
    out = b * nh * lq * ch + b * lq * kernel_size ** 2 * nh * ch
    return n * _size(value_dtype) + 4 * g * 4 + out * _size(value_dtype)


def k4_bound_ms(rows: int, grid_shape, value_dtype) -> float:
    """K4's least time on one H100, as the port's kernel table states it:
    the distinct quad rows (4 pixels of 32 channels) that the valid taps
    read, the four f32 grids once and both outputs once, at 3.35 TB/s (its
    operations, 4 corners and 2 sums of 32 channels a tap, bound it less)."""
    _, nh, _, npt, lq = grid_shape
    g = 1
    for x in grid_shape:
        g *= x
    size = _size(value_dtype)
    nbytes = rows * 128 * size + 4 * g * 4 + (nh * lq * 32
                                              + lq * npt * nh * 32) * size
    flops = g * (4 + 2) * 32 * 2
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["f32"]) * 1e3
