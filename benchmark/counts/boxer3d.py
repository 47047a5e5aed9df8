"""FLOPs by layer of one frame's BoxeR-3D PointPillars inference forward,
counted from its shapes as `counts.boxer2d_forward` counts BoxeR-2D's (a
multiply-add 2 FLOPs; norms, activations, softmaxes not counted; kinds
"conv", "matmul" and "sampling").

Layers: "pillars" (the pillar net's Linears over every slot of the voxel
block, padded slots included, as a fixed block is run), "neck" (the
ConvNet's 3x3 convolutions), "input_proj", "encoder", "proposals" (the
encoder head's class and box layers over every cell, the embedding of the
chosen), "decoder" and "heads".
"""

from counts import (_add, _conv, _ffn, _linear, _sampling_attention,
                    _self_attention, conv_out)

NUM_REFERENCES = 3


def boxer3d_forward(cfg: dict, grid, voxels) -> dict:
    """cfg: the configuration (its `model` and `backbone`); grid: the BEV
    grid (nx, ny); voxels: the block's (pillars, points a pillar).
    Returns {layer: {kind: FLOPs}}."""
    model, params = cfg["model"], cfg["backbone"]["params"]
    reader, neck = params["reader"], params["neck"]
    d, nh, nl = model["hidden_dim"], model["nhead"], model["num_level"]
    dff, nq = model["dim_feedforward"], model["num_queries"]
    counts = {}

    rows = voxels[0] * voxels[1]
    filters = reader["num_filters"]
    cin = reader["num_input_features"] + 5
    for i, f in enumerate(filters):
        out = f if i == len(filters) - 1 else f // 2
        _add(counts, "pillars", "matmul", _linear(rows, cin, out))
        cin = 2 * out

    cin, hw = filters[-1], (grid[1], grid[0])
    stages = []
    for n, s, f in zip(neck["num_layers"], neck["ds_strides"],
                       neck["ds_filters"]):
        for j in range(n):
            stride = s if j == 0 else 1
            hw = (conv_out(hw[0], 3, stride, 1), conv_out(hw[1], 3, stride, 1))
            _add(counts, "neck", "conv", _conv(hw, cin, f, 3))
            cin = f
        stages.append((hw, f))
    levels = stages[-params["return_layers"]:]
    for lhw, c in levels:
        _add(counts, "input_proj", "conv", _conv(lhw, c, d, 1))
    s = sum(h * w for (h, w), _ in levels)

    for _ in range(model["enc_layers"]):
        _sampling_attention(counts, "encoder", s, s, d, nh, nl, 4,
                            nh * nl * 4, nh * nl * 4)
        _ffn(counts, "encoder", s, d, dff)

    r = NUM_REFERENCES
    _add(counts, "proposals", "matmul", _linear(s, d, r)
         + _linear(s, d, d) * 2 + _linear(s, d, r * 7) + _linear(nq, d, d))

    for _ in range(model["dec_layers"]):
        _self_attention(counts, "decoder", nq, d)
        _sampling_attention(counts, "decoder", nq, s, d, nh, nl, 4,
                            nh * nl * 5, nh * nl * 4)
        _ffn(counts, "decoder", nq, d, dff)

    _add(counts, "heads", "matmul", _linear(nq, d, model["num_classes"])
         + _linear(nq, d, d) * 2 + _linear(nq, d, 7))
    return counts
