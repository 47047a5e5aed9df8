"""Weight bridge from the JAX package's BoxeR-2D variables to the port.

`load_jax_params(model, variables_np)` takes the JAX model's
`{"params", "constants"}` as nested dicts of numpy arrays and fills the
port's parameters and buffers (which carry the reference e2edet names).
No jax is needed. Layout rules:

- Dense kernel (I, O) -> Linear weight (O, I);
- Conv kernel (kH, kW, I, O) -> (O, I, kH, kW);
- ConvTranspose kernel (kH, kW, I, O) -> (I, O, kH, kW), spatially flipped
  (flax's ConvTranspose does not flip its kernel, torch's does);
- the scanned encoder's leading layer axis -> `encoder.layers.{i}`;
- `self_attn.{query,key,value}` -> the fused `self_attn.in_proj_weight/bias`;
- LayerNorm / GroupNorm `scale` -> `weight`.
"""

import re
from typing import Dict, List, Tuple

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(name: str, arr):
    """A flax leaf -> (torch leaf name, array)."""
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
    if name == "scale":
        return "weight", arr
    return name, arr


def _attn(path, arr):
    """Box / instance attention sub-path -> (torch suffix, array)."""
    mod, leaf = path
    if mod in ("linear_attn", "linear_box"):
        return f"{mod}_{'weight' if leaf == 'kernel' else 'bias'}", _leaf(
            leaf, arr)[1]
    name, arr = _leaf(leaf, arr)
    return f"{mod}.{name}", arr


def _detector(path, arr, n_mask_layers: int):
    mod = path[0]
    if mod == "bbox_embed":
        j = path[1][len("layer"):]
        name, arr = _leaf(path[2], arr)
        return f"bbox_embed.layers.{j}.{name}", arr
    if mod == "mask_embed":
        sub, leaf = path[1], path[2]
        if sub == "upsample":
            if leaf == "kernel":
                return "mask_embed.layers.0.0.weight", np.ascontiguousarray(
                    arr[::-1, ::-1].transpose(2, 3, 0, 1))
            return "mask_embed.layers.0.0.bias", arr
        name, arr = _leaf(leaf, arr)
        if sub == "proj":
            return f"mask_embed.layers.{n_mask_layers}.{name}", arr
        i = int(sub[len("conv"):])
        return f"mask_embed.layers.{i + 1}.0.{name}", arr
    name, arr = _leaf(path[1], arr)
    return f"{mod}.{name}", arr


def _trunk(path, arr):
    parts = []
    for p in path[:-1]:
        m = re.fullmatch(r"(layer\d+)_(\d+)", p)
        if m:
            parts += [m.group(1), m.group(2)]
        elif p in ("downsample_conv", "downsample_bn"):
            parts += ["downsample", "0" if p.endswith("conv") else "1"]
        else:
            parts.append(p)
    name, arr = _leaf(path[-1], arr)
    return "backbone." + ".".join(parts + [name]), arr


def jax_to_torch_state(variables_np) -> Tuple[Dict[str, np.ndarray],
                                              Dict[str, List[str]]]:
    """Returns ({torch key: array}, {torch key: [jax leaf names]}); a leaf
    the map does not know goes under the key "unmapped.<leaf>", which no
    port tensor has."""
    out: Dict[str, np.ndarray] = {}
    src: Dict[str, List[str]] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}

    def put(key, arr, jax_name):
        out[key] = np.ascontiguousarray(arr)
        src.setdefault(key, []).append(jax_name)

    for coll in ("params", "constants"):
        tree = variables_np.get(coll, {})
        n_mask = {}
        for det in (("detector",), ("transformer", "enc_detector")):
            node = tree
            for p in det + ("mask_embed",):
                node = node.get(p, {}) if isinstance(node, dict) else {}
            n_mask[det] = 1 + sum(k.startswith("conv") for k in node)
        for path, arr in _flatten(tree):
            jax_name = "/".join((coll,) + path)
            head = path[0]
            if head == "backbone":
                put(*_trunk(path[2:], arr), jax_name)
            elif head.startswith("input_proj"):
                i, kind = re.fullmatch(r"input_proj(\d+)_(conv|gn)", head).groups()
                name, a = _leaf(path[1], arr)
                put(f"input_proj.{i}.{0 if kind == 'conv' else 1}.{name}", a,
                    jax_name)
            elif head == "detector":
                key, a = _detector(path[1:], arr, n_mask[("detector",)])
                put("detector." + key, a, jax_name)
            elif head != "transformer":
                src.setdefault(f"unmapped.{jax_name}", []).append(jax_name)
            elif path[1] == "enc_detector":
                key, a = _detector(path[2:], arr,
                                   n_mask[("transformer", "enc_detector")])
                put("enc_detector." + key, a, jax_name)
            elif path[1] in ("enc_linear", "enc_norm"):
                name, a = _leaf(path[2], arr)
                idx = 0 if path[1] == "enc_linear" else 1
                put(f"transformer.encoder.enc_linear.{idx}.{name}", a, jax_name)
            elif path[1] == "encoder_layers":
                rest = path[2:]
                for i in range(arr.shape[0]):
                    if rest[0] == "self_attn":
                        key, a = _attn(rest[1:], arr[i])
                        key = "self_attn." + key
                    else:
                        name, a = _leaf(rest[1], arr[i])
                        key = f"{rest[0]}.{name}"
                    put(f"transformer.encoder.layers.{i}.{key}", a, jax_name)
            else:
                i = re.fullmatch(r"decoder_layer(\d+)", path[1]).group(1)
                pre = f"transformer.decoder.layers.{i}."
                rest = path[2:]
                if rest[0] == "self_attn" and rest[1] in ("query", "key",
                                                          "value"):
                    name, a = _leaf(rest[2], arr)
                    qkv.setdefault(pre + "self_attn.in_proj_" + name,
                                   {})[rest[1]] = (a, jax_name)
                elif rest[0] == "self_attn":            # "out"
                    name, a = _leaf(rest[2], arr)
                    put(pre + f"self_attn.out_proj.{name}", a, jax_name)
                elif rest[0] == "cross_attn":
                    key, a = _attn(rest[1:], arr)
                    put(pre + "multihead_attn." + key, a, jax_name)
                else:
                    name, a = _leaf(rest[1], arr)
                    put(pre + f"{rest[0]}.{name}", a, jax_name)
    for key, parts in qkv.items():
        if set(parts) != {"query", "key", "value"}:
            for a, jax_name in parts.values():
                src.setdefault(f"unmapped.{jax_name}", []).append(jax_name)
            continue
        put(key, np.concatenate([parts[n][0] for n in ("query", "key",
                                                       "value")]),
            parts["query"][1])
        src[key] += [parts["key"][1], parts["value"][1]]
    return out, src


@torch.no_grad()
def load_jax_params(model: torch.nn.Module, variables_np):
    """Fill `model`'s parameters and buffers from the JAX variables.

    Raises on a shape mismatch. Returns (unused JAX leaves, port tensors
    left unfilled); both are empty for a matching model."""
    arrays, src = jax_to_torch_state(variables_np)
    state = model.state_dict(keep_vars=True)
    unused, filled = [], set()
    for key, names in src.items():
        if key not in state:
            unused += names
            continue
        t = state[key]
        arr = arrays[key]
        if tuple(t.shape) != arr.shape:
            raise ValueError(f"shape mismatch at {key}: port {tuple(t.shape)}"
                             f" vs JAX {arr.shape} ({names})")
        t.data.copy_(torch.from_numpy(arr).to(t.dtype))
        filled.add(key)
    return sorted(unused), sorted(k for k in state if k not in filled)
