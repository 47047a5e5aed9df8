"""Seeded random weights, made on the device in one draw.

Every floating tensor of a model's state dict, in the order of their names,
takes its slice of one `torch.randn` from a generator on the device seeded
with the run's seed: matrices and kernels at variance 1/fan_in, norm and
frozen batch-norm scales about 1, variances above 0, biases and means small.
The zero-initialised heads of a fresh model (sampling offsets, attention
weights, the last box layer) get weights too, so every sampling op moves its
taps and every output depends on its inputs. The same names and shapes give
the same values on one device, which is how the reference gets the weights
that the program serves.
"""

import math

import torch


def _rule(name: str, t: torch.Tensor, z: torch.Tensor,
          transposed: bool) -> torch.Tensor:
    if t.dim() >= 2:
        return z / math.sqrt(t.shape[0] if transposed else t[0].numel())
    if name.endswith("running_var"):
        return torch.exp(0.1 * z)
    if name.endswith("weight"):
        return 1.0 + 0.1 * z                      # norm scales
    return 0.1 * z                                # biases, means


@torch.no_grad()
def fill_(model: torch.nn.Module, seed: int, device,
          scales=None) -> torch.nn.Module:
    """Fill every floating parameter and buffer of `model` (on `device`)
    from `seed`, times scales[key] where a name ends with key; returns the
    model."""
    transposed = {f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.ConvTranspose2d)}
    state = model.state_dict()
    names = sorted(k for k, v in state.items() if v.is_floating_point())
    total = sum(state[k].numel() for k in names)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    at = 0
    for name in names:
        t = state[name]
        z = flat[at:at + t.numel()].view(t.shape)
        at += t.numel()
        scale = next((v for k, v in (scales or {}).items()
                      if name.endswith(k)), 1.0)
        t.copy_(_rule(name, t, z, name in transposed) * scale)
    return model
