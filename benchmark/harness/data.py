"""The benchmark's own inputs, made from the run's seed."""

import numpy as np
import torch


def substream(seed: int, name: str) -> int:
    """A seed of its own for each kind of input, from the run's seed."""
    words = [ord(c) for c in name]
    state = np.random.SeedSequence([seed % 2 ** 64, *words]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def images(seed: int, count: int, hw, device) -> torch.Tensor:
    """count normalized NHWC f32 images (as after the mean and std), drawn
    on the device in one call and handed back in pinned host memory, where
    a server's decoded images wait."""
    g = torch.Generator(device=device).manual_seed(substream(seed, "images"))
    x = torch.randn((count, *hw, 3), generator=g, device=device)
    host = torch.empty(x.shape, dtype=x.dtype,
                       pin_memory=torch.device(device).type == "cuda")
    return host.copy_(x)
