"""Keyed dropout: the port's counterpart of flax's `nn.Dropout`, with a key
in place of an RNG stream.

A `DropoutKey` holds (seed, update, microbatch, rank, world size), the rank
and size on the data-parallel axis: the train step makes one a microbatch
(`parallel/steps.py`). Every dropout site draws its mask from a generator
seeded from (the key, the site's module path, the draw's index at that
site), so a recompute under remat, a resume and a rerun all give the same
mask, whatever generator state came before, and data shards, microbatches
and updates draw different masks. On a CUDA tensor the generator is a CUDA
`torch.Generator`: the mask is drawn on the card.

A site on an activation that a rank holds only a part of (the FFN hidden
features under mp, the encoder's tokens under sp) draws the whole
activation's mask and takes its part (`parts`), so a run at (dp, sp, mp)
draws the masks of a run at (dp, 1, 1).

The arithmetic is flax's: `where(keep, x / keep_prob, 0)` with `keep =
uniform < keep_prob` (`flax/linen/stochastic.py`). A site draws nothing
without a key (eval, inference) or at rate 0.

`supplied_masks(fn)` is a seam for tests: inside it every site takes its
keep mask from `fn(site, shape)` instead of drawing it.
"""

import contextlib
import hashlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

_supplied: Optional[Callable] = None


@dataclass(frozen=True)
class DropoutKey:
    seed: int
    update: int
    microbatch: int = 0
    rank: int = 0
    world: int = 1

    def generator(self, site: str, device) -> torch.Generator:
        """A generator on `device` seeded from the key and `site`."""
        text = (f"{self.seed}/{self.update}/{self.microbatch}/{self.rank}/"
                f"{self.world}/{site}")
        digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
        g = torch.Generator(device=device)
        g.manual_seed(int.from_bytes(digest, "little") >> 1)
        return g


@contextlib.contextmanager
def supplied_masks(fn: Callable):
    """Every site inside takes `fn(site, shape)` (a bool tensor, True =
    keep) as its mask."""
    global _supplied
    saved, _supplied = _supplied, fn
    try:
        yield
    finally:
        _supplied = saved


def name_sites(root: nn.Module):
    """Give every `Dropout` under `root` its module path as its site."""
    for name, mod in root.named_modules():
        if isinstance(mod, Dropout):
            mod.site = name
    return root


class Dropout(nn.Module):
    """One module's dropout sites; `index` tells a module's draws apart."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.site: Optional[str] = None

    def active(self, key: Optional[DropoutKey]) -> bool:
        return key is not None and self.rate > 0

    def keep(self, key: DropoutKey, shape, device, index: int = 0,
             parts=()):
        """The bool keep mask of draw `index` at this site. parts: ((dim,
        start, whole), ...): `shape` is the part from `start` of an
        activation `whole` long on `dim`, which may run past its end (pad
        tokens, kept)."""
        whole = list(shape)
        for dim, _, n in parts:
            whole[dim] = n
        site = f"{self.site}:{index}"
        if _supplied is not None:
            mask = _supplied(site, tuple(whole)).to(device)
        elif self.site is None:
            raise ValueError("a dropout site without a name: call "
                             "name_sites on the model that holds it")
        else:
            g = key.generator(site, device)
            mask = torch.rand(tuple(whole), generator=g, device=device) < (
                1.0 - self.rate)
        for dim, start, _ in parts:
            stop = start + shape[dim]
            if stop > mask.shape[dim]:
                pad = list(mask.shape)
                pad[dim] = stop - mask.shape[dim]
                mask = torch.cat([mask, mask.new_ones(pad)], dim=dim)
            mask = mask.narrow(dim, start, shape[dim])
        return mask

    def forward(self, x, key: Optional[DropoutKey], index: int = 0,
                parts=()):
        if not self.active(key):
            return x
        keep = self.keep(key, x.shape, x.device, index, parts)
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))
