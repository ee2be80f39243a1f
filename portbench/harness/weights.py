"""Seeded weights, drawn on the device in the type they are served in.

One flat buffer holds every leaf of the family reference's list, filled by
``normal_`` from one ``torch.Generator`` seeded with ``--seed`` in a few
large calls, then each leaf scaled and shifted in place.  The same seed on
the same device and build gives the same bits, so the reference redraws
them after the program is freed instead of keeping a copy.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch import nn

from portbench.reference.common import Leaf

CALL = 1 << 30          # elements a normal_ call fills


class Draw:
    def __init__(self, leaves: List[Leaf], seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16):
        self.leaves = leaves
        total = sum(math.prod(shape) for _n, shape, _m, _s in leaves)
        self.flat = torch.empty(total, dtype=dtype, device=device)
        self.views: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape, _mean, _std in leaves:
            n = math.prod(shape)
            self.views[name] = self.flat[off:off + n].view(shape)
            off += n
        self.fill(seed)

    def fill(self, seed: int) -> None:
        """Every leaf drawn anew from ``seed``, in place."""
        gen = torch.Generator(device=self.flat.device)
        gen.manual_seed(seed % (1 << 63))
        for a in range(0, self.flat.numel(), CALL):
            self.flat[a:a + CALL].normal_(generator=gen)
        for name, _shape, mean, std in self.leaves:
            v = self.views[name]
            v.mul_(std)
            if mean:
                v.add_(mean)

    def fp32(self, name: str) -> torch.Tensor:
        return self.views[name].float()


def load_into(model: nn.Module, draw: Draw) -> None:
    """Make every parameter of ``model`` (built on the meta device) the
    draw's leaf of the same name; every leaf and every parameter must
    meet, shapes equal."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(draw.views))
    extra = sorted(set(draw.views) - set(params))
    if missing or extra:
        raise ValueError(f"weights and model disagree: the model's "
                         f"{missing[:5]} have no leaf, the leaves "
                         f"{extra[:5]} no parameter")
    for name, p in params.items():
        v = draw.views[name]
        if tuple(v.shape) != tuple(p.shape):
            raise ValueError(f"{name}: leaf {tuple(v.shape)} against "
                             f"parameter {tuple(p.shape)}")
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(v, requires_grad=False))
