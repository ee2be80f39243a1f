"""Parameters: load the reference's params tree, or draw fresh ones.

``from_jax_params`` takes the JAX params pytree with its leaves already
converted to numpy arrays (the caller does that; this module imports no
JAX), un-stacks the leading layer axis of each scanned segment
(``"blocks"``, and ``"blocks_dense"`` in an MoE tree) and loads every leaf
into the port's modules.  ``init_params`` draws with the reference init's
distributions (``repro/models/layers.py``, ``ssm.py:27-46``,
``moe.py:113-129``): dense weights normal · 1/√d_in, the embedding normal
· 0.02, norm scales ones, biases zeros; in a Mamba-2 mixer ``conv_w``
normal · 0.1, ``conv_b`` and ``dt_bias`` zeros, ``A_log = log(linspace(1,
16, H))`` and ``D`` ones; the routed experts' stacked ``gate`` and ``up``
normal · 1/√d, ``down`` normal · 1/√d_expert.
The numbers differ from JAX's for the same seed; tests hand weights
across with ``from_jax_params`` instead.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from . import model as model_mod
from .layers import Dense, Embedding, RMSNorm
from .moe import MoE
from .ssm import Mamba2
from .transformer import _segments


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def from_jax_params(cfg, tree: Mapping[str, Any], *,
                    device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None):
    """The reference params tree (numpy leaves) as a port model.  ``dtype``
    defaults to the leaves' own (fp32 for the reference's default init)."""
    stacked = tuple(f"{name}." for name, _, _ in _segments(cfg))
    state: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        t = torch.tensor(np.asarray(arr))
        seg = next((p for p in stacked if name.startswith(p)), None)
        if seg is None:
            state[name] = t
            continue
        rest = name[len(seg):]
        for i in range(t.shape[0]):
            state[f"{seg}{i}.{rest}"] = t[i]
    dtype = dtype or next(iter(state.values())).dtype
    with torch.device(device or "cpu"):
        model = model_mod.build(cfg, dtype)
    model.load_state_dict(state, strict=True)
    return model.requires_grad_(False)


@torch.no_grad()
def init_params(cfg, generator: torch.Generator,
                device: Optional[torch.device] = None,
                dtype: torch.dtype = torch.float32):
    """Seeded random weights with the reference init's distributions.
    Draws happen on the generator's device, in fp32, then cast."""
    with torch.device(device or "cpu"):
        model = model_mod.build(cfg, dtype)
    for mod in model.modules():
        if isinstance(mod, Dense):
            d_in = mod.w.shape[0]
            mod.w.copy_(_normal(mod.w.shape, generator) / math.sqrt(d_in))
            if mod.b is not None:
                mod.b.zero_()
        elif isinstance(mod, Embedding):
            mod.embedding.copy_(_normal(mod.embedding.shape, generator) * 0.02)
        elif isinstance(mod, RMSNorm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, Mamba2):
            mod.conv_w.copy_(_normal(mod.conv_w.shape, generator) * 0.1)
            mod.conv_b.zero_()
            mod.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, mod.A_log.shape[0], device=generator.device)))
            mod.dt_bias.zero_()
            mod.D.fill_(1.0)
        elif isinstance(mod, MoE):
            d, de = mod.gate.shape[1], mod.gate.shape[2]
            for w, fan_in in ((mod.gate, d), (mod.up, d), (mod.down, de)):
                w.copy_(_normal(w.shape, generator) / math.sqrt(fan_in))
    return model.requires_grad_(False)


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)
