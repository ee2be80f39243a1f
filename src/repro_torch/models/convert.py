"""Parameters: load the reference's params tree, or draw fresh ones.

``from_jax_params`` takes the JAX params pytree with its leaves already
converted to numpy arrays (the caller does that; this module imports no
JAX), un-stacks the leading layer axis of each scanned segment
(``"blocks"``, and ``"blocks_dense"`` in an MoE tree) and loads every leaf
into the port's modules; a hybrid tree's ``shared_attn`` and a
deepseek-v3 tree's ``mtp`` are single blocks, not stacked, and load as
they are.  An enc-dec tree stacks ``enc_blocks`` and ``dec_blocks``
(``frontend_proj``, ``enc_norm``, ``embed`` and ``dec_norm`` load as they
are); a VLM tree is the dense tree plus its ``projector``.
``init_params`` draws with the reference init's distributions
(``repro/models/layers.py``, ``ssm.py:27-46``, ``moe.py:113-129``): dense
weights normal · 1/√d_in, the embedding normal · 0.02, norm scales ones,
LayerNorm and dense biases zeros; in a Mamba-2 mixer ``conv_w`` normal ·
0.1, ``conv_b`` and ``dt_bias`` zeros, ``A_log = log(linspace(1, 16,
H))`` and ``D`` ones; the routed experts' stacked ``gate`` and ``up``
normal · 1/√d, ``down`` normal · 1/√d_expert.
The numbers differ from JAX's for the same seed; tests hand weights
across with ``from_jax_params`` instead.  A tensor of more than
``CHUNKED_DRAW`` elements is drawn in slices of its leading dim, so the
fp32 draw never holds a copy of a whole expert stack (deepseek-v3's are
3.8 G elements, 15 GB in fp32).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import model as model_mod
from .layers import Dense, Embedding, LayerNorm, RMSNorm
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


def _stacked(cfg) -> Tuple[str, ...]:
    """The tree's scanned segments, whose leaves lead with a layer axis."""
    if cfg.family == "encdec":
        return ("enc_blocks", "dec_blocks")
    return tuple(name for name, _, _ in _segments(cfg))


def from_jax_params(cfg, tree: Mapping[str, Any], *,
                    device: Optional[torch.device] = None,
                    dtype: Optional[torch.dtype] = None):
    """The reference params tree (numpy leaves) as a port model.  ``dtype``
    defaults to the leaves' own (fp32 for the reference's default init)."""
    stacked = tuple(f"{name}." for name in _stacked(cfg))
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
            _draw(mod.w, generator, div=math.sqrt(mod.w.shape[0]))
            if mod.b is not None:
                mod.b.zero_()
        elif isinstance(mod, Embedding):
            _draw(mod.embedding, generator, mul=0.02)
        elif isinstance(mod, RMSNorm):
            mod.scale.fill_(1.0)
        elif isinstance(mod, LayerNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, Mamba2):
            _draw(mod.conv_w, generator, mul=0.1)
            mod.conv_b.zero_()
            mod.A_log.copy_(torch.log(torch.linspace(
                1.0, 16.0, mod.A_log.shape[0], device=generator.device)))
            mod.dt_bias.zero_()
            mod.D.fill_(1.0)
        elif isinstance(mod, MoE):
            d, de = mod.gate.shape[1], mod.gate.shape[2]
            for w, fan_in in ((mod.gate, d), (mod.up, d), (mod.down, de)):
                _draw(w, generator, div=math.sqrt(fan_in))
    return model.requires_grad_(False)


def _normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32)


# above this many elements a weight is drawn a slice of its leading dim at a
# time (about 2^26 elements a slice)
CHUNKED_DRAW = 1 << 28


def _draw(w: torch.Tensor, generator: torch.Generator, *, mul: float = 1.0,
          div: float = 1.0) -> None:
    """w <- normal · mul / div, drawn in fp32 and cast; in slices of w's
    leading dim where w has more than ``CHUNKED_DRAW`` elements."""
    if w.numel() <= CHUNKED_DRAW:
        w.copy_(_normal(w.shape, generator) * mul / div)
        return
    step = max(1, (1 << 26) // (w.numel() // w.shape[0]))
    for i in range(0, w.shape[0], step):
        part = w[i:i + step]
        part.copy_(_normal(part.shape, generator) * mul / div)
