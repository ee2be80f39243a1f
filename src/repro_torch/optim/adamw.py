"""AdamW with mixed-precision state and gradient clipping: the port of
``repro.optim.adamw``.

State, keyed by parameter name (``model.named_parameters()``):

    master : fp32 copy of each parameter (the parameters may be bf16)
    m, v   : first and second moments in ``moment_dtype`` (bf16 halves
             the optimizer state's memory)
    step   : a 0-dim int32 counter on the parameters' device

The rules are the reference's: linear warmup then cosine decay to
``min_lr_ratio`` in fp32, clipping by the global norm, weight decay on
every parameter (norm scales and embeddings included), and the new
parameter is the new master cast to the parameter's dtype.  ``update``
works in place: the state's tensors and the module's parameters (under
``no_grad``) are overwritten, so a step holds no second copy of either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" halves state memory
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor                 # 0-dim int32
    master: Dict[str, torch.Tensor]
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]

    def tree(self) -> Dict:
        """The state as a tree of named tensors (what a checkpoint holds)."""
        return {"step": self.step, "master": self.master, "m": self.m,
                "v": self.v}


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``like``'s device: a true divisor (CUDA
    divides by a host scalar through its reciprocal, which rounds
    otherwise)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in fp32 on the
    step's device (a 0-dim tensor)."""
    step = step.float()
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init(cfg: AdamWConfig, model: nn.Module) -> AdamWState:
    mdt = getattr(torch, cfg.moment_dtype)
    named = list(model.named_parameters())
    dev = named[0][1].device
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=dev),
        {n: p.detach().float().clone() for n, p in named},
        {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
         for n, p in named},
        {n: torch.zeros(p.shape, dtype=mdt, device=p.device)
         for n, p in named})


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in fp32."""
    return torch.sqrt(torch.stack([t.float().square().sum()
                                   for t in tensors]).sum())


def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: AdamWState, model: nn.Module) -> Dict[str, torch.Tensor]:
    """One AdamW step from ``grads`` (by parameter name, any float dtype),
    in place on ``state`` and on ``model``'s parameters.  Returns the
    metrics ``grad_norm`` and ``lr`` (0-dim tensors on the device)."""
    state.step += 1
    lr = schedule(cfg, state.step)
    gnorm = global_norm(grads.values())
    scale = torch.clamp(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9),
                        max=1.0) if cfg.grad_clip else _f32(1.0, gnorm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = state.step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    with torch.no_grad():
        for name, p in model.named_parameters():
            g = grads[name].float() * scale
            master, m, v = state.master[name], state.m[name], state.v[name]
            m32 = m.float() * b1 + g * (1 - b1)
            v32 = v.float() * b2 + g.square() * (1 - b2)
            mhat = m32 / bc1
            vhat = v32 / bc2
            master.copy_(master - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                                        + cfg.weight_decay * master))
            m.copy_(m32)
            v.copy_(v32)
            p.copy_(master)
    return {"grad_norm": gnorm, "lr": lr}
