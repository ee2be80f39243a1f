"""Step builders and step timing: the port of ``repro.launch.steps``'s
``make_train_step`` and ``StepTimer``.

``make_train_step(cfg, optcfg, M)`` is the trainer's temporal pump (the
paper's mode T at the optimizer): with M > 1 a batch of M microbatches
(M, B / M, ...) runs M dependent gradient computations, the fast domain,
whose gradients add up in fp32 buffers, and then one optimizer update,
the wide transaction (with data parallelism, the one gradient
synchronization).  The step updates the model and the optimizer state in
place and returns its metrics.  The reference's abstract builders and
sharding rules (``train_shardings``, ``serve_shardings``) wait for the
distribution slice (ROADMAP queue 1 item 8b).

The first call of each phase counts as cold (kernel builds, cuBLAS
handles and allocator growth land there); later calls are steady state,
kept in an ``obs.Histogram`` per phase, so the percentile math lives in
one place, as in the reference.  On the card every step ends in
``torch.cuda.synchronize()``, so a time is the device's, not the time to
enqueue.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from repro_torch import obs, optim
from repro_torch.models import model as model_mod


def make_train_step(cfg, optcfg: optim.AdamWConfig, pump_factor: int = 1):
    """``train_step(model, opt_state, batch) -> metrics`` (``loss``,
    ``grad_norm``, ``lr``: 0-dim tensors on the device), updating
    ``model`` and ``opt_state`` in place.

    At M > 1 the batch leads with the microbatch axis; each microbatch's
    gradient (in the parameters' dtype) is added into fp32 buffers, as the
    reference's fp32 zeros carry its scan, and the sum and the losses are
    scaled by 1 / M.  At M 1 the gradient stays in the parameters' dtype
    until ``optim.update`` casts it, as in the reference.  Frozen
    parameters (``convert`` returns its models frozen) are unfrozen: every
    parameter trains.  The step runs with grad mode on."""

    def grads_of(model, named, batch):
        loss = model_mod.loss_fn(cfg, model, batch)
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 allow_unused=True)
        return loss, {n: torch.zeros_like(p) if g is None else g
                      for (n, p), g in zip(named, gs)}

    def train_step(model, opt_state: optim.AdamWState, batch) -> Dict:
        model.requires_grad_(True)
        named = list(model.named_parameters())
        with torch.enable_grad():
            if pump_factor > 1:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=named[0][1].device)
                acc = {n: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device) for n, p in named}
                for i in range(pump_factor):
                    mb_loss, gs = grads_of(
                        model, named, {k: v[i] for k, v in batch.items()})
                    loss = loss + mb_loss.detach()
                    for n, g in gs.items():
                        acc[n] += g
                    del gs
                inv = 1.0 / pump_factor
                loss = loss * inv
                grads = {n: g.mul_(inv) for n, g in acc.items()}
            else:
                loss, grads = grads_of(model, named, batch)
                loss = loss.detach()
        metrics = optim.update(optcfg, grads, opt_state, model)
        metrics["loss"] = loss
        return metrics

    return train_step


class StepTimer:
    def __init__(self, device: torch.device):
        self._sync = device.type == "cuda"
        self.cold_s: Dict[str, float] = {}
        self._warm: Dict[str, obs.Histogram] = {}

    def run(self, phase: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if phase not in self.cold_s:
            self.cold_s[phase] = dt
        else:
            hist = self._warm.get(phase)
            if hist is None:
                hist = self._warm[phase] = obs.Histogram()
            hist.record(dt)
        return out

    @property
    def steady(self) -> Dict[str, List[float]]:
        """Raw warm samples per phase (a view over the histograms)."""
        return {phase: h.values for phase, h in self._warm.items()}

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per phase: the cold call, the steady-state mean, p50, p99 and
        best, and the reference's explicit ``cold`` / ``warm`` split."""
        out = {}
        for phase, cold in self.cold_s.items():
            h = self._warm.get(phase)
            n = h.count if h else 0
            p50 = h.percentile(50) if h else None
            p99 = h.percentile(99) if h else None
            out[phase] = {
                "cold_s": cold,
                "steps": n,
                "steady_mean_s": h.mean if h else None,
                "steady_p50_s": p50,
                "steady_p99_s": p99,
                "steady_best_s": h.min if h else None,
                "cold": {"calls": 1, "total_s": cold},
                "warm": {
                    "calls": n,
                    "total_s": h.total if h else 0.0,
                    "mean_s": h.mean if h else None,
                    "best_s": h.min if h else None,
                    "p50_s": p50,
                    "p90_s": h.percentile(90) if h else None,
                    "p99_s": p99,
                },
            }
        return out
