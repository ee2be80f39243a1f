"""Step builders and step timing: the port of ``repro.launch.steps``.

``make_train_step(cfg, optcfg, M)`` is the trainer's temporal pump (the
paper's mode T at the optimizer): with M > 1 a batch of M microbatches
(M, B / M, ...) runs M dependent gradient computations, the fast domain,
whose gradients add up in fp32 buffers, and then one optimizer update,
the wide transaction (with data parallelism, the one gradient
synchronization).  The step updates the model and the optimizer state in
place and returns its metrics.  ``make_prefill_step`` and
``make_decode_step`` are the serving steps.

**Shardings.**  ``abstract_params`` / ``abstract_opt_state`` /
``abstract_batch`` / ``abstract_decode_batch`` / ``abstract_cache`` build
every argument on the ``meta`` device (shapes and dtypes, no memory, no
draw: deepseek-v3-671b's 671 B parameters take none), with the
reference's dtypes (int32 tokens, a bf16 cache).  ``train_shardings`` and
``serve_shardings`` give their placements under a mesh's rules
(``launch.sharding``): the optimizer state's specs widened over ("pod",
"data") on a multi-pod mesh (ZeRO across pods), the serving weights
TP-resident ("data" stripped) for every family but MoE.

**How a step runs on placed arguments.**  Where every DTensor among its
arguments is replicated on every mesh dim (the card's 1 x 1 host mesh
always is), a step runs the direct path on the local tensors
(``sharding.local_module`` / ``sharding.to_local``), so the kernels see
plain tensors and the results are the direct path's, bit for bit.
Otherwise it runs the model on DTensors under ``implicit_replication``
(a plain tensor made inside the model, such as a mask or the rope
table, counts as replicated) and DTensor's sharding propagation places
the collectives; the hand-written kernels refuse DTensors
(``kernels.ops._launch``), so a sharded step takes the plain routes.
Where DTensor has no sharding strategy for an op, the model
redistributes that operand there (``sharding.gather``).

The first call of each timed phase counts as cold (kernel builds, cuBLAS
handles and allocator growth land there); later calls are steady state,
kept in an ``obs.Histogram`` per phase, so the percentile math lives in
one place, as in the reference.  On the card every step ends in
``torch.cuda.synchronize()``, so a time is the device's, not the time to
enqueue.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import obs, optim
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import model as model_mod

from . import sharding as shard_mod
from .sharding import P


def _full(t):
    """A DTensor's whole value (a collective); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local_opt(state: optim.AdamWState) -> optim.AdamWState:
    return optim.AdamWState(**shard_mod.to_local(state.tree()))


@contextlib.contextmanager
def on_mesh(model, *trees):
    """A step's view of its arguments: ``model`` over its local tensors
    where every DTensor among them is replicated (yields True; the
    caller takes ``sharding.to_local`` of the trees), else the DTensors
    themselves under ``implicit_replication`` (yields False)."""
    if shard_mod.replicated(model, *trees):
        with shard_mod.local_module(model):
            yield True
    else:
        with implicit_replication():
            yield False


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
    parameter trains.  The step runs with grad mode on.  On DTensor
    arguments the metrics come back whole (module docstring)."""

    def grads_of(model, named, batch):
        loss = model_mod.loss_fn(cfg, model, batch)
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 allow_unused=True)
        return loss, {n: torch.zeros_like(p) if g is None else g
                      for (n, p), g in zip(named, gs)}

    def direct(model, opt_state: optim.AdamWState, batch) -> Dict:
        model.requires_grad_(True)
        named = list(model.named_parameters())
        with torch.enable_grad():
            if pump_factor > 1:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=named[0][1].device)
                acc = {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in named}
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

    def train_step(model, opt_state: optim.AdamWState, batch) -> Dict:
        with on_mesh(model, opt_state.tree(), batch) as local:
            if local:
                return direct(model, _local_opt(opt_state),
                              shard_mod.to_local(batch))
            metrics = direct(model, opt_state, batch)
            return {k: _full(v) for k, v in metrics.items()}

    return train_step


# ----------------------------------------------------------- abstract trees --
def abstract_params(cfg, param_dtype: torch.dtype = torch.bfloat16):
    """The model's module tree on ``meta``: every parameter's shape and
    dtype, no memory, nothing drawn."""
    with torch.device("meta"):
        return model_mod.build(cfg, param_dtype)


def abstract_opt_state(optcfg: optim.AdamWConfig, params) -> optim.AdamWState:
    """``optim.init`` of meta parameters: the state's shapes and dtypes."""
    return optim.init(optcfg, params)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(cfg, shape: ShapeConfig,
                   pump_factor: int = 1) -> Dict[str, torch.Tensor]:
    """One global training batch on ``meta``: int32 tokens and labels (B,
    S), or (M, B / M, S) under a pump of M (the wide transaction stays B x
    S tokens; M is the temporal packing inside it), with fp32 frames
    (encdec) or patches (vlm)."""
    b, s = shape.global_batch, shape.seq_len
    if pump_factor > 1:
        if b % pump_factor:
            raise ValueError(f"pump factor {pump_factor} does not divide "
                             f"the global batch {b}")
        lead = (pump_factor, b // pump_factor)
    else:
        lead = (b,)
    batch = {"tokens": _meta(lead + (s,), torch.int32),
             "labels": _meta(lead + (s,), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _meta(lead + (cfg.encoder_seq, cfg.d_model),
                                torch.float32)
    if cfg.family == "vlm":
        batch["patches"] = _meta(lead + (cfg.n_vision_tokens, cfg.d_vision),
                                 torch.float32)
    return batch


def abstract_decode_batch(cfg, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    batch = {"tokens": _meta((b, 1), torch.int32)}
    if cfg.family == "encdec":
        batch["enc_out"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16)
    return batch


def abstract_cache(cfg, shape: ShapeConfig,
                   cache_dtype: torch.dtype = torch.bfloat16):
    return model_mod.init_cache(cfg, shape.global_batch, shape.seq_len,
                                cache_dtype, torch.device("meta"))


# ---------------------------------------------------------------- shardings --
def _widen(spec: P) -> P:
    """ZeRO across pods: the FSDP axis "data" widened to ("pod", "data")."""
    return P(*[("pod", e) if e == "data"
               else (("pod",) + e if isinstance(e, tuple) and "data" in e
                     else e) for e in spec])


def opt_specs(params, mesh) -> Dict[str, P]:
    """The optimizer state's specs (master, m and v): the parameters', and
    on a mesh with a "pod" axis, widened over ("pod", "data") (params stay
    pod-replicated; the larger optimizer state divides across all
    chips)."""
    pspecs = shard_mod.fit_specs(shard_mod.param_specs(params), params, mesh)
    if "pod" not in mesh.mesh_dim_names:
        return pspecs
    return shard_mod.fit_specs({n: _widen(s) for n, s in pspecs.items()},
                               params, mesh)


def train_shardings(cfg, optcfg: optim.AdamWConfig, mesh, shape: ShapeConfig,
                    param_dtype: torch.dtype = torch.bfloat16,
                    pump_factor: int = 1):
    """(in_shardings, out_shardings, abstract args) for
    ``make_train_step``: placements per leaf of (params, opt_state,
    batch) and of (params, opt_state, metrics)."""
    params = abstract_params(cfg, param_dtype)
    opt_state = abstract_opt_state(optcfg, params)
    batch = abstract_batch(cfg, shape, pump_factor)

    p_shard = shard_mod.shardings(params, mesh)
    ospecs = opt_specs(params, mesh)
    rep = shard_mod.placements(P(), mesh)
    o_shard = optim.AdamWState(
        step=rep,
        master={n: shard_mod.placements(s, mesh) for n, s in ospecs.items()},
        m={n: shard_mod.placements(s, mesh) for n, s in ospecs.items()},
        v={n: shard_mod.placements(s, mesh) for n, s in ospecs.items()})
    b_shard = {k: shard_mod.placements(s, mesh)
               for k, s in train_batch_specs(batch, mesh,
                                             pump_factor).items()}
    metrics_shard = {"loss": rep, "grad_norm": rep, "lr": rep}
    in_sh = (p_shard, o_shard, b_shard)
    out_sh = (p_shard, o_shard, metrics_shard)
    return in_sh, out_sh, (params, opt_state, batch)


def train_batch_specs(batch, mesh, pump_factor: int = 1) -> Dict[str, P]:
    """A training batch's specs: the batch dim over ("pod", "data"), the
    second dim when pumped (the microbatch axis leads)."""
    bsp = shard_mod.batch_spec(mesh)
    bax = bsp[0] if len(bsp) else None
    bdim = 1 if pump_factor > 1 else 0

    def spec(t):
        entries = [None] * t.dim()
        if t.dim() > bdim:
            entries[bdim] = bax
        return shard_mod._fit(P(*entries), t.shape, mesh)

    return {k: spec(t) for k, t in batch.items()}


# ------------------------------------------------------------ serving steps --
def make_prefill_step(cfg, last_only: bool = True):
    """``prefill_step(model, batch) -> logits``: the forward pass over a
    whole prompt.  Serving reads only the final position's logits; pass
    ``last_only=False`` for scoring, which needs them all."""

    @torch.no_grad()
    def prefill_step(model, batch):
        with on_mesh(model, batch) as local:
            b = shard_mod.to_local(batch) if local else batch
            logits, _ = model_mod.forward(cfg, model, b, last_only=last_only)
            return logits

    return prefill_step


def make_decode_step(cfg):
    """``decode_step(model, cache, batch) -> (logits, new_cache)``: one
    cached step (tokens (B, 1)), or with (B, S) tokens on a fresh cache a
    cached prefill that fills it.  The cache is written in place."""

    @torch.no_grad()
    def decode_step(model, cache, batch):
        with on_mesh(model, cache, batch) as local:
            if local:
                logits, new = model_mod.decode_step(
                    cfg, model, shard_mod.to_local(batch),
                    shard_mod.to_local(cache))
                return logits, _advance(cache, new)
            return model_mod.decode_step(cfg, model, batch, cache)

    return decode_step


def _advance(placed, new):
    """The placed cache after a step on its local tensors: a leaf written
    in place (the KV rows) stays the DTensor it was, a tensor the step
    made anew (an SSM state, a per-slot ``pos``) is wrapped under the old
    leaf's placements, and an int ``pos`` is the new one."""
    def leaf(_path, old, nw):
        if not isinstance(old, DTensor):
            return nw
        if nw.data_ptr() == old.to_local().data_ptr():
            return old
        return DTensor.from_local(nw, old.device_mesh, old.placements,
                                  run_check=False)
    return shard_mod.tree_map(leaf, placed, new)


def serve_param_specs(cfg, params, fsdp: bool = False) -> Dict[str, P]:
    """The serving weights' specs: the rule table's, with "data" stripped
    (TP-resident) unless ``fsdp`` or the family is MoE."""
    pspecs = shard_mod.param_specs(params)
    if not fsdp and cfg.family != "moe":
        pspecs = shard_mod.strip_axis(pspecs, "data")
    return pspecs


def serve_shardings(cfg, mesh, shape: ShapeConfig,
                    param_dtype: torch.dtype = torch.bfloat16,
                    fsdp: bool = False):
    """Decode-path placements (params, cache, batch) and the abstract
    arguments.  ``fsdp=False`` keeps the weights TP-resident (sharded over
    "model" only): per-token FSDP all-gathers cost a decode step more than
    they save.  MoE keeps FSDP: only top-k of E experts touch a token, so
    gathering the small active slices beats holding every expert
    resident."""
    params = abstract_params(cfg, param_dtype)
    cache = abstract_cache(cfg, shape)
    batch = abstract_decode_batch(cfg, shape)
    pspecs = serve_param_specs(cfg, params, fsdp)
    p_shard = shard_mod.shardings(params, mesh, pspecs)
    c_shard = shard_mod.tree_map(
        lambda _p, s: None if s is None else shard_mod.placements(s, mesh),
        shard_mod.cache_specs(cache, mesh))
    b_shard = {k: shard_mod.placements(
        shard_mod._fit(shard_mod.batch_spec(mesh) if t.dim() else P(),
                       t.shape, mesh), mesh) for k, t in batch.items()}
    return p_shard, c_shard, b_shard, (params, cache, batch)


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
