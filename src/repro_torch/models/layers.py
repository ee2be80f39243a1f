"""Shared layers: the port of ``repro.models.layers``.

Parameters live in small ``nn.Module``s whose attribute names are the
reference pytree's keys (``w``, ``b``, ``scale``, ``embedding``), so a
flattened JAX params tree maps one to one onto a ``state_dict``; the
apply functions beside them take the module as the reference's take the
params dict.  The numerics follow the reference: ``dense`` is ``x @ w``
with w in (d_in, d_out) layout, ``rmsnorm`` and ``layernorm`` compute in
fp32 and cast back, the GELU MLP takes JAX's default (tanh) GELU,
``embed`` casts the table to the activation dtype, ``unembed`` is an
fp32 product against the table, rope rotates split halves, and
``cross_entropy`` is the mean token loss over labels that are not -100.
A block's apply runs under ``remat`` when the model trains (``cfg.remat``
and grad mode on), as the reference checkpoints its scan body.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype))
        self.b: Optional[nn.Parameter] = (
            nn.Parameter(torch.empty(d_out, dtype=dtype)) if bias else None)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype))


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p.scale.float()).to(dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(d, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(d, dtype=dtype))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """fp32 mean and population variance, ``rsqrt(var + eps)``, scale and
    bias in fp32, cast back (the reference's ``layernorm``)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p.scale.float() + p.bias.float()).to(dtype)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, d, dtype=dtype))


def embed(p: Embedding, ids: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return take_rows(p.embedding.to(dtype), ids)


def unembed(p: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits through the (tied) embedding table; fp32 output."""
    return x.float() @ p.embedding.float().T


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = Dense(d, d_ff, dtype=dtype)
        self.up = Dense(d, d_ff, dtype=dtype)
        self.down = Dense(d_ff, d, dtype=dtype)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return dense(p.down, F.silu(dense(p.gate, x)) * dense(p.up, x))


class GeluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up = Dense(d, d_ff, bias=True, dtype=dtype)
        self.down = Dense(d_ff, d, bias=True, dtype=dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (the erf form
    differs from it by up to about 5e-4)."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    return dense(p.down, gelu(dense(p.up, x)))


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: Optional[torch.device] = None,
               scaling=None) -> torch.Tensor:
    """(head_dim / 2,) inverse frequencies ``theta ** (-2i / head_dim)``;
    under YaRN ``scaling`` (a ``configs.RopeScaling``) pair i takes
    ``inv / factor · ramp(i) + inv · (1 - ramp(i))``, the ramp rising
    linearly from 0 at the correction range's low end to 1 at its high
    end.  Device ops only, so a captured step may compute it; the scaled
    form is kept per (width, theta, scaling, device) outside a capture."""
    if scaling is not None:
        key = (head_dim, theta, scaling, torch.device(device or "cpu"))
        inv = _YARN_FREQS.get(key)
        if inv is None:
            inv = _yarn_freqs(head_dim, theta, scaling, key[3])
            if not _capturing(key[3]):
                _YARN_FREQS[key] = inv
        return inv
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)      # (head_dim / 2,)


_YARN_FREQS: dict = {}


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _yarn_freqs(head_dim: int, theta: float, scaling,
                device: torch.device) -> torch.Tensor:
    inv = rope_freqs(head_dim, theta, device)
    low, high = scaling.correction_range(head_dim, theta)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0.0, 1.0)
    return inv / scaling.factor * ramp + inv * (1.0 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, scaling=None) -> torch.Tensor:
    """x (..., S, D) with D even; positions broadcastable to (..., S).
    ``scaling``: YaRN (``rope_freqs``), whose cos and sin are also scaled
    by its ``rope_mscale`` where that is not 1."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device, scaling)
    ang = positions[..., None].float() * inv           # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if scaling is not None and scaling.rope_mscale != 1.0:
        cos, sin = cos * scaling.rope_mscale, sin * scaling.rope_mscale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cache_pos(batch: int, per_slot_pos: bool,
              device: Optional[torch.device] = None):
    """A new cache's ``pos``: an int 0, or per slot (continuous batching) an
    int32 (batch,) zero tensor on ``device``."""
    if per_slot_pos:
        return torch.zeros(batch, dtype=torch.int32, device=device)
    return 0


class SlotStep(NamedTuple):
    """What one per-slot decode step (a (B,) ``pos``) shares between its
    layers, built once by ``transformer.decode_step``: every cache's next
    ``pos`` and, for KV caches of ``length`` slots, the write (row ``rows[b]``
    writes at ``at[b]`` where ``keep[b]``, i.e. pos < length: a lane past the
    end writes nothing) and the keys each row attends to (``valid``, (B,
    length))."""
    next_pos: torch.Tensor
    rows: Optional[torch.Tensor] = None
    at: Optional[torch.Tensor] = None
    keep: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None


def slot_step(pos: torch.Tensor, length: Optional[int] = None) -> SlotStep:
    """The ``SlotStep`` of a per-slot ``pos``; ``length`` None where the
    model holds no KV cache (an SSM stack)."""
    if length is None:
        return SlotStep(pos + 1)
    keys = torch.arange(length, device=pos.device)
    return SlotStep(pos + 1, torch.arange(pos.shape[0], device=pos.device),
                    pos.clamp(max=length - 1), pos < length,
                    keys[None, :] <= pos[:, None])


def _token_nll(logits: torch.Tensor, labels: torch.Tensor,
               z_weight: float) -> torch.Tensor:
    """Each position's loss (+ z-loss); a position without a label reads
    label 0 (the caller masks it)."""
    safe = torch.where(labels >= 0, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    # the label's logit by advanced indexing: its backward is an
    # index_put with accumulate, which has a deterministic CUDA kernel
    rows = logits.reshape(-1, logits.shape[-1])
    ll = rows[torch.arange(rows.shape[0], device=rows.device),
              safe.reshape(-1)].reshape(safe.shape)
    nll = logz - ll
    if z_weight:
        nll = nll + z_weight * logz.square()
    return nll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  z_weight: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy (+ optional z-loss) over the labels that are
    not negative (-100 marks a position without one), the reference's
    ``cross_entropy``; 0 where no label is valid.  On DTensors each rank
    reads its own rows' label logits (``local_map``)."""
    mask = labels >= 0
    nll = local_map(lambda lg, lb: _token_nll(lg, lb, z_weight),
                    (logits, labels), ((0,), (0,)), (0,))
    denom = mask.sum().clamp(min=1)
    return torch.where(mask, nll, 0.0).sum() / denom


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is, or a DTensor (a sharded step, ``launch.steps``)
    replicated on every mesh dim: the points where DTensor has no
    sharding strategy for the op that follows redistribute its operand
    here (ROADMAP queue 3 lists them)."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh,
                              [Replicate()] * t.device_mesh.ndim)
    return t


def splittable(t: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``t`` as it is, or a DTensor with its dim ``dim`` gathered (the
    mesh dims sharding it replicated) where their size does not divide
    ``outer``: DTensor cannot split a dim sharded n ways into (outer,
    rest) unless n divides outer (a redistribution point, as ``whole``;
    ``outer`` 1 gathers a sharded dim before an uneven ``torch.split``)."""
    if not isinstance(t, DTensor):
        return t
    pl = list(t.placements)
    n = 1
    for i, p in enumerate(pl):
        if p.is_shard(dim):
            n *= t.device_mesh.size(i)
    if outer % n == 0:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(dim)
                                          else p for p in pl])


def local_map(fn, args, specs, out_specs):
    """``fn(*args)``, or on DTensors (a sharded step) ``fn`` on each rank's
    local shards: a redistribution point for a stretch of ops that is
    independent along some dims (the batch, the heads) and that DTensor
    has no sharding strategy for.

    ``specs[i]`` names, per role, the dim of ``args[i]`` that carries it
    (a tuple such as ``(0, 1)`` for batch and heads, None for a role the
    argument lacks), or is None for an argument gathered whole (or a
    non-tensor passed as it is).  A mesh dim keeps sharding a role where
    the first DTensor with a spec shards that role's dim there and every
    argument's dim of that role divides; the arguments are redistributed
    to exactly that (a plain tensor counts as replicated and is sliced),
    everything else replicated.  ``out_specs`` give each output's dims by
    role (one tuple, or a list of them for a tuple of outputs).  On the
    way back, an argument's gradient is partial over the mesh dims it was
    not split along but the computation was."""
    lead = next((a for a, sp in zip(args, specs)
                 if sp is not None and isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    mesh = lead.device_mesh
    lead_spec = next(sp for a, sp in zip(args, specs) if a is lead)
    roles = [None] * mesh.ndim        # mesh dim -> the role it shards
    for i, pl in enumerate(lead.placements):
        if pl.is_shard() and pl.dim in lead_spec:
            roles[i] = lead_spec.index(pl.dim)
    for r in set(roles) - {None}:
        n = 1
        for i, ri in enumerate(roles):
            if ri == r:
                n *= mesh.size(i)
        if any(sp is not None and len(sp) > r and sp[r] is not None
               and isinstance(a, torch.Tensor) and a.shape[sp[r]] % n
               for a, sp in zip(args, specs)):
            roles = [None if ri == r else ri for ri in roles]

    def placements(sp):
        return [Shard(sp[r]) if r is not None and sp is not None
                and len(sp) > r and sp[r] is not None else Replicate()
                for r in roles]

    local = []
    for a, sp in zip(args, specs):
        if not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            if sp is None:
                local.append(a)
                continue
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        target = placements(sp)
        grads = [pl if pl.is_shard() else
                 (Partial() if r is not None else Replicate())
                 for pl, r in zip(target, roles)]
        local.append(a.redistribute(mesh, target).to_local(
            grad_placements=grads))
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, placements(sp),
                                        run_check=False)
                     for o, sp in zip(out, out_specs))
    return DTensor.from_local(out, mesh, placements(out_specs),
                              run_check=False)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; on DTensors, each rank's ids look up the whole
    table (``local_map``: the table gathered, the rows split as the ids
    are along their first dim)."""
    return local_map(lambda t, i: t[i], (table, ids), (None, (0,)), (0,))


def on_whole_module(module: nn.Module, fn, *args):
    """``fn(*args)``; where ``module``'s parameters or ``args`` hold a
    DTensor (a sharded step), every parameter and tensor argument is
    gathered whole (``whole``), ``fn`` runs on the local tensors (the
    module's parameters swapped for them for the call) and its tensor
    results come back replicated.  For a layer whose data-dependent
    scatters and gathers DTensor has no sharding strategy for."""
    named = list(module.named_parameters())
    mesh = next((t.device_mesh for t in (*args, *(p for _, p in named))
                 if isinstance(t, DTensor)), None)
    if mesh is None:
        return fn(*args)
    slots = []
    for name, _ in named:
        mod_name, _, leaf = name.rpartition(".")
        slots.append((module.get_submodule(mod_name), leaf))
    local = [whole(t).to_local() if isinstance(t, DTensor) else t
             for t in (*(p for _, p in named), *args)]
    saved = [mod._parameters[leaf] for mod, leaf in slots]
    for (mod, leaf), w in zip(slots, local):
        mod._parameters[leaf] = w
    try:
        out = fn(*local[len(named):])
    finally:
        for (mod, leaf), w in zip(slots, saved):
            mod._parameters[leaf] = w
    rep = [Replicate()] * mesh.ndim
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, rep, run_check=False)
                     for o in out)
    return DTensor.from_local(out, mesh, rep, run_check=False)


def placed(module: nn.Module, *tensors) -> bool:
    """Whether ``module``'s parameters or ``tensors`` hold a DTensor."""
    return any(isinstance(t, DTensor)
               for t in (*tensors, *module.parameters()))


def remat(cfg, fn, *args):
    """``fn(*args)``, recomputed in the backward pass instead of keeping its
    activations when the model trains (``cfg.remat`` and grad mode on): the
    reference's ``jax.checkpoint`` of a block.  Serving (``no_grad``) calls
    ``fn`` as it is.  The blocks draw no random numbers, so no RNG state is
    stashed."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)
