"""Declarative sharding rules: parameter, batch and cache trees -> specs,
and specs -> DTensor placements.  The port of ``repro.launch.sharding``.

A spec (:class:`P`) holds one entry per tensor dim: None, a mesh axis
name, or a tuple of names, as JAX's ``PartitionSpec``.  The rules read a
leaf's name and shape and are *divisibility-safe*: an axis whose size
does not divide its dim is replicated (``_fit``), as in the reference;
DTensor's uneven shards are never used, since they would place tensors
otherwise than the reference.  "data" carries FSDP, "model" TP / EP / SP
(``launch.mesh``).

Names are the port's: a module's ``state_dict`` names with the integer
layer index dropped (``blocks.3.attn.wq.w`` reads as
``blocks/attn/wq/w``).  The port holds one tensor per layer where the
reference stacks a leading ``(L, ...)`` axis, so a port leaf's spec is the
reference's without that leading None.  The caches are the port's per-layer
dicts: k / v (B, Hkv, T, hd), MLA c_kv / k_rope (B, T, r), Mamba-2 state
(B, H, N, P) and conv (B, W-1, C), a hybrid's per-group ``shared_attn``
caches, and ``pos`` (an int, or per slot a (B,) tensor whose spec is
``P()``).

``placements(spec, mesh)`` turns a spec into DTensor placements: a dim
over a tuple of axes, such as ``("pod", "data")``, is ``Shard(dim)`` on
each of those mesh dims, in mesh order.  ``place`` puts a tree (a dict of
tensors, a cache, or a module, whose parameters become DTensor
parameters in place) under them, and ``constrain`` is a ``redistribute``.
"""
from __future__ import annotations

import contextlib
import math
import re
import weakref
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from .mesh import mesh_axis_sizes


class P(tuple):
    """A PartitionSpec: one entry per tensor dim (None, an axis name, or a
    tuple of axis names; a tuple of one name is that name, as in JAX)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _axes(ent) -> Tuple[str, ...]:
    return ent if isinstance(ent, tuple) else (ent,)


def _fit(spec: P, shape: Sequence[int], mesh) -> P:
    """Drop spec entries that do not divide their dim; pad / trim rank."""
    sizes = mesh_axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ent in zip(shape, entries[:len(shape)]):
        if ent is None:
            out.append(None)
            continue
        prod = math.prod(sizes.get(a, 1) for a in _axes(ent))
        out.append(ent if dim % prod == 0 and prod > 1 else None)
    return P(*out)


# ------------------------------------------------------------- trees --
def tree_map(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(path, leaf, *rest_leaves)`` over nested dicts and lists (a
    path holds the dict keys and list indices, as strings)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _named(tree) -> Dict[str, Any]:
    """A module's parameters by name, or a dict of tensors as it is."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return tree


def rule_names(name: str) -> List[str]:
    """A ``state_dict`` name as the rules read it: split at the dots (or
    slashes), the integer layer indices dropped."""
    return [k for k in re.split(r"[./]", name) if k and not k.isdigit()]


# ------------------------------------------------------------- param rules --
def _param_rule(names: Sequence[str]) -> P:
    """Base spec by parameter role, right-aligned to the trailing dims."""
    last = names[-1] if names else ""
    joined = "/".join(names)

    if last == "embedding":                          # (V, d)
        return P("model", "data")
    if "moe" in joined and last in ("gate", "up"):   # (E, d, f) experts
        return P("model", "data", None)
    if "moe" in joined and last == "down":           # (E, f, d)
        return P("model", None, "data")
    if last in ("scale", "bias", "b", "A_log", "dt_bias", "D", "conv_b"):
        return P()                                   # small: replicate
    if last == "conv_w":                             # (W, conv_dim)
        return P(None, "model")
    if last == "w":
        parent = names[-2] if len(names) >= 2 else ""
        if parent in ("wo", "down", "out_proj", "wkv_b", "wq_b", "fc2"):
            # row-parallel: the contracted dim is model-sharded
            return P("model", "data")
        # column-parallel default: wq, wk, wv, gate, up, in_proj, router, ...
        return P("data", "model")
    return P()


def _aligned(base: P, ndim: int) -> P:
    if base and ndim > len(base):
        return P(*([None] * (ndim - len(base)) + list(base)))
    if base and ndim < len(base):
        return P(*list(base)[-ndim:]) if ndim else P()
    return base


def param_specs(params) -> Dict[str, P]:
    """A spec per parameter of ``params`` (a module, or a dict of tensors
    by ``state_dict`` name; meta tensors do)."""
    return {name: _aligned(_param_rule(rule_names(name)), t.dim())
            for name, t in _named(params).items()}


def fit_specs(specs, tree, mesh):
    """``_fit`` of every spec against its leaf's shape."""
    return tree_map(lambda _p, s, leaf: None if s is None
                    else _fit(s, leaf.shape, mesh), specs, _named(tree))


# ------------------------------------------------------------- batch rules --
def batch_spec(mesh) -> P:
    axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
    return P(axes) if axes else P()


def batch_specs(batch, mesh):
    bspec = batch_spec(mesh)

    def rule(_path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        if leaf.dim() == 0:
            return P()
        return _fit(P(bspec[0] if len(bspec) else None), leaf.shape, mesh)

    return tree_map(rule, batch)


# ------------------------------------------------------------- cache rules --
def cache_specs(cache, mesh):
    """KV / SSM cache specs: batch over (pod, data), heads over model.

    The port's per-layer layouts: k / v (B, Hkv, T, hd) shard the heads
    over "model" where they divide, else the time axis (a
    sequence-parallel cache: the long_500k / small-Hkv case); MLA c_kv /
    k_rope (B, T, r) shard T; Mamba-2 state (B, H, N, P) the heads and
    conv (B, W-1, C) the channels.  A tensor ``pos`` is ``P()``; an int
    one has no spec (None)."""
    b = batch_spec(mesh)
    bax = b[0] if len(b) else None
    msize = mesh_axis_sizes(mesh).get("model", 1)

    def rule(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        last = path[-1] if path else ""
        if last == "pos":
            return P()
        if last in ("k", "v"):                       # (B, Hkv, T, hd)
            if leaf.dim() == 4 and leaf.shape[1] % msize == 0:
                return _fit(P(bax, "model", None, None), leaf.shape, mesh)
            return _fit(P(bax, None, "model", None), leaf.shape, mesh)
        if last in ("c_kv", "k_rope"):               # (B, T, r)
            return _fit(P(bax, "model", None), leaf.shape, mesh)
        if last == "state":                          # (B, H, N, P)
            return _fit(P(bax, "model", None, None), leaf.shape, mesh)
        if last == "conv":                           # (B, W-1, C)
            return _fit(P(bax, None, "model"), leaf.shape, mesh)
        return _fit(P(bax), leaf.shape, mesh)

    return tree_map(rule, cache)


def strip_axis(specs, axis: str):
    """Remove one mesh axis from every spec (e.g. serving's TP-resident
    weights: ``steps.serve_shardings``)."""
    def strip(_path, sp):
        if sp is None:
            return None
        out = []
        for e in sp:
            if e == axis:
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a != axis)
                out.append(kept if kept else None)
            else:
                out.append(e)
        return P(*out)
    return tree_map(strip, specs)


# ------------------------------------------------------------- placements --
def placements(spec: P, mesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``: ``Shard(dim)`` on every mesh dim
    named at tensor dim ``dim`` (a tuple of axes in mesh order),
    ``Replicate()`` elsewhere."""
    names = list(mesh.mesh_dim_names)
    out: List[Placement] = [Replicate()] * len(names)
    for dim, ent in enumerate(spec):
        if ent is None:
            continue
        idx = [names.index(a) for a in _axes(ent)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {ent} are not in the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def shardings(tree, mesh, specs=None):
    """Placements per leaf of ``tree`` (a module or a dict of tensors),
    from ``specs`` (default ``param_specs(tree)``), fitted to the mesh."""
    if specs is None:
        specs = param_specs(tree)
    return tree_map(lambda _p, s: None if s is None else placements(s, mesh),
                    fit_specs(specs, tree, mesh))


def _as_placements(s, leaf, mesh) -> Tuple[Placement, ...]:
    if isinstance(s, P):
        return placements(_fit(s, leaf.shape, mesh), mesh)
    return tuple(s)


def _distribute(t: torch.Tensor, mesh, pl) -> DTensor:
    """``t`` under ``pl``, each rank taking its shard of its own ``t``.  A
    meta tensor (an abstract argument) becomes its shard's shape."""
    if t.is_meta:
        local = t
        for mesh_dim, p in enumerate(pl):
            if isinstance(p, Shard):
                n = mesh.size(mesh_dim)
                local = local.narrow(p.dim, 0, local.shape[p.dim] // n)
        return DTensor.from_local(torch.empty_like(local), mesh, pl,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    # every rank holds the whole tensor (seeded weights, the same batch,
    # a checkpoint each rank reads): each keeps its own shard of it, and
    # no rank scatters or broadcasts
    return distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)


def place(tree, mesh, specs):
    """``tree`` under ``specs`` (a tree of ``P`` or of placements): a dict
    or list tree of tensors comes back as DTensors (non-tensor leaves,
    such as an int ``pos``, as they are); a module has each parameter
    replaced in place by a DTensor parameter and is returned."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(mod_name)
            placed = _distribute(p.data, mesh,
                                 _as_placements(specs[name], p, mesh))
            mod._parameters[leaf] = nn.Parameter(placed,
                                                 requires_grad=p.requires_grad)
        return tree

    def put(_path, leaf, s):
        if not isinstance(leaf, torch.Tensor) or s is None:
            return leaf
        return _distribute(leaf, mesh, _as_placements(s, leaf, mesh))

    return tree_map(put, tree, specs)


def constrain(x, mesh, spec: P):
    """``x`` redistributed to ``spec`` (fitted; a plain tensor counts as
    replicated): the reference's ``with_sharding_constraint``."""
    pl = placements(_fit(spec, x.shape, mesh), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, pl)


# ------------------------------------------------------------- local views --
def leaves(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
        return
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def placements_of(tree):
    """Each DTensor leaf's placements (None for any other leaf): what
    ``place`` needs to put a like tree where ``tree`` is."""
    return tree_map(lambda _p, t: t.placements
                    if isinstance(t, DTensor) else None, tree)


def _replicated(t: DTensor) -> bool:
    return all(isinstance(p, Replicate) for p in t.placements)


def replicated(*trees) -> bool:
    """True when every DTensor among ``trees`` is replicated on every mesh
    dim (so each rank's local tensor is the whole tensor).  A module's
    answer is kept with its local views (``local_module``)."""
    for tree in trees:
        if isinstance(tree, nn.Module):
            if not _local_views(tree)[1]:
                return False
        elif not all(_replicated(t) for t in leaves(tree)
                     if isinstance(t, DTensor)):
            return False
    return True


def to_local(tree):
    """A dict / list tree with every DTensor replaced by its local
    tensor (sharing its storage, so in-place writes reach the DTensor)."""
    return tree_map(lambda _p, t: t.to_local()
                    if isinstance(t, DTensor) else t, tree)


# per module: (submodule, attribute, DTensor parameter, local parameter)
# for each DTensor parameter, and whether all are replicated; built at the
# module's first local view and kept while its parameters stay the same
_views: "weakref.WeakKeyDictionary[nn.Module, tuple]" = \
    weakref.WeakKeyDictionary()


def _local_views(model: nn.Module) -> tuple:
    cached = _views.get(model)
    if cached is not None and all(mod._parameters[leaf] is p
                                  for mod, leaf, p, _ in cached[0]):
        return cached
    views = []
    for name, p in model.named_parameters():
        if isinstance(p, DTensor):
            mod_name, _, leaf = name.rpartition(".")
            views.append((model.get_submodule(mod_name), leaf, p,
                          nn.Parameter(p.detach().to_local(),
                                       requires_grad=p.requires_grad)))
    cached = _views[model] = (views, all(_replicated(v[2]) for v in views))
    return cached


@contextlib.contextmanager
def local_module(model: nn.Module) -> Iterator[nn.Module]:
    """For the length of the block, ``model``'s DTensor parameters are
    replaced by parameters over their local tensors (the same storage, so
    an in-place update reaches the DTensor).  The views are made once per
    placement and reused, so a decode step pays only the swap."""
    views = _local_views(model)[0]
    for mod, leaf, p, local in views:
        local.requires_grad_(p.requires_grad)
        mod._parameters[leaf] = local
    try:
        yield model
    finally:
        for mod, leaf, p, local in views:
            p.requires_grad_(local.requires_grad)
            mod._parameters[leaf] = p
