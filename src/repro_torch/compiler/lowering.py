"""Graph→PyTorch lowering backend (``backend='torch'``).

Compiles a (possibly streamed + multi-pumped) dataflow :class:`Graph` into a
callable with the same semantics as the numpy reference executor
(:mod:`repro_torch.core.executor`), which stays around as the differential-
testing oracle.  It is the counterpart of the reference's per-node
``backend='jax'`` lowering; PyTorch runs eagerly, so there is no jit step.
The lowering is a topological module schedule:

===========  ================================================================
IR node      PyTorch realization
===========  ================================================================
Memory       input tensor (or zeros) threaded through functionally
Reader       gather ``flat[idx]`` with addresses precomputed from the
             symbolic access pattern at lowering time
Writer       scatter into a copy of the memory, ``flat[idx] = seq``
Sync         value identity (the clock-domain-crossing synchronizer; eager
             PyTorch has no scheduling barrier to place)
Issuer /     temporal re-chunking: a loop over the pump factor M copying one
Packer       narrow phase per iteration (value identity — the paper's
             gearbox moves M narrow beats per wide transaction)
Compute      the node's ``fn`` body applied to its FIFO-ordered operand
             sequences; ``fn`` must be numpy/torch polymorphic.  Sequential-
             carry computes (``meta['carry']``) lower to a loop over the step
             domain: per-step operand blocks are cut from the sequences and
             the loop-carried state threads through, resetting at each sweep
             of the carry axis (see :func:`carry_sequence_apply`)
Stream       value pass-through (FIFO order is the sequence order)
===========  ================================================================

Scatter targets with duplicate addresses are rejected at lowering time with
:class:`LoweringError`: the reference executor's last-write-wins order is
numpy-specific, and an indexed tensor store makes no ordering guarantee, so
a duplicate-address scatter would silently give device-dependent results.
The error message names the offending producer→memory edge.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from ..core.executor import _toposort, carry_layout, sink_access
from ..core.ir import Graph, NodeKind, PumpSpec


class LoweringError(RuntimeError):
    pass


def torch_dtype(name: str) -> torch.dtype:
    """A memory node's dtype string as a torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise LoweringError(f"memory dtype {name!r} has no torch counterpart")
    return dt


def as_tensor(value, dtype: str, device: torch.device) -> torch.Tensor:
    """An input (tensor or array) as a tensor of the memory's dtype; a
    tensor stays on its own device, anything else goes to ``device``."""
    dt = torch_dtype(dtype)
    if isinstance(value, torch.Tensor):
        return value.to(dt)
    return torch.as_tensor(np.asarray(value), device=device).to(dt)


def init_memories(g: Graph, inputs: Mapping[str, Any],
                  device: torch.device, skip=()) -> Dict[str, torch.Tensor]:
    """Every memory of ``g`` but those in ``skip``: the given inputs, zeros
    for the rest, on the inputs' device (``device`` when no input is a
    tensor)."""
    for v in inputs.values():
        if isinstance(v, torch.Tensor):
            device = v.device
            break
    mems: Dict[str, torch.Tensor] = {}
    for n in g.nodes.values():
        if n.kind != NodeKind.MEMORY or (n.name in skip
                                         and n.name not in inputs):
            continue
        if n.name in inputs:
            mems[n.name] = as_tensor(inputs[n.name], n.dtype, device)
        else:
            mems[n.name] = torch.zeros(n.shape, dtype=torch_dtype(n.dtype),
                                       device=device)
    return mems


class IndexCache:
    """Frozen gather / scatter addresses, uploaded once per device."""

    def __init__(self, idx: np.ndarray):
        self.host = idx
        self._on: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = torch.as_tensor(self.host, device=device)
        return t


def _temporal_rechunk(seq: torch.Tensor, factor: int,
                      warn: Optional[Callable[[str], None]] = None,
                      name: str = "") -> torch.Tensor:
    """Issuer/packer body: re-emit ``seq`` as ``factor`` narrow phases.

    Value-identity on the flattened FIFO sequence (a wide transaction of M·V
    elements is exactly its M consecutive narrow beats).  A sequence length
    not divisible by ``factor`` cannot be re-chunked into M equal beats; the
    gearbox degrades to a pass-through (still value-exact) and reports the
    misaligned pump factor through ``warn``."""
    flat = seq.reshape(-1)
    n = flat.shape[0]
    if factor <= 1:
        return flat
    if n % factor:
        if warn is not None:
            warn(f"temporal-rechunk: {name or 'adapter'} sequence length "
                 f"{n} not divisible by pump factor {factor}; gearbox "
                 f"degraded to pass-through")
        return flat
    chunk = n // factor
    out = torch.zeros_like(flat)
    for m in range(factor):
        out[m * chunk:(m + 1) * chunk] = flat[m * chunk:(m + 1) * chunk]
    return out


def _indices(access, shape) -> np.ndarray:
    return np.fromiter(access.addresses(shape), dtype=np.int64)


def scatter_indices(access, shape, where: str = "") -> np.ndarray:
    """Freeze a *write* access into an index vector, validating that no
    address is written twice (see the module docstring)."""
    idx = _indices(access, shape)
    if np.unique(idx).size != idx.size:
        dup = int(idx.size - np.unique(idx).size)
        raise LoweringError(
            f"scatter {where or 'access'} writes {dup} duplicate address(es) "
            f"(e.g. a reduction dimension absent from the output pattern); "
            f"results would be backend-dependent last-write-wins")
    return idx


def scatter(mem: torch.Tensor, idx: torch.Tensor, seq) -> torch.Tensor:
    """A copy of ``mem`` with ``seq`` written at the flat addresses."""
    flat = mem.reshape(-1).clone()
    flat[idx] = torch.as_tensor(seq).reshape(-1).to(flat.dtype)
    return flat.reshape(mem.shape)


def gather(mem: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return mem.reshape(-1)[idx]


def _unflatten(step: int, extents):
    """Decompose a flat index into lexicographic coords."""
    coords = []
    rem = step
    for ext in reversed(extents):
        coords.append(rem % ext)
        rem = rem // ext
    return tuple(reversed(coords))


def carry_sequence_apply(g: Graph, node) -> Callable[[Dict[str, Any]],
                                                     Dict[str, Any]]:
    """Lower one sequential-carry compute to a loop over its step domain,
    operating on whole FIFO sequences.

    Returns ``run(bound) -> {"out0": seq, ...}`` where ``bound`` maps
    ``in{k}`` to the gathered operand sequences.  Each iteration cuts one
    block per operand out of its sequence, threads the carry state (reset at
    the start of every sweep of the carry axis), and emits outputs per the
    :class:`~repro_torch.core.ir.CarrySpec` partition: the leading
    ``step_outs`` outputs append one block per step and the rest come from
    ``final_fn(state)`` once per sweep.
    """
    spec = node.meta["carry"]
    n_steps, sweep, in_blocks, out_blocks, _outer_syms = carry_layout(g, node)
    outer_exts = node.domain.extents[:-1]
    out_edges = g.out_edges(node.name)
    n_out = len(out_edges)
    n_step_out = spec.n_step_outs(n_out)
    out_dtypes = []
    for e in out_edges:
        mem, _acc = sink_access(g, e)
        out_dtypes.append(torch_dtype(mem.dtype if mem is not None
                                      else "float32"))
    if any(blk is None for blk in out_blocks):
        raise LoweringError(
            f"carry compute {node.name!r}: output access does not decompose "
            "into a blocked view")

    def run(bound: Dict[str, Any]) -> Dict[str, Any]:
        seqs = [bound[f"in{k}"].reshape(-1) for k in range(len(in_blocks))]
        per_step = [s.shape[0] // n_steps for s in seqs]
        device = seqs[0].device
        init_state = tuple(torch.as_tensor(a, device=device)
                           for a in spec.init_arrays(np))
        chunks = [[] for _ in range(n_out)]
        carry = init_state
        for i in range(n_steps):
            pos = i % sweep
            if pos == 0:
                carry = init_state
            blocks = []
            for k, seq in enumerate(seqs):
                blk = seq[i * per_step[k]:(i + 1) * per_step[k]]
                if in_blocks[k] is not None:
                    blk = blk.reshape(in_blocks[k])
                blocks.append(blk)
            kwargs = {}
            if spec.pass_idx:
                kwargs["idx"] = dict(
                    step=pos, outer=_unflatten(i // sweep, outer_exts),
                    pump=0)
            carry, souts = spec.step_fn(carry, *blocks, **kwargs)
            for k in range(n_step_out):
                chunks[k].append(souts[f"out{k}"].reshape(-1)
                                 .to(out_dtypes[k]))
            if spec.final_fn is not None and pos == sweep - 1:
                fouts = spec.final_fn(carry)
                for k in range(n_step_out, n_out):
                    chunks[k].append(fouts[f"out{k}"].reshape(-1)
                                     .to(out_dtypes[k]))
        return {f"out{k}": torch.cat(chunks[k]) if chunks[k]
                else torch.zeros(0, dtype=out_dtypes[k], device=device)
                for k in range(n_out)}

    return run


def lower(g: Graph, warn: Optional[Callable[[str], None]] = None,
          device: Optional[torch.device] = None
          ) -> Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]:
    """Lower ``g`` to a callable ``fn(inputs) -> {memory name: tensor}``.

    ``inputs`` maps memory-node names to tensors or arrays (missing memories
    start as zeros, as in the reference executor); the run happens on the
    inputs' device, or on ``device`` when none is a tensor.  The graph must
    not be mutated after lowering: access-pattern gathers/scatters are
    frozen here.  ``warn`` receives degradation notes (e.g. a pump factor
    that does not divide a sequence length).
    """
    g.validate()
    order = _toposort(g)
    device = torch.device("cpu") if device is None else device

    # freeze every symbolic access into a static index vector
    idx_of: Dict[int, IndexCache] = {}
    for e in g.edges:
        if e.access is None:
            continue
        src, dst = g.nodes[e.src], g.nodes[e.dst]
        if src.kind == NodeKind.MEMORY and dst.kind in (NodeKind.READER,
                                                        NodeKind.COMPUTE):
            idx_of[id(e)] = IndexCache(_indices(e.access, src.shape))
        elif dst.kind == NodeKind.MEMORY and src.kind in (NodeKind.WRITER,
                                                          NodeKind.COMPUTE):
            idx_of[id(e)] = IndexCache(scatter_indices(
                e.access, dst.shape, where=f"{e.src}->{e.dst}"))

    carry_fns: Dict[str, Callable] = {}
    for comp in g.computes():
        if comp.meta.get("carry") is not None:
            carry_fns[comp.name] = carry_sequence_apply(g, comp)
        elif comp.fn is None:
            raise LoweringError(
                f"compute module {comp.name!r} has no fn body to lower")

    def run_fn(inputs: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        mems = init_memories(g, inputs, device)
        dev = next(iter(mems.values())).device if mems else device
        edge_val: Dict[int, torch.Tensor] = {}
        for name in order:
            node = g.nodes[name]
            ins, outs = g.in_edges(name), g.out_edges(name)
            if node.kind == NodeKind.MEMORY:
                continue  # gathers happen at the consumer
            if node.kind == NodeKind.READER:
                e = ins[0]
                edge_val[id(outs[0])] = gather(mems[e.src],
                                               idx_of[id(e)].on(dev))
            elif node.kind == NodeKind.WRITER:
                e = outs[0]
                mems[e.dst] = scatter(mems[e.dst], idx_of[id(e)].on(dev),
                                      edge_val[id(ins[0])])
            elif node.kind in (NodeKind.SYNC, NodeKind.STREAM):
                edge_val[id(outs[0])] = edge_val[id(ins[0])]
            elif node.kind in (NodeKind.ISSUER, NodeKind.PACKER):
                factor = int(node.meta.get("factor", 1))
                edge_val[id(outs[0])] = _temporal_rechunk(
                    edge_val[id(ins[0])], factor, warn=warn, name=node.name)
            elif node.kind == NodeKind.COMPUTE:
                bound = {}
                for k, e in enumerate(ins):
                    src = g.nodes[e.src]
                    if src.kind == NodeKind.MEMORY and e.access is not None:
                        bound[f"in{k}"] = gather(mems[e.src],
                                                 idx_of[id(e)].on(dev))
                    else:
                        bound[f"in{k}"] = edge_val[id(e)]
                if name in carry_fns:
                    result = carry_fns[name](bound)
                else:
                    result = node.fn(**bound)
                if not isinstance(result, dict):
                    result = {"out0": result}
                for k, e in enumerate(outs):
                    seq = result[f"out{k}"]
                    if g.nodes[e.dst].kind == NodeKind.MEMORY \
                            and e.access is not None:
                        mems[e.dst] = scatter(mems[e.dst],
                                              idx_of[id(e)].on(dev), seq)
                    else:
                        edge_val[id(e)] = seq
            else:  # pragma: no cover
                raise LoweringError(f"cannot lower node kind {node.kind}")
        return mems

    # surface adapter degradation warnings eagerly: a run on shape-only
    # (meta) tensors costs no data movement but moves run-time warnings
    # into the compile report instead of deferring them to the first call
    if warn is not None and any(
            n.kind in (NodeKind.ISSUER, NodeKind.PACKER)
            and int(n.meta.get("factor", 1)) > 1 for n in g.nodes.values()):
        meta = torch.device("meta")
        try:
            run_fn({n.name: torch.zeros(n.shape, dtype=torch_dtype(n.dtype),
                                        device=meta)
                    for n in g.nodes.values() if n.kind == NodeKind.MEMORY})
        except Exception:   # probe only; real errors surface on execution
            pass
    return run_fn


@dataclasses.dataclass
class CompiledKernel:
    """The artifact :func:`repro_torch.compiler.compile` returns.

    ``graph`` is the transformed IR, ``spec`` the kernel-layer pump spec,
    ``report`` the pipeline provenance (incl. cache bookkeeping), and ``fn``
    the executable (None when compiled with ``backend='none'``).
    """

    graph: Graph
    spec: PumpSpec
    report: Any
    fn: Optional[Callable]
    backend: str = "torch"

    def __call__(self, inputs: Mapping[str, Any]) -> Dict[str, Any]:
        if self.fn is None:
            raise LoweringError(
                "kernel was compiled with backend='none'; re-compile with "
                "backend='torch', 'hopper' or 'reference' to execute it")
        return self.fn(inputs)
