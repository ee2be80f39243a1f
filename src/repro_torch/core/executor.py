"""Reference executor for the dataflow IR.

Interprets a Graph on numpy arrays so the transformation passes can be
*semantically validated*: streaming extraction and multi-pumping must be
value-preserving (issuer∘packer = identity; FIFO order = memory order).  The
executor is deliberately simple — streams are materialized as full sequences
in FIFO order — because it exists to check transformations, not to be fast.

Three compute flavours are interpreted:

* plain ``fn`` bodies mapping whole FIFO sequences to whole sequences
  (multi-output: ``{"out0": ..., "out1": ...}`` bound in edge order);
* sequential-carry computes (``meta['carry']`` is a
  :class:`~repro_torch.core.ir.CarrySpec`): the step domain is walked in
  lexicographic order, per-step operand *blocks* are cut from the FIFO
  sequences, and the loop-carried state threads through ``step_fn`` —
  resetting at the start of each sweep of the carry axis — with outputs
  emitted per step or per sweep (``final_fn``);
* both may sit behind streams/adapters: the executor resolves each operand's
  block shape by tracing the edge back to its memory access pattern.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .ir import Graph, Node, NodeKind, Space
from .symbolic import AccessPattern, blocked_access


def _gather(mem: np.ndarray, acc: AccessPattern) -> np.ndarray:
    flat = mem.reshape(-1)
    idx = np.fromiter(acc.addresses(mem.shape), dtype=np.int64)
    return flat[idx]


def _scatter(mem: np.ndarray, acc: AccessPattern, seq: np.ndarray) -> None:
    flat = mem.reshape(-1)
    idx = np.fromiter(acc.addresses(mem.shape), dtype=np.int64)
    flat[idx] = seq
    # mem viewed via reshape(-1) may be a copy for non-contiguous arrays;
    # callers pass contiguous buffers.


def origin_access(g: Graph, edge) -> Tuple[Optional[Node], Optional[AccessPattern]]:
    """Trace an in-edge backwards through pass-through modules (reader /
    stream / sync / issuer) to the memory it originates from, returning
    ``(memory node, access pattern)`` — or ``(None, None)`` when the value
    is produced by an upstream compute instead.

    The fused-region backend has sibling walkers
    (``hopper_backend._trace_to_source/_trace_to_sink``) with stricter
    error semantics (they raise on malformed pass-through chains, since a
    region plan must not silently skip an operand); keep the traversal
    rules in sync when adding pass-through node kinds."""
    e = edge
    while True:
        src = g.nodes[e.src]
        if src.kind == NodeKind.MEMORY:
            return src, e.access
        if src.kind == NodeKind.COMPUTE:
            return None, None
        ins = g.in_edges(src.name)
        if len(ins) != 1:
            return None, None
        e = ins[0]


def sink_access(g: Graph, edge) -> Tuple[Optional[Node], Optional[AccessPattern]]:
    """Forward counterpart of :func:`origin_access` for an out-edge."""
    e = edge
    while True:
        dst = g.nodes[e.dst]
        if dst.kind == NodeKind.MEMORY:
            return dst, e.access
        if dst.kind == NodeKind.COMPUTE:
            return None, None
        outs = g.out_edges(e.dst)
        if len(outs) != 1:
            return None, None
        e = outs[0]


def carry_layout(g: Graph, node: Node):
    """Shared layout facts for interpreting a carry compute: step count,
    sweep length, per-operand block shapes and the outer symbols.

    Returns ``(n_steps, sweep, in_blocks, out_blocks, outer_syms)`` where
    block entries are shape tuples (or None when the operand access does not
    decompose into a blocked view — the per-step slice then stays flat).
    """
    spec = node.meta["carry"]
    dom = node.domain
    if dom is None or not dom.symbols or dom.symbols[-1] != spec.axis:
        raise ValueError(
            f"carry compute {node.name!r}: carry axis {spec.axis!r} must be "
            f"the last step-domain symbol (got {dom.symbols if dom else ()})")
    exts = dom.extents
    n_steps = 1
    for e in exts:
        n_steps *= e
    sweep = exts[-1]

    def block_of(edge, backwards: bool):
        mem, acc = (origin_access if backwards else sink_access)(g, edge)
        if mem is None or acc is None:
            return None
        # the compute's step symbols must stay grid symbols: an access that
        # walks them densely is still visited one block per step
        ba = blocked_access(acc, mem.shape, protect=dom.symbols)
        return ba.block if ba is not None else None

    in_blocks = [block_of(e, True) for e in g.in_edges(node.name)]
    out_blocks = [block_of(e, False) for e in g.out_edges(node.name)]
    return n_steps, sweep, in_blocks, out_blocks, dom.symbols[:-1]


def _run_carry(g: Graph, node: Node, bound: Dict[str, np.ndarray]
               ) -> Dict[str, np.ndarray]:
    """Interpret one sequential-carry compute on numpy sequences."""
    spec = node.meta["carry"]
    n_steps, sweep, in_blocks, _out_blocks, outer_syms = carry_layout(g, node)
    n_in = len(in_blocks)
    per_step = [bound[f"in{k}"].size // n_steps for k in range(n_in)]
    n_out = len(g.out_edges(node.name))
    n_step_out = spec.n_step_outs(n_out)
    chunks: List[List[np.ndarray]] = [[] for _ in range(n_out)]

    carry = spec.init_arrays(np)
    step = 0
    for env in node.domain.points():
        pos = step % sweep
        if pos == 0:
            carry = spec.init_arrays(np)
        blocks = []
        for k in range(n_in):
            sl = bound[f"in{k}"][step * per_step[k]:(step + 1) * per_step[k]]
            blocks.append(sl.reshape(in_blocks[k])
                          if in_blocks[k] is not None else sl)
        kwargs = {}
        if spec.pass_idx:
            kwargs["idx"] = dict(
                step=pos, outer=tuple(env[s] for s in outer_syms), pump=0)
        carry, step_out = spec.step_fn(carry, *blocks, **kwargs)
        for k in range(n_step_out):
            chunks[k].append(np.asarray(step_out[f"out{k}"]).reshape(-1))
        if spec.final_fn is not None and pos == sweep - 1:
            fouts = spec.final_fn(carry)
            for k in range(n_step_out, n_out):
                chunks[k].append(np.asarray(fouts[f"out{k}"]).reshape(-1))
        step += 1
    return {f"out{k}": np.concatenate(chunks[k]) if chunks[k]
            else np.zeros(0, np.float32) for k in range(n_out)}


def _toposort(g: Graph) -> List[str]:
    indeg: Dict[str, int] = {n: 0 for n in g.nodes}
    for e in g.edges:
        indeg[e.dst] += 1
    ready = [n for n, d in indeg.items() if d == 0]
    order: List[str] = []
    while ready:
        n = ready.pop()
        order.append(n)
        for e in g.out_edges(n):
            indeg[e.dst] -= 1
            if indeg[e.dst] == 0:
                ready.append(e.dst)
    if len(order) != len(g.nodes):
        raise ValueError("graph has a cycle")
    return order


def run(g: Graph, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Execute ``g``; returns the contents of every HBM memory node.

    ``inputs`` maps memory-node names to arrays.  Compute nodes' ``fn`` maps a
    dict of named input sequences (1-D, FIFO order) to a dict of named output
    sequences; edge order defines name binding: inputs are bound as ``in0``,
    ``in1``, ... and outputs ``out0``, ... in edge insertion order.
    """
    g.validate()
    mems: Dict[str, np.ndarray] = {}
    for n in g.nodes.values():
        if n.kind == NodeKind.MEMORY:
            if n.name in inputs:
                mems[n.name] = np.array(inputs[n.name], dtype=n.dtype).copy()
            else:
                mems[n.name] = np.zeros(n.shape, dtype=n.dtype)

    # value on each edge (sequences for stream-ish hops)
    edge_val: Dict[int, np.ndarray] = {}

    for name in _toposort(g):
        node = g.nodes[name]
        ins = g.in_edges(name)
        outs = g.out_edges(name)
        if node.kind == NodeKind.MEMORY:
            # writers have already scattered into mems[name]
            for e in outs:
                if g.nodes[e.dst].kind == NodeKind.COMPUTE and e.access is not None:
                    edge_val[id(e)] = _gather(mems[name], e.access)
                elif g.nodes[e.dst].kind == NodeKind.READER:
                    pass  # reader pulls via its own access pattern
        elif node.kind == NodeKind.READER:
            src = ins[0]
            seq = _gather(mems[src.src], src.access)
            edge_val[id(outs[0])] = seq
        elif node.kind == NodeKind.WRITER:
            seq = edge_val[id(ins[0])]
            dst = outs[0]
            _scatter(mems[dst.dst], dst.access, seq)
        elif node.kind in (NodeKind.SYNC, NodeKind.ISSUER, NodeKind.PACKER):
            # Value-preserving by construction: issuer/packer only re-chunk
            # transactions; sync crosses rate domains.  FIFO order is kept.
            edge_val[id(outs[0])] = edge_val[id(ins[0])]
        elif node.kind == NodeKind.STREAM:
            edge_val[id(outs[0])] = edge_val[id(ins[0])]
        elif node.kind == NodeKind.COMPUTE:
            bound = {f"in{k}": edge_val[id(e)] for k, e in enumerate(ins)}
            if node.meta.get("carry") is not None:
                result = _run_carry(g, node, bound)
            else:
                result = node.fn(**bound) if node.fn else {}
            if not isinstance(result, dict):
                result = {"out0": result}
            for k, e in enumerate(outs):
                seq = np.asarray(result[f"out{k}"])
                dst = g.nodes[e.dst]
                if dst.kind == NodeKind.MEMORY and e.access is not None:
                    _scatter(mems[e.dst], e.access, seq)
                else:
                    edge_val[id(e)] = seq
        else:  # pragma: no cover
            raise NotImplementedError(node.kind)

    return mems
