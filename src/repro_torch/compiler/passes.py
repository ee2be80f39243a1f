"""Registered graph-rewrite passes over the dataflow IR.

Following DaCe's transformation-registry design, every transformation is a
class with a ``can_apply``/``apply`` protocol registered by name in
:data:`PASS_REGISTRY`; a :class:`~repro_torch.compiler.pipeline.Pipeline`
runs a sequence of them and records a per-pass report.  The two passes the
paper describes (streaming extraction, multi-pumping) wrap the rewrite rules
in ``repro_torch.core``; two further passes close the gap to a real
compiler:

``stream-fusion``
    After streaming extraction, an intermediate memory written by one module
    and read in the same order by exactly one other module survives as a
    ``Stream -> Writer -> Memory -> Reader -> Stream`` round-trip.  The pass
    collapses the chain into the single producer-side stream, removing the
    memory materialization entirely (de Fine Licht et al.'s "stream
    composition" HLS transformation).

``fifo-depth``
    Sizes every FIFO from the rate mismatch of its endpoints instead of the
    hard-coded depth 2: a stream whose endpoint issues/consumes M beats per
    wide transaction needs M slots per pipeline buffer, so depth = 2·M
    (double buffering × pump factor).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from ..core.ir import Edge, Graph, Node, NodeKind, RateDomain, Space
from ..core.multipump import PumpReport, apply_multipump, check_multipump
from ..core.pump_plan import SMEM_BYTES, best_pump_factor
from ..core.streaming import apply_streaming, streamable_subgraph
from ..core.symbolic import sequence_equivalent


class GraphPass:
    """Protocol: ``can_apply(g) -> (bool, reason)``; ``apply(g) -> (Graph, report)``.

    Instances carry their options; ``apply`` must not mutate its input graph.
    """

    name: str = "abstract"

    def can_apply(self, g: Graph) -> Tuple[bool, str]:
        raise NotImplementedError

    def apply(self, g: Graph) -> Tuple[Graph, object]:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<pass {self.name}>"


PASS_REGISTRY: Dict[str, Type[GraphPass]] = {}


def register_pass(cls: Type[GraphPass]) -> Type[GraphPass]:
    """Class decorator adding a pass to the global registry by ``cls.name``."""
    if cls.name in PASS_REGISTRY and PASS_REGISTRY[cls.name] is not cls:
        raise ValueError(f"duplicate pass name {cls.name!r}")
    PASS_REGISTRY[cls.name] = cls
    return cls


def make_pass(name: str, **options) -> GraphPass:
    if name not in PASS_REGISTRY:
        raise KeyError(f"unknown pass {name!r}; known: {sorted(PASS_REGISTRY)}")
    return PASS_REGISTRY[name](**options)


# ---------------------------------------------------------------- streaming --
@register_pass
class StreamingPass(GraphPass):
    """Memory-to-FIFO extraction (paper §3.2 box ②) as a registered pass."""

    name = "streaming"

    def __init__(self, node_filter: Optional[Callable[[Node], bool]] = None):
        self.node_filter = node_filter

    def can_apply(self, g: Graph) -> Tuple[bool, str]:
        for comp in g.computes():
            for e in g.in_edges(comp.name) + g.out_edges(comp.name):
                other = g.nodes[e.src if e.dst == comp.name else e.dst]
                if other.kind == NodeKind.MEMORY and other.space == Space.HBM:
                    return True, "HBM memory edges present"
        return False, "no HBM memory edges adjacent to compute modules"

    def apply(self, g: Graph):
        return apply_streaming(g, node_filter=self.node_filter)


# ------------------------------------------------------------ stream fusion --
@dataclasses.dataclass
class FusionReport:
    # (upstream stream, removed memory, consumer module) per collapsed chain
    fused: List[Tuple[str, str, str]] = dataclasses.field(default_factory=list)
    rejected: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def __repr__(self):  # pragma: no cover
        return f"FusionReport(fused={len(self.fused)}, rejected={len(self.rejected)})"


@register_pass
class StreamFusionPass(GraphPass):
    """Collapse ``... -> Stream -> Writer -> Memory -> Reader -> Stream -> ...``
    into the single upstream stream when the write and read sequences match.

    Memories marked ``meta['keep']`` (externally observed results) are never
    fused away.
    """

    name = "stream-fusion"

    def _chains(self, g: Graph) -> List[Tuple[str, str, str, str, str]]:
        chains = []
        for mem in [n for n in g.nodes.values() if n.kind == NodeKind.MEMORY]:
            if mem.meta.get("keep"):
                continue
            ins, outs = g.in_edges(mem.name), g.out_edges(mem.name)
            if len(ins) != 1 or len(outs) != 1:
                continue
            wr, rd = g.nodes[ins[0].src], g.nodes[outs[0].dst]
            if wr.kind != NodeKind.WRITER or rd.kind != NodeKind.READER:
                continue
            if ins[0].access is None or outs[0].access is None:
                continue
            if not sequence_equivalent(ins[0].access, outs[0].access, mem.shape):
                continue
            we, re = g.in_edges(wr.name), g.out_edges(rd.name)
            if len(we) != 1 or len(re) != 1:
                continue
            s_up, s_dn = g.nodes[we[0].src], g.nodes[re[0].dst]
            if s_up.kind != NodeKind.STREAM or s_dn.kind != NodeKind.STREAM:
                continue
            consumers = g.out_edges(s_dn.name)
            if len(consumers) != 1:
                continue
            chains.append((s_up.name, wr.name, mem.name, rd.name, s_dn.name))
        return chains

    def can_apply(self, g: Graph) -> Tuple[bool, str]:
        n = len(self._chains(g))
        if n:
            return True, f"{n} fusible writer/memory/reader chain(s)"
        return False, "no fusible Stream->Writer->Memory->Reader->Stream chains"

    def apply(self, g: Graph):
        out = g.copy()
        report = FusionReport()
        # fixpoint, one chain per iteration: collapsing a chain can delete a
        # stream another candidate referenced, or expose a new cascade
        while True:
            chains = self._chains(out)
            if not chains:
                break
            s_up, wr, mem, rd, s_dn = chains[0]
            consumer_edge = out.out_edges(s_dn)[0]
            # the fused stream inherits the deeper of the two buffers
            out.nodes[s_up].depth = max(out.nodes[s_up].depth,
                                        out.nodes[s_dn].depth)
            dead = {wr, mem, rd, s_dn}
            # the replacement edge must take the consumer edge's *position*:
            # executors bind compute operands (in0, in1, ...) by edge order
            new_edge = Edge(s_up, consumer_edge.dst, consumer_edge.access,
                            consumer_edge.volume)
            rebuilt = []
            for e in out.edges:
                if e is consumer_edge:
                    rebuilt.append(new_edge)
                elif e.src in dead or e.dst in dead:
                    continue
                else:
                    rebuilt.append(e)
            out.edges = rebuilt
            for name in dead:
                del out.nodes[name]
            report.fused.append((s_up, mem, consumer_edge.dst))
        out.validate()
        return out, report


# -------------------------------------------------------------- multipump --
@register_pass
class MultipumpPass(GraphPass):
    """Temporal vectorization (paper §2/§3.2) with optional factor autotuning.

    ``factor='auto'`` resolves M at apply time: from the capacity model when a
    :class:`~repro_torch.core.pump_plan.KernelEstimate` is supplied, otherwise
    the largest power of two ≤ ``max_factor``; either start value is halved
    until the legality check accepts it (mode-R width divisibility, and the
    widened streams within ``smem_budget``, one block's shared memory).
    """

    name = "multipump"

    def __init__(self, factor="auto", mode: str = "T",
                 smem_budget: int = SMEM_BYTES, max_factor: int = 16,
                 estimate=None, targets: Optional[Sequence[str]] = None):
        self.factor = factor
        self.mode = mode
        self.smem_budget = smem_budget
        self.max_factor = max_factor
        self.estimate = estimate
        self.targets = targets

    def _targets(self, g: Graph) -> List[str]:
        if self.targets is not None:
            return list(self.targets)
        return [n for n in streamable_subgraph(g)
                if g.nodes[n].kind == NodeKind.COMPUTE]

    def _resolve(self, g: Graph, targets: Sequence[str]) -> int:
        if isinstance(self.factor, int):
            return self.factor
        if self.estimate is not None:
            m = best_pump_factor(self.estimate, max_factor=self.max_factor,
                                 smem_budget=self.smem_budget)
        else:
            m = 1 << (max(self.max_factor, 1).bit_length() - 1)
        while m > 1 and not check_multipump(g, targets, m, self.mode,
                                            self.smem_budget)[0]:
            m //= 2
        return m

    def can_apply(self, g: Graph) -> Tuple[bool, str]:
        if isinstance(self.factor, int) and self.factor < 2:
            return False, f"factor {self.factor} < 2: nothing to pump"
        targets = self._targets(g)
        if not targets:
            return False, "no fully-streamed compute modules"
        if isinstance(self.factor, int):
            return check_multipump(g, targets, self.factor, self.mode,
                                   self.smem_budget)
        return True, "factor resolved at apply time"

    def apply(self, g: Graph):
        targets = self._targets(g)
        m = self._resolve(g, targets)
        if m < 2:
            before = g.resources()
            return g, PumpReport(False, self.mode, 1,
                                 "no feasible factor > 1",
                                 resources_before=before,
                                 resources_after=before)
        return apply_multipump(g, targets=targets, factor=m, mode=self.mode,
                               vmem_budget=self.smem_budget)


# -------------------------------------------------------------- fifo depth --
@dataclasses.dataclass
class DepthReport:
    resized: List[Tuple[str, int, int]] = dataclasses.field(default_factory=list)

    def __repr__(self):  # pragma: no cover
        return f"DepthReport(resized={len(self.resized)})"


def _endpoint_factor(g: Graph, name: str) -> int:
    """Temporal multiplicity a module imposes on an adjacent FIFO."""
    n = g.nodes[name]
    if n.kind in (NodeKind.ISSUER, NodeKind.PACKER):
        return int(n.meta.get("factor", 1))
    if n.kind == NodeKind.COMPUTE and n.rate == RateDomain.FAST:
        return max(1, n.pump)
    if n.kind == NodeKind.SYNC:
        # the CDC FIFO buffers a full wide transaction while the fast side
        # drains M beats: look through to the issuer/packer on the other side
        nbrs = [e.dst for e in g.out_edges(name)] + \
               [e.src for e in g.in_edges(name)]
        return max((int(g.nodes[b].meta.get("factor", 1)) for b in nbrs
                    if g.nodes[b].kind in (NodeKind.ISSUER, NodeKind.PACKER)),
                   default=1)
    return 1


@register_pass
class FifoDepthPass(GraphPass):
    """Size ``Node.depth`` of every stream from the pump-factor mismatch of
    its endpoints: depth = 2 · max(M_producer, M_consumer), minimum 2."""

    name = "fifo-depth"

    def can_apply(self, g: Graph) -> Tuple[bool, str]:
        if g.streams():
            return True, f"{len(g.streams())} stream(s)"
        return False, "graph has no streams"

    def apply(self, g: Graph):
        out = g.copy()
        report = DepthReport()
        for s in out.streams():
            prod = [e.src for e in out.in_edges(s.name)]
            cons = [e.dst for e in out.out_edges(s.name)]
            m = max([_endpoint_factor(out, n) for n in prod + cons] or [1])
            depth = max(2, 2 * m)
            if depth != s.depth:
                report.resized.append((s.name, s.depth, depth))
                s.depth = depth
        return out, report
