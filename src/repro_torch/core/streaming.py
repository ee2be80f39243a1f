"""Streaming pass (paper §3.2, box ②).

Converts memory-mediated dataflow into FIFO-stream dataflow:

1. *Legality*: for each (producer module → Memory → consumer module) pair,
   check with :func:`repro_torch.core.symbolic.sequence_equivalent` that the write
   and read sequences visit the same addresses in the same order.  This is the
   "intersection check on each pair of connected modules".
2. *Extraction*: for each Memory input of a Compute node, inject a ``Reader``
   module that walks the memory in the computation's access order and pushes
   into a new Stream; symmetrically a ``Writer`` pops from a Stream and
   commits to memory.  After this, streams drive control flow and all modules
   run concurrently — the precondition for re-negotiating their rates
   (multi-pumping).

The pass is *greedy over the whole graph* by default (paper §3.4: "taking the
largest possible subgraph as the candidate"), but accepts a node filter for
interactive/targeted application.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .ir import Edge, Graph, Node, NodeKind, RateDomain, Space
from .symbolic import AccessPattern, sequence_equivalent


class StreamingReport:
    def __init__(self):
        self.streamed: List[Tuple[str, str]] = []
        self.rejected: List[Tuple[str, str, str]] = []  # (src, dst, reason)

    def __repr__(self):  # pragma: no cover
        return (f"StreamingReport(streamed={len(self.streamed)}, "
                f"rejected={len(self.rejected)})")


def can_stream_edge(g: Graph, mem: Node, write: Optional[Edge],
                    read: Edge) -> Tuple[bool, str]:
    """Check that a memory container's producer/consumer can be FIFO-linked."""
    if mem.kind != NodeKind.MEMORY:
        return False, "not a memory node"
    if read.access is None:
        return False, "consumer access unknown"
    if write is None:
        # External input: a Reader can always linearize a known access pattern.
        return True, "external input"
    if write.access is None:
        return False, "producer access unknown"
    if not sequence_equivalent(write.access, read.access, mem.shape):
        return False, "write/read orders differ (intersection check failed)"
    return True, "orders match"


def apply_streaming(g: Graph,
                    node_filter: Optional[Callable[[Node], bool]] = None
                    ) -> Tuple[Graph, StreamingReport]:
    """Rewrite ``g``: memory edges into/out of Compute nodes become streams.

    Returns a new graph; ``g`` is unmodified.  Memory containers that feed
    computes through a legal order become Reader->Stream (inputs) and
    Stream->Writer (outputs).  Illegal edges are left as direct memory access
    and recorded in the report.
    """
    out = g.copy()
    report = StreamingReport()
    keep = node_filter or (lambda n: True)

    new_edges: List[Edge] = []
    drop: set = set()

    for comp in list(out.computes()):
        if not keep(comp):
            continue
        # ---- inputs: Memory -> Compute becomes Memory -> Reader -> Stream -> Compute
        for e in out.in_edges(comp.name):
            src = out.nodes[e.src]
            if src.kind != NodeKind.MEMORY or src.space != Space.HBM:
                continue
            writers = [w for w in out.in_edges(src.name)]
            wedge = writers[0] if writers else None
            ok, why = can_stream_edge(out, src, wedge, e)
            if not ok:
                report.rejected.append((src.name, comp.name, why))
                continue
            rd = out.add(Node(f"read_{src.name}_{comp.name}", NodeKind.READER,
                              rate=RateDomain.SLOW, domain=e.access.domain))
            st = out.stream(f"s_{src.name}_{comp.name}", dtype=src.dtype,
                            elem_width=e.access.width)
            new_edges.append(Edge(src.name, rd.name, e.access, e.volume))
            new_edges.append(Edge(rd.name, st.name, None, e.volume))
            new_edges.append(Edge(st.name, comp.name, None, e.volume))
            drop.add(id_of(out, e))
            report.streamed.append((src.name, comp.name))
        # ---- outputs: Compute -> Memory becomes Compute -> Stream -> Writer -> Memory
        for e in out.out_edges(comp.name):
            dst = out.nodes[e.dst]
            if dst.kind != NodeKind.MEMORY or dst.space != Space.HBM:
                continue
            if e.access is None:
                report.rejected.append((comp.name, dst.name, "unknown access"))
                continue
            readers_downstream = out.out_edges(dst.name)
            legal = True
            for rdedge in readers_downstream:
                ok, why = can_stream_edge(out, dst, e, rdedge)
                if not ok:
                    legal = False
                    report.rejected.append((comp.name, dst.name, why))
                    break
            if not legal:
                continue
            wr = out.add(Node(f"write_{comp.name}_{dst.name}", NodeKind.WRITER,
                              rate=RateDomain.SLOW, domain=e.access.domain))
            st = out.stream(f"s_{comp.name}_{dst.name}", dtype=dst.dtype,
                            elem_width=e.access.width)
            new_edges.append(Edge(comp.name, st.name, None, e.volume))
            new_edges.append(Edge(st.name, wr.name, None, e.volume))
            new_edges.append(Edge(wr.name, dst.name, e.access, e.volume))
            drop.add(id_of(out, e))
            report.streamed.append((comp.name, dst.name))

    out.edges = [e for e in out.edges if id_of(out, e) not in drop] + new_edges
    out.validate()
    return out, report


def id_of(g: Graph, e: Edge) -> int:
    return id(e)


def streamable_subgraph(g: Graph) -> List[str]:
    """Largest set of modules connected purely by streams (paper's greedy pick)."""
    names = []
    for n in g.modules():
        edges = g.in_edges(n.name) + g.out_edges(n.name)
        if edges and all(
            g.nodes[e.src].kind == NodeKind.STREAM
            or g.nodes[e.dst].kind == NodeKind.STREAM
            for e in edges
        ):
            names.append(n.name)
    return names
