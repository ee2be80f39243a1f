"""The multi-pumping / temporal-vectorization transformation (paper §2, §3.2).

Given a streamed dataflow graph, split it into two *rate domains* and rewrite
the boundary:

  Mode "T" (throughput, paper waveform ②):
      external stream width ×= M, compute width unchanged, compute rate = FAST
      with pump M.  Throughput ×M at equal compute resources.  Legal even for
      computations with internal sequential dependencies — the superclass-of-
      vectorization property.

  Mode "R" (resource, paper waveform ③):
      external width unchanged, compute spatial width ÷= M, compute rate =
      FAST with pump M.  Equal throughput at 1/M compute resources.

At the domain boundary the pass injects the paper's three adapter modules:
``Sync`` (clock-domain crossing — realized on TPU by the Pallas double-
buffered pipeline boundary), ``Issuer`` (wide→narrow) on inputs and
``Packer`` (narrow→wide) on outputs.

Legality (§3.2): the compute modules must not perform data-dependent external
memory I/O; boundary edges must already be streams; in mode R the spatial
width must divide by M; the widened working set must fit the VMEM budget.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

from .ir import (Edge, Graph, Node, NodeKind, PumpSpec, RateDomain, Space,
                 effective_rate)


@dataclasses.dataclass
class PumpReport:
    applied: bool
    mode: str
    factor: int
    reason: str = ""
    boundary_in: int = 0
    boundary_out: int = 0
    resources_before: dict = dataclasses.field(default_factory=dict)
    resources_after: dict = dataclasses.field(default_factory=dict)

    def resource_ratio(self, key: str = "compute_units") -> float:
        b = self.resources_before.get(key, 0)
        a = self.resources_after.get(key, 0)
        return a / b if b else float("nan")


def check_multipump(g: Graph, targets: Sequence[str], factor: int,
                    mode: str = "T",
                    vmem_budget: int = 64 * 1024 * 1024) -> Tuple[bool, str]:
    """Feasibility check — the relaxed auto-vectorizer conditions of §3.2."""
    if factor < 2:
        return False, "pump factor must be >= 2"
    if mode not in ("T", "R"):
        return False, f"unknown mode {mode}"
    for name in targets:
        n = g.nodes.get(name)
        if n is None:
            return False, f"unknown node {name}"
        if n.kind != NodeKind.COMPUTE:
            return False, f"{name} is not a compute module"
        if n.data_dependent_io:
            # The single restriction temporal vectorization keeps: no
            # data-dependent external memory I/O based on previous operations.
            return False, f"{name} performs data-dependent external I/O"
        if n.rate == RateDomain.FAST:
            return False, f"{name} already multi-pumped"
        if mode == "R" and n.vector_width % factor != 0:
            return False, (f"{name} spatial width {n.vector_width} not divisible "
                           f"by pump factor {factor}")
        for e in g.in_edges(name) + g.out_edges(name):
            other = g.nodes[e.src if e.dst == name else e.dst]
            if other.kind == NodeKind.MEMORY and other.space == Space.HBM:
                return False, (f"{name} accesses HBM memory {other.name} directly; "
                               "run the streaming pass first")
    # VMEM capacity: the widened transactions must be buffered (×2 for the
    # double-buffered pipeline = the Sync module).
    widened = 0
    for name in targets:
        n = g.nodes[name]
        for e in g.in_edges(name) + g.out_edges(name):
            s = g.nodes[e.src if e.dst == name else e.dst]
            if s.kind == NodeKind.STREAM:
                widened += 2 * s.elem_width * factor * s.bytes_per_elem()
    if widened > vmem_budget:
        return False, (f"widened working set {widened} B exceeds VMEM budget "
                       f"{vmem_budget} B")
    return True, "ok"


def apply_multipump(g: Graph, targets: Optional[Sequence[str]] = None,
                    factor: int = 2, mode: str = "T",
                    vmem_budget: int = 64 * 1024 * 1024
                    ) -> Tuple[Graph, PumpReport]:
    """Rewrite ``g`` with the temporal-vectorization transformation.

    ``targets`` defaults to every compute module reachable purely through
    streams — the paper's greedy largest-subgraph policy (§3.4).
    Returns (new_graph, report); on infeasibility the graph is returned
    unchanged with ``report.applied == False``.
    """
    from .streaming import streamable_subgraph

    if targets is None:
        targets = [n for n in streamable_subgraph(g)
                   if g.nodes[n].kind == NodeKind.COMPUTE]
    ok, why = check_multipump(g, targets, factor, mode, vmem_budget)
    before = g.resources()
    if not ok:
        return g, PumpReport(False, mode, factor, why,
                             resources_before=before, resources_after=before)

    out = g.copy()
    n_in = n_out = 0
    # a stream may border the pumped region twice (producer and consumer both
    # in ``targets``, e.g. after stream fusion): widen its transactions once
    widened: set = set()
    for name in targets:
        comp = out.nodes[name]
        comp.rate = RateDomain.FAST
        comp.pump = factor
        comp.meta["pump_mode"] = mode
        if mode == "R":
            comp.vector_width //= factor
        # rewrite each boundary stream with sync+issuer / packer+sync chains
        for e in list(out.in_edges(name)):
            s = out.nodes[e.src]
            if s.kind != NodeKind.STREAM:
                continue
            # producer side keeps/sets the wide width
            if mode == "T" and s.name not in widened:
                s.elem_width *= factor
                widened.add(s.name)
            n_in += 1
            sync = out.add(Node(f"sync_in_{s.name}", NodeKind.SYNC,
                                rate=RateDomain.FAST))
            iss = out.add(Node(f"issue_{s.name}", NodeKind.ISSUER,
                               rate=RateDomain.FAST, meta=dict(factor=factor)))
            # suffix by consumer: a stream linking two pumped computes gets
            # an issuer here and a packer on its producer side
            narrow = out.stream(f"{s.name}_narrow_{name}", dtype=s.dtype,
                                elem_width=max(1, s.elem_width // factor))
            narrow.meta = dict(rate="fast")
            # re-route: s -> sync -> issuer -> narrow -> comp
            out.edges.remove(e)
            out.connect(s.name, sync.name)
            out.connect(sync.name, iss.name)
            out.connect(iss.name, narrow.name)
            out.connect(narrow.name, comp.name)
        for e in list(out.out_edges(name)):
            s = out.nodes[e.dst]
            if s.kind != NodeKind.STREAM:
                continue
            if mode == "T" and s.name not in widened:
                s.elem_width *= factor
                widened.add(s.name)
            n_out += 1
            pack = out.add(Node(f"pack_{s.name}", NodeKind.PACKER,
                                rate=RateDomain.FAST, meta=dict(factor=factor)))
            sync = out.add(Node(f"sync_out_{s.name}", NodeKind.SYNC,
                                rate=RateDomain.FAST))
            narrow = out.stream(f"{s.name}_narrow_{name}", dtype=s.dtype,
                                elem_width=max(1, s.elem_width // factor))
            narrow.meta = dict(rate="fast")
            out.edges.remove(e)
            out.connect(comp.name, narrow.name)
            out.connect(narrow.name, pack.name)
            out.connect(pack.name, sync.name)
            out.connect(sync.name, s.name)

    out.validate()
    report = PumpReport(True, mode, factor, "ok", n_in, n_out,
                        resources_before=before,
                        resources_after=out.resources())
    return out, report


def throughput_model(g: Graph, clk0: float = 1.0, clk1: float = 2.0
                     ) -> float:
    """Elements/sec estimate under the effective-rate law (paper §2.1).

    Each compute module contributes width × rate; the slowest stage bounds the
    pipeline.  ``clk0``/``clk1`` are the slow/fast domain issue rates (on TPU:
    wide-DMA transactions/s and compute iterations/s).
    """
    rates = []
    for n in g.computes():
        rate = effective_rate(clk0, clk1, n.pump) if n.rate == RateDomain.FAST \
            else clk0
        width = n.vector_width * (n.pump if n.rate == RateDomain.FAST else 1)
        rates.append(width * rate)
    return min(rates) if rates else 0.0


def pump_spec_for(g: Graph, target: str,
                  vmem_budget: int = 64 * 1024 * 1024) -> PumpSpec:
    """Extract the kernel-layer PumpSpec for a transformed compute module."""
    n = g.nodes[target]
    mode = "T"
    if n.meta.get("pump_mode"):
        mode = n.meta["pump_mode"]
    return PumpSpec(factor=n.pump, mode=mode, vmem_budget=vmem_budget)
