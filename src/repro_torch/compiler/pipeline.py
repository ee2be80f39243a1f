"""Pass-pipeline runner.

A :class:`Pipeline` is an ordered list of
:class:`~repro_torch.compiler.passes.GraphPass` instances.  ``run`` walks them over a graph: passes whose ``can_apply``
rejects are recorded as skipped (with the reason) and the graph flows through
unchanged; applied passes contribute their own report object.  The resulting
:class:`PipelineReport` is the compiler's provenance record — it also carries
the compile-cache bookkeeping (key, which layer served the request, and a hit
counter) that :func:`repro_torch.compiler.compile` fills in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

from .. import obs
from ..core.ir import Graph
from ..core.pump_plan import SMEM_BYTES

from .passes import (FifoDepthPass, GraphPass, MultipumpPass, StreamFusionPass,
                     StreamingPass)


@dataclasses.dataclass
class PassRecord:
    name: str
    applied: bool
    reason: str = ""
    report: Any = None
    resources: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PipelineReport:
    graph: str
    records: List[PassRecord] = dataclasses.field(default_factory=list)
    # compile/autotune cache bookkeeping (filled by compiler.compile)
    cache_key: Optional[str] = None
    served_from: Optional[str] = None   # None | "disk" | "memory"
    cache_hits: int = 0
    # lowering-time degradation notes (misaligned pump factors, dropped
    # temporal axes, emission-tier downgrades) — deduplicated messages
    warnings: List[str] = dataclasses.field(default_factory=list)
    # measured-runtime autotune provenance: {"winner", "timings_us",
    # "backend", "replayed"} when compile(..., autotune='measure') ran or
    # a measured plan was replayed from the cache
    autotune: Optional[dict] = None
    # hopper-backend emission provenance: {region name: {"tier", ...}}
    emission: Optional[dict] = None
    # autotune candidates this compile timed (0 for a replayed plan)
    measurements: int = 0

    def record(self, name: str) -> Optional[PassRecord]:
        for r in self.records:
            if r.name == name:
                return r
        return None

    def warn(self, msg: str) -> None:
        """Append a degradation note, deduplicated: lowering revisits (and
        bucket-grid sweeps that aggregate reports) re-emit byte-identical
        messages, and each unique message should be recorded once."""
        if msg not in self.warnings:
            self.warnings.append(msg)

    @property
    def warning_count(self) -> int:
        return len(self.warnings)

    @property
    def factor(self) -> int:
        r = self.record("multipump")
        if r is not None and r.applied and r.report is not None:
            return r.report.factor
        return 1

    @property
    def mode(self) -> str:
        r = self.record("multipump")
        if r is not None and r.applied and r.report is not None:
            return r.report.mode
        return "T"

    def summary(self) -> str:
        parts = [f"{r.name}:{'+' if r.applied else '-'}" for r in self.records]
        cache = f" cache={self.served_from or 'miss'}({self.cache_hits})"
        tail = f" warn={self.warning_count}" if self.warnings else ""
        return (f"[{self.graph}] " + " ".join(parts) + f" M={self.factor}"
                + cache + tail)


class Pipeline:
    """Runs registered passes in order, deterministically."""

    def __init__(self, passes: Sequence[GraphPass]):
        self.passes = list(passes)

    @staticmethod
    def default(factor="auto", mode: str = "T", smem_budget: int = SMEM_BYTES,
                max_factor: int = 16, estimate=None, fuse: bool = True,
                size_fifos: bool = True) -> "Pipeline":
        """The paper's §3 ordering: stream, fuse, pump, then size FIFOs
        (depths depend on the chosen pump factor, so sizing runs last)."""
        passes: List[GraphPass] = [StreamingPass()]
        if fuse:
            passes.append(StreamFusionPass())
        passes.append(MultipumpPass(factor=factor, mode=mode,
                                    smem_budget=smem_budget,
                                    max_factor=max_factor, estimate=estimate))
        if size_fifos:
            passes.append(FifoDepthPass())
        return Pipeline(passes)

    def run(self, g: Graph) -> Tuple[Graph, PipelineReport]:
        report = PipelineReport(graph=g.name)
        cur = g
        with obs.span("compiler.pipeline", cat="compile", graph=g.name,
                      nodes=len(g.nodes), edges=len(g.edges)) as pspan:
            for p in self.passes:
                with obs.span("compiler.pass", cat="compile", graph=g.name,
                              **{"pass": p.name}) as sp:
                    ok, why = p.can_apply(cur)
                    if not ok:
                        sp.set(applied=False, reason=why)
                        report.records.append(PassRecord(p.name, False, why))
                        continue
                    cur, prep = p.apply(cur)
                    applied = bool(getattr(prep, "applied", True))
                    reason = getattr(prep, "reason", "ok") or "ok"
                    sp.set(applied=applied, reason=reason)
                    report.records.append(PassRecord(p.name, applied, reason,
                                                     prep, cur.resources()))
            pspan.set(factor=report.factor, mode=report.mode)
        return cur, report
