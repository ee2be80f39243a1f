"""Dataflow IR for temporal vectorization.

A deliberately small data-centric graph IR in the spirit of DaCe SDFGs
(paper §3.1): nodes are *data containers* (random-access ``Memory`` or FIFO
``Stream``) and *modules* (``Compute``, ``Reader``, ``Writer`` plus the
multi-pumping adapter modules ``Sync``/``Issuer``/``Packer``); edges carry
symbolic :class:`~repro_torch.core.symbolic.AccessPattern` descriptions of all data
movement.  The two transformation passes (``streaming.py``, ``multipump.py``)
are graph-rewriting rules over this IR, and the kernel layer consumes the
rewritten graph as a :class:`PumpSpec` when constructing Pallas BlockSpecs.

Rate domains replace the paper's clock domains: ``SLOW`` is the wide/long-path
domain (HBM DMA, ICI collectives), ``FAST`` the multi-pumped compute domain.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .symbolic import AccessPattern, Domain


class Space(enum.Enum):
    HBM = "hbm"      # long data path: off-chip memory
    VMEM = "vmem"    # on-chip scratch (BRAM analogue)
    STREAM = "stream"


class RateDomain(enum.Enum):
    SLOW = "slow"   # clk0: readers/writers, long paths
    FAST = "fast"   # clk1 = M * clk0: multi-pumped compute


class NodeKind(enum.Enum):
    MEMORY = "memory"
    STREAM = "stream"
    COMPUTE = "compute"
    READER = "reader"
    WRITER = "writer"
    SYNC = "sync"       # clock-domain crossing (Pallas pipeline boundary)
    ISSUER = "issuer"   # 1 wide transaction -> M narrow transactions
    PACKER = "packer"   # M narrow transactions -> 1 wide transaction


@dataclasses.dataclass(frozen=True)
class CarrySpec:
    """Sequential-carry (associative/online-scan) description of a compute.

    A compute carrying state across one domain axis — flash attention's
    running (max, denominator, accumulator) over KV blocks, the SSD scan's
    inter-chunk state — cannot be expressed as a pure map/reduce ``fn``.
    Instead the node declares:

    ``axis``      the domain symbol swept sequentially (must be the *last*
                  symbol of the compute's step domain: lexicographic walk
                  order makes each sweep contiguous)
    ``state``     tuple of ``(shape, dtype[, fill])`` per loop-carried
                  array; each sweep of the carry axis starts from
                  ``full(shape, fill)`` (fill defaults to 0 — flash
                  attention's running max uses ``-inf``-like fills)
    ``step_fn``   ``(carry, *in_blocks[, idx=...]) -> (carry', outs|None)``
                  one sequential step; operands arrive as block-shaped
                  arrays (the blocked view of each access pattern) and
                  ``outs`` is a ``{"out0": block, ...}`` dict for kernels
                  that emit per step (SSD), or None
    ``final_fn``  ``carry -> {"out<k>": block, ...}`` — emitted once per
                  sweep after the last step, for kernels whose outputs are a
                  function of the final state (flash attention's tile plus
                  its max/denominator, the SSD scan's final inter-chunk
                  state).  Output edges are partitioned by ``step_outs``:
                  the first ``step_outs`` node outputs come from ``step_fn``
                  every step and the remaining outputs come from
                  ``final_fn`` once per sweep (keyed by their *absolute*
                  edge position, e.g. ``{"out1": ...}`` when ``step_outs``
                  is 1).  ``step_outs=0`` (the default) with a ``final_fn``
                  means all outputs are per-sweep; without a ``final_fn``
                  all outputs come from ``step_fn`` regardless.
    ``step_outs`` number of leading per-step outputs when ``final_fn`` is
                  set (ignored otherwise — see above)
    ``pass_idx``  pass ``idx=dict(step=<position along the carry sweep>,
                  outer=<coords of the non-carry step symbols>,
                  pump=<mode-R sub-tile index, 0 elsewhere>)`` to both fns
                  (causal masks and other position-dependent bodies)

    Multi-pumping legality is unchanged — a sequential carry is exactly the
    dependency pattern temporal vectorization tolerates (paper §2): mode T
    runs M dependent steps per wide transaction; the state never leaves the
    fast domain.
    """

    axis: str
    state: Tuple[Tuple, ...]          # (shape, dtype[, fill]) per array
    step_fn: Callable
    final_fn: Optional[Callable] = None
    pass_idx: bool = False
    step_outs: int = 0                # leading per-step outputs with final_fn

    def n_step_outs(self, n_out: int) -> int:
        """How many of the node's ``n_out`` outputs come from ``step_fn``."""
        return n_out if self.final_fn is None else self.step_outs

    def init_arrays(self, xp=np,
                    narrow: "Optional[Dict[int, Tuple[int, int]]]" = None):
        """Fresh per-sweep state arrays; ``narrow`` maps state-array index →
        (dim, factor): mode-R narrowing of the labelled state dimension."""
        out = []
        for i, entry in enumerate(self.state):
            shape, dtype = entry[0], entry[1]
            fill = entry[2] if len(entry) > 2 else 0.0
            if narrow and i in narrow:
                d, factor = narrow[i]
                shape = tuple(s // factor if j == d else s
                              for j, s in enumerate(shape))
            out.append(xp.full(shape, fill, dtype=dtype))
        return tuple(out)

    def signature(self) -> Tuple:
        """Stable identity for cache/memo keys (no object ids)."""
        return ("carry", self.axis, self.state, bool(self.final_fn),
                self.pass_idx, self.step_outs)


@dataclasses.dataclass
class Node:
    name: str
    kind: NodeKind
    # containers
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    space: Space = Space.HBM
    # streams
    elem_width: int = 1            # elements per transaction
    depth: int = 2                 # FIFO depth
    # modules
    domain: Optional[Domain] = None
    vector_width: int = 1          # spatial vectorization V (replicated units)
    rate: RateDomain = RateDomain.SLOW
    pump: int = 1                  # temporal multiplicity M (FAST domain only)
    fn: Optional[Callable] = None  # python/jnp body, used by the executor
    data_dependent_io: bool = False  # forbids multi-pumping (paper §3.2)
    meta: Dict = dataclasses.field(default_factory=dict)

    def bytes_per_elem(self) -> int:
        # numpy has no bfloat16 (the reference gets it from jax's ml_dtypes)
        if self.dtype == "bfloat16":
            return 2
        return np.dtype(self.dtype).itemsize

    def footprint_bytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * self.bytes_per_elem()


@dataclasses.dataclass
class Edge:
    src: str
    dst: str
    access: Optional[AccessPattern] = None  # None for pure stream hops
    volume: int = 0                         # elements moved over edge lifetime

    def key(self) -> Tuple[str, str]:
        return (self.src, self.dst)


class Graph:
    """A flat dataflow graph with named nodes."""

    def __init__(self, name: str):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.edges: List[Edge] = []

    # -- construction ---------------------------------------------------------
    def add(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        self.nodes[node.name] = node
        return node

    def memory(self, name: str, shape, dtype="float32", space=Space.HBM) -> Node:
        return self.add(Node(name, NodeKind.MEMORY, shape=tuple(shape),
                             dtype=dtype, space=space))

    def stream(self, name: str, dtype="float32", elem_width=1, depth=2) -> Node:
        return self.add(Node(name, NodeKind.STREAM, dtype=dtype,
                             elem_width=elem_width, depth=depth,
                             space=Space.STREAM))

    def compute(self, name: str, domain: Domain, fn=None, vector_width=1,
                data_dependent_io=False, **meta) -> Node:
        return self.add(Node(name, NodeKind.COMPUTE, domain=domain, fn=fn,
                             vector_width=vector_width,
                             data_dependent_io=data_dependent_io, meta=meta))

    def connect(self, src: str, dst: str, access: AccessPattern | None = None,
                volume: int = 0) -> Edge:
        for end in (src, dst):
            if end not in self.nodes:
                raise ValueError(f"unknown node {end}")
        e = Edge(src, dst, access, volume)
        self.edges.append(e)
        return e

    # -- queries ---------------------------------------------------------------
    def in_edges(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.dst == name]

    def out_edges(self, name: str) -> List[Edge]:
        return [e for e in self.edges if e.src == name]

    def modules(self) -> List[Node]:
        return [n for n in self.nodes.values()
                if n.kind not in (NodeKind.MEMORY, NodeKind.STREAM)]

    def computes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.kind == NodeKind.COMPUTE]

    def streams(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.kind == NodeKind.STREAM]

    def validate(self) -> None:
        for e in self.edges:
            src, dst = self.nodes[e.src], self.nodes[e.dst]
            if src.kind == NodeKind.MEMORY and dst.kind == NodeKind.MEMORY:
                raise ValueError(f"memory->memory edge {e.key()}")
            if src.kind == NodeKind.STREAM and dst.kind == NodeKind.STREAM:
                raise ValueError(f"stream->stream edge {e.key()}")
        # every stream has exactly one producer and one consumer
        for s in self.streams():
            if len(self.in_edges(s.name)) != 1 or len(self.out_edges(s.name)) != 1:
                raise ValueError(f"stream {s.name} must have 1 producer, 1 consumer")

    def copy(self) -> "Graph":
        g = Graph(self.name)
        g.nodes = {k: dataclasses.replace(v, meta=dict(v.meta))
                   for k, v in self.nodes.items()}
        g.edges = [dataclasses.replace(e) for e in self.edges]
        return g

    # -- resource model ----------------------------------------------------------
    def resources(self) -> Dict[str, float]:
        """TPU analogue of the paper's DSP/BRAM/LUT report.

        compute_units : Σ spatial vector widths of compute modules (DSP analogue)
        vmem_bytes    : Σ VMEM container footprints (BRAM analogue)
        adapters      : count of sync/issuer/packer modules (LUT/reg overhead)
        stream_bytes  : Σ FIFO buffer footprints
        """
        cu = sum(n.vector_width for n in self.computes())
        vmem = sum(n.footprint_bytes() for n in self.nodes.values()
                   if n.kind == NodeKind.MEMORY and n.space == Space.VMEM)
        adapters = sum(1 for n in self.nodes.values()
                       if n.kind in (NodeKind.SYNC, NodeKind.ISSUER, NodeKind.PACKER))
        stream_bytes = sum(s.elem_width * s.depth * s.bytes_per_elem()
                           for s in self.streams())
        return dict(compute_units=cu, vmem_bytes=vmem, adapters=adapters,
                    stream_bytes=stream_bytes)

    def __repr__(self) -> str:  # pragma: no cover
        lines = [f"Graph({self.name})"]
        for n in self.nodes.values():
            extra = ""
            if n.kind == NodeKind.COMPUTE:
                extra = f" V={n.vector_width} rate={n.rate.value} M={n.pump}"
            if n.kind == NodeKind.STREAM:
                extra = f" w={n.elem_width}"
            lines.append(f"  [{n.kind.value:7s}] {n.name}{extra}")
        for e in self.edges:
            lines.append(f"  {e.src} -> {e.dst}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class PumpSpec:
    """The artifact the IR passes hand to the kernel layer.

    ``factor``     pump factor M (1 = not pumped)
    ``mode``       'T' widen external paths, keep compute width (throughput)
                   'R' keep external width, narrow compute by M (resource)
    ``axis``       which block axis carries the temporal dimension
    ``vmem_budget``bytes available for the widened working set
    """

    factor: int = 1
    mode: str = "T"
    axis: int = 0
    vmem_budget: int = 64 * 1024 * 1024

    def __post_init__(self):
        if self.mode not in ("T", "R"):
            raise ValueError(f"mode must be T or R, got {self.mode}")
        if self.factor < 1:
            raise ValueError("pump factor must be >= 1")

    @property
    def is_pumped(self) -> bool:
        return self.factor > 1

    @staticmethod
    def of(pump) -> "PumpSpec":
        """A ``PumpSpec`` from a factor (mode T), a ``(factor, mode)`` pair
        or a ``PumpSpec``: the forms the kernel wrappers take."""
        if isinstance(pump, PumpSpec):
            return pump
        if isinstance(pump, tuple):
            return PumpSpec(factor=int(pump[0]), mode=str(pump[1]))
        return PumpSpec(factor=int(pump))


def effective_rate(clk0: float, clk1: float, pump: int) -> float:
    """Paper §2.1: rate_eff = min(clk0, clk1 / M).

    On TPU ``clk0`` is the wide-transaction (DMA/collective) issue rate and
    ``clk1`` the compute-iteration rate; the law is unchanged.
    """
    if pump <= 1:
        return min(clk0, clk1)
    return min(clk0, clk1 / pump)
