"""Hopper emission backend: fused region lowering (``backend='hopper'``).

The counterpart of the reference's ``compiler/pallas_backend.py``.  Where
:mod:`.lowering` schedules the transformed graph node by node, this backend
partitions the graph into **fused compute regions** — the maximal
``Memory → Reader → … → Writer → Memory`` chains between memory containers
— and emits each region as *one* blocked kernel.  The paper's pump factor M
is realized structurally: as the **innermost temporal grid axis** of the
region's grid, not as an in-kernel loop.

    Mode T: the innermost grid dimension (extent G) splits into G/M wide
            transactions × M narrow beats — offsets rewritten by the exact
            substitution ``g -> g*M + _pump``.
    Mode R: the output-carrying block dimension narrows by M and the ``_pump``
            axis walks its M sub-tiles; operand blocks narrowed only where
            they share the output's grid symbol.

The planning half (``Region``, ``partition_regions``, ``RegionPlan``,
``plan_region``, ``_apply_temporal``, ``_narrow_labelled``) is the
reference's, line for line, so grids, blocks, reduce symbols and notes equal
its own.  Each region is emitted at the highest tier its structure admits:

``hopper``     a hand-written CUDA kernel on CUDA tensors (its plain
               PyTorch version on CPU tensors).  A plan that is block-unit
               and covers its output reaches this tier when it is
               * the single-output map/reduce form (the reference's
                 ``pl.pallas_call`` at ``pallas_backend.py:847``) of one
                 compute whose ``meta['tile_op']`` the region kernel takes
                 (``'add'``, ``'dot'``): ``csrc/region_map_reduce.cu``,
                 driven by a descriptor of the plan; or
               * the multi-output map form (``pallas_backend.py:814``) of a
                 ``'ssd_state_step'`` compute: ``csrc/ssd_decode.cu``; or
               * the carry form (``pallas_backend.py:784``) of the three
                 carry builders, chosen by the compute's ``tile_op``:
                 ``'flash_attention'`` (``_flash_graph``: o and the final
                 m and l) -> ``ops.flash_attention``,
                 ``'decode_attention'`` (``_decode_attention_graph``, its
                 int32 ``pos``) -> ``ops.decode_attention``, and
                 ``'ssd_scan'`` (``_ssd_graph``, with its final state) ->
                 ``ops.ssd_scan``, each at the plan's (pump, mode): mode T
                 widens the kernel's key / chunk transaction, mode R walks
                 the builder's narrow axis (q rows, d, p) in sub-tiles.
               A region the kernels cannot take (a shape, dtype or pump
               case they are not built for) drops a tier with the reason
               in its ``why``; a region at this tier launches its kernel
               or raises.
``blockloop``  the same grid walked in PyTorch with element-unit slices,
               one grid point at a time.  Handles overlapping halo windows
               block indexing cannot.
``carryloop``  the blockloop schedule of a sequential-carry region, the
               loop-carried state threaded through the walk: a carry
               region whose compute has no kernel, or whose plan its
               kernel cannot take.
``gather``     region-level fallback: one gather → compute-chain → scatter
               per region.  Used when computes lack a tile form (e.g. the
               dependency-carrying Floyd-Warshall pivot loop).

Grid dimensions absent from the output access (plus the temporal axis when
it splits one of them) are *reduction* dimensions: the output tile is zeroed
on their first visit and accumulated thereafter — computes marked
``meta['reduce']='add'`` return partial contributions per grid step.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.executor import _toposort
from ..core.ir import CarrySpec, Graph, NodeKind
from ..core.symbolic import (Affine, BlockedAccess, blocked_access,
                             narrow_block, split_temporal)
from ..kernels import ops
from ..kernels.region_map_reduce import RegionDesc, describe
from .lowering import (IndexCache, LoweringError, _indices,
                       carry_sequence_apply, gather, init_memories,
                       scatter, scatter_indices, torch_dtype)

PUMP_SYM = "_pump"
_PASS_THROUGH = (NodeKind.STREAM, NodeKind.SYNC, NodeKind.ISSUER,
                 NodeKind.PACKER, NodeKind.READER, NodeKind.WRITER)


# ------------------------------------------------------------ region graph --
@dataclasses.dataclass
class Region:
    """One fused region: the modules between memory containers."""

    name: str
    members: List[str]                       # non-memory node names
    computes: List[str]                      # topo order
    # per compute, operand sources in edge order:
    #   ("mem", memory name, AccessPattern) | ("comp", upstream compute name)
    bindings: Dict[str, List[Tuple]]
    # (compute, memory, AccessPattern) writes out of the region
    outputs: List[Tuple[str, str, Any]]
    pump: int = 1
    mode: str = "T"


def _trace_to_source(g: Graph, edge) -> Tuple:
    """Walk an in-edge backwards through pass-through modules to its origin:
    a memory (with the reader's access pattern) or an upstream compute."""
    e = edge
    while True:
        src = g.nodes[e.src]
        if src.kind == NodeKind.MEMORY:
            return ("mem", src.name, e.access)
        if src.kind == NodeKind.COMPUTE:
            return ("comp", src.name)
        ins = g.in_edges(src.name)
        if len(ins) != 1:
            raise LoweringError(
                f"pass-through module {src.name} has {len(ins)} inputs")
        e = ins[0]


def _trace_to_sink(g: Graph, edge) -> Optional[Tuple]:
    """Walk an out-edge forward to a memory write; None when it feeds a
    downstream compute inside the region instead."""
    e = edge
    while True:
        dst = g.nodes[e.dst]
        if dst.kind == NodeKind.MEMORY:
            return (dst.name, e.access)
        if dst.kind == NodeKind.COMPUTE:
            return None
        outs = g.out_edges(dst.name)
        if len(outs) != 1:
            raise LoweringError(
                f"pass-through module {dst.name} has {len(outs)} outputs")
        e = outs[0]


def partition_regions(g: Graph) -> List[Region]:
    """Split ``g`` into fused regions: connected components of the module/
    stream subgraph, with memory containers as the region boundaries."""
    # union-find over non-memory nodes
    parent: Dict[str, str] = {n.name: n.name for n in g.nodes.values()
                              if n.kind != NodeKind.MEMORY}

    def root(n: str) -> str:
        while parent[n] != n:
            parent[n] = parent[parent[n]]
            n = parent[n]
        return n

    for e in g.edges:
        if e.src in parent and e.dst in parent:
            parent[root(e.src)] = root(e.dst)

    groups: Dict[str, List[str]] = {}
    for n in parent:
        groups.setdefault(root(n), []).append(n)

    order = _toposort(g)
    pos = {n: i for i, n in enumerate(order)}
    regions = []
    for members in groups.values():
        members.sort(key=pos.__getitem__)
        computes = [n for n in members
                    if g.nodes[n].kind == NodeKind.COMPUTE]
        if not computes:
            continue   # dangling adapters with no compute: nothing to emit
        bindings: Dict[str, List[Tuple]] = {}
        outputs: List[Tuple[str, str, Any]] = []
        for c in computes:
            bindings[c] = [_trace_to_source(g, e) for e in g.in_edges(c)]
            for e in g.out_edges(c):
                sink = _trace_to_sink(g, e)
                if sink is not None:
                    outputs.append((c, sink[0], sink[1]))
        pump = max((g.nodes[c].pump for c in computes), default=1)
        mode = next((g.nodes[c].meta.get("pump_mode") for c in computes
                     if g.nodes[c].meta.get("pump_mode")), "T")
        regions.append(Region(name=computes[0], members=members,
                              computes=computes, bindings=bindings,
                              outputs=outputs, pump=pump, mode=mode))

    # schedule regions by memory dataflow, not by node position: a region
    # reading memory m must run after every region writing m (the node-level
    # toposort guarantees this order exists)
    writers: Dict[str, List[int]] = {}
    for i, r in enumerate(regions):
        for _c, mem, _a in r.outputs:
            writers.setdefault(mem, []).append(i)
    deps: Dict[int, set] = {i: set() for i in range(len(regions))}
    for i, r in enumerate(regions):
        for srcs in r.bindings.values():
            for src in srcs:
                if src[0] == "mem":
                    deps[i].update(j for j in writers.get(src[1], ())
                                   if j != i)
    ordered: List[Region] = []
    done: set = set()
    while len(done) < len(regions):
        ready = sorted(
            (i for i in deps if i not in done and deps[i] <= done),
            key=lambda i: pos[regions[i].computes[0]])
        if not ready:   # pragma: no cover - node toposort forbids cycles
            raise LoweringError("cyclic memory dependency between regions")
        for i in ready:
            done.add(i)
            ordered.append(regions[i])
    return ordered


# ------------------------------------------------------------- region plan --
@dataclasses.dataclass
class RegionPlan:
    """A tile-emittable region: unified grid + blocked views per operand."""

    region: Region
    grid: Tuple[Tuple[str, int], ...]        # outermost → innermost
    reduce_syms: Tuple[str, ...]             # grid syms absent from output
    blocks: Dict[Tuple[str, int], BlockedAccess]   # (compute, operand idx)
    # (compute, memory, blocked view) per region output, primary first
    outputs: List[Tuple[str, str, BlockedAccess]]
    tile_fns: Dict[str, Callable]
    pump: int = 1                            # realized temporal factor
    mode: str = "T"
    pallas_ok: bool = True                   # block-unit maps + full coverage
    # sequential-carry emission (single-compute regions only)
    carry: Optional[CarrySpec] = None
    carry_syms: Tuple[str, ...] = ()         # carry axis (+ mode-T _pump)
    carry_narrow: Dict[int, Tuple[int, int]] = \
        dataclasses.field(default_factory=dict)   # state idx -> (dim, M)
    outer_syms: Tuple[str, ...] = ()         # step syms excluding the axis

    # single-output convenience views (primary output)
    @property
    def out_compute(self) -> str:
        return self.outputs[0][0]

    @property
    def out_mem(self) -> str:
        return self.outputs[0][1]

    @property
    def out_block(self) -> BlockedAccess:
        return self.outputs[0][2]


def _tile_fn_of(g: Graph, name: str) -> Optional[Callable]:
    n = g.nodes[name]
    fn = n.meta.get("tile_fn")
    if fn is None and n.meta.get("elementwise"):
        fn = n.fn
    return fn


def plan_region(g: Graph, region: Region,
                warn: Callable[[str], None]) -> Optional[RegionPlan]:
    """Derive the blocked emission plan for a region, or None when the
    region must fall back to gather emission (reason passed to ``warn``)."""
    carry: Optional[CarrySpec] = None
    if len(region.computes) == 1:
        carry = g.nodes[region.computes[0]].meta.get("carry")
    elif any(g.nodes[c].meta.get("carry") for c in region.computes):
        warn(f"region {region.name}: carry compute in a multi-compute "
             "region; using gather fallback")
        return None
    multi_out = len(region.outputs) > 1
    if multi_out and carry is None and len(region.computes) > 1:
        warn(f"region {region.name}: {len(region.outputs)} output memories "
             "from a multi-compute region; tile emission needs a single "
             "compute (or a carry compute) — using gather fallback")
        return None
    if any(a is None for _c, _m, a in region.outputs):
        warn(f"region {region.name}: output access unknown")
        return None

    tile_fns = {}
    for c in region.computes:
        fn = _tile_fn_of(g, c)
        if fn is None and not (carry is not None and c == region.computes[0]):
            warn(f"region {region.name}: compute {c} has no per-tile body "
                 "(meta['tile_fn']); using gather fallback")
            return None
        if not region.bindings[c]:
            warn(f"region {region.name}: compute {c} has no operands")
            return None
        tile_fns[c] = fn

    def step_syms(c: str) -> Tuple[str, ...]:
        dom = g.nodes[c].domain
        return dom.symbols if dom is not None else ()

    outputs: List[Tuple[str, str, BlockedAccess]] = []
    for c, mem, acc in region.outputs:
        ba = blocked_access(acc, g.nodes[mem].shape, protect=step_syms(c))
        if ba is None:
            warn(f"region {region.name}: output access to {mem} is not "
                 "block-affine")
            return None
        outputs.append((c, mem, ba))
    out_block = outputs[0][2]

    blocks: Dict[Tuple[str, int], BlockedAccess] = {}
    extents: Dict[str, int] = dict(out_block.grid)
    extra_syms: List[str] = []
    for c in region.computes:
        for k, src in enumerate(region.bindings[c]):
            if src[0] != "mem":
                continue
            if src[2] is None:
                warn(f"region {region.name}: operand {src[1]} of {c} has "
                     "no access pattern")
                return None
            acc = blocked_access(src[2], g.nodes[src[1]].shape,
                                 protect=step_syms(c))
            if acc is None:
                warn(f"region {region.name}: operand {src[1]} of {c} is not "
                     "block-affine")
                return None
            for s, e in acc.grid:
                if extents.setdefault(s, e) != e:
                    warn(f"region {region.name}: grid extent mismatch on "
                         f"{s}: {extents[s]} vs {e}")
                    return None
                if s not in dict(out_block.grid) and s not in extra_syms:
                    extra_syms.append(s)
            blocks[(c, k)] = acc

    # canonical grid: output order first, extra symbols innermost
    grid = tuple(out_block.grid) + tuple((s, extents[s]) for s in extra_syms)
    reduce_syms = tuple(extra_syms)
    carry_syms: Tuple[str, ...] = ()
    outer_syms: Tuple[str, ...] = ()
    if multi_out and carry is None:
        # multi-output map (e.g. the SSD decode step's y + new state): every
        # output must be written exactly once per grid point, so reduction
        # symbols and grid mismatches between the outputs both disqualify
        # tile emission
        if extra_syms:
            warn(f"region {region.name}: multi-output region with reduction "
                 f"symbols {extra_syms}; using gather fallback")
            return None
        for _c, mem, ba in outputs[1:]:
            if tuple(ba.grid) != tuple(out_block.grid):
                warn(f"region {region.name}: output {mem} grid "
                     f"{ba.grid_symbols} differs from the region grid "
                     f"{out_block.grid_symbols}; using gather fallback")
                return None
    if carry is not None:
        # mixed carry+reduction first: naming the extra reduction symbols is
        # strictly more actionable than the generic innermost-axis message
        # (a serving-path regression to the gather tier must be diagnosable
        # from PipelineReport.warnings alone)
        mixed = [s for s in extra_syms if s != carry.axis]
        if mixed:
            warn(f"region {region.name}: mixed carry+reduction grid — "
                 f"carry axis {carry.axis!r} with extra reduction symbols "
                 f"{mixed}; using gather fallback")
            return None
        if not grid or grid[-1][0] != carry.axis:
            warn(f"region {region.name}: carry axis {carry.axis!r} is not "
                 "the innermost grid dimension; using gather fallback")
            return None
        carry_syms = (carry.axis,)
        reduce_syms = ()
        dom = g.nodes[region.computes[0]].domain
        outer_syms = tuple(s for s in dom.symbols if s != carry.axis)

    # full coverage is a *pre-temporal* property (the temporal rewrite
    # below moves extents between grid and block but never the product)
    covered = all(ba.covers(g.nodes[mem].shape) for _c, mem, ba in outputs)
    plan = RegionPlan(region=region, grid=grid, reduce_syms=reduce_syms,
                      blocks=blocks, outputs=outputs, tile_fns=tile_fns,
                      mode=region.mode, carry=carry, carry_syms=carry_syms,
                      outer_syms=outer_syms)
    _apply_temporal(g, plan, region.pump, warn)
    plan.pallas_ok = covered and _block_unit_ok(plan)
    return plan


def _append_pump(plan: RegionPlan, factor: int) -> None:
    """Insert the mode-R ``_pump`` grid axis.  For carry regions it goes
    *outside* the carry symbols (each sub-tile runs its own full sweep —
    interleaving sub-tiles inside a sweep would tear the carried state);
    otherwise innermost, walking the output sub-tiles per grid step."""
    if plan.carry_syms:
        idx0 = min(i for i, (s, _e) in enumerate(plan.grid)
                   if s in plan.carry_syms)
        plan.grid = plan.grid[:idx0] + ((PUMP_SYM, factor),) \
            + plan.grid[idx0:]
    else:
        plan.grid = tuple(plan.grid) + ((PUMP_SYM, factor),)


def _narrow_labelled(g: Graph, plan: RegionPlan, factor: int,
                     warn: Callable[[str], None]) -> bool:
    """Mode-R narrowing via the compute's declared axis correspondence
    (``meta['axes']``): narrow every block dimension labelled with the
    compute's ``narrow`` axis — output(s), operands and carry state alike.
    Exact by construction: a dimension is narrowed because the compute says
    it corresponds, not because its size or grid symbol happens to match.
    """
    comp = plan.out_compute
    axes = g.nodes[comp].meta.get("axes")
    name = axes.get("narrow") if axes else None
    if not name:
        return False
    out_maps, in_maps = axes.get("outs", ()), axes.get("ins", ())
    carry_maps = axes.get("carry", ())

    def dim_of(mapping) -> Optional[int]:
        hits = [d for d, nm in mapping.items() if nm == name]
        return hits[0] if hits else None

    d0 = dim_of(out_maps[0]) if out_maps else None
    if d0 is None or plan.outputs[0][2].block[d0] % factor:
        warn(f"region {plan.region.name}: mode-R axis {name!r} not "
             f"divisible by pump factor {factor}; temporal axis dropped")
        return True     # handled (by dropping), do not fall back
    new_outs = []
    for oi, (c, mem, ba) in enumerate(plan.outputs):
        d = dim_of(out_maps[oi]) if oi < len(out_maps) else None
        new_outs.append((c, mem, narrow_block(ba, d, factor)
                         if d is not None else ba))
    plan.outputs = new_outs
    narrowed = {}
    for (c, k), acc in plan.blocks.items():
        d = dim_of(in_maps[k]) if c == comp and k < len(in_maps) else None
        narrowed[(c, k)] = narrow_block(acc, d, factor) \
            if d is not None else acc
    plan.blocks = narrowed
    for si, mapping in enumerate(carry_maps):
        d = dim_of(mapping)
        if d is not None:
            plan.carry_narrow[si] = (d, factor)
    _append_pump(plan, factor)
    plan.pump = factor
    return True


def _apply_temporal(g: Graph, plan: RegionPlan, factor: int,
                    warn: Callable[[str], None]) -> None:
    """Realize pump factor M as the innermost ``_pump`` grid axis."""
    if factor <= 1:
        return
    if plan.mode == "T":
        if not plan.grid:
            warn(f"region {plan.region.name}: no grid dimension to pump")
            return
        sym, ext = plan.grid[-1]
        if ext % factor:
            warn(f"region {plan.region.name}: innermost grid extent {ext} "
                 f"({sym}) not divisible by pump factor {factor}; temporal "
                 "axis dropped")
            return
        try:
            plan.blocks = {k: split_temporal(a, sym, factor)
                           for k, a in plan.blocks.items()}
            plan.outputs = [(c, mem, split_temporal(ba, sym, factor))
                            for c, mem, ba in plan.outputs]
        except ValueError as err:    # e.g. a group-indexed (table) symbol
            warn(f"region {plan.region.name}: cannot split {sym}: {err}; "
                 "temporal axis dropped")
            return
        grid = [(s, e // factor if s == sym else e) for s, e in plan.grid]
        plan.grid = tuple(grid) + ((PUMP_SYM, factor),)
        if sym in plan.reduce_syms:
            plan.reduce_syms = plan.reduce_syms + (PUMP_SYM,)
        if sym in plan.carry_syms:
            # the M beats of one wide transaction continue the sweep
            plan.carry_syms = plan.carry_syms + (PUMP_SYM,)
        plan.pump = factor
        return
    # ---- mode R: narrow the output-carrying block dimension(s) -------------
    if _narrow_labelled(g, plan, factor, warn):
        return
    if plan.carry is not None:
        warn(f"region {plan.region.name}: carry region without a mode-R "
             "axis correspondence (meta['axes']); temporal axis dropped")
        return
    out = plan.out_block
    d_out = max((d for d, b in enumerate(out.block) if b > 1),
                default=None)
    if d_out is None or out.block[d_out] % factor:
        warn(f"region {plan.region.name}: mode-R output block not "
             f"divisible by pump factor {factor}; temporal axis dropped")
        return
    b_wide = out.block[d_out]
    dep = out.offsets[d_out]
    c0, mem0, _ = plan.outputs[0]
    plan.outputs = [(c0, mem0, narrow_block(out, d_out, factor))]
    narrowed = {}
    for key, acc in plan.blocks.items():
        new = acc
        for d in reversed(range(len(acc.block))):
            # dataflow correspondence: the operand dimension walks the
            # same offset expression as the output dimension being
            # narrowed (symbol-set matching is not enough — see the
            # mode-R regression tests)
            if acc.block[d] == b_wide and acc.offsets[d] == dep:
                new = narrow_block(acc, d, factor)
                break
        narrowed[key] = new
    plan.blocks = narrowed
    _append_pump(plan, factor)
    plan.pump = factor


def _block_unit_ok(plan: RegionPlan) -> bool:
    """True when every access (operands and outputs) has a block-unit index
    map — the post-temporal half of pallas expressibility."""
    return all(ba.block_unit_offsets() is not None
               for _c, _m, ba in plan.outputs) \
        and all(a.block_unit_offsets() is not None
                for a in plan.blocks.values())


# ---------------------------------------------------------------- emission --
def _affine_eval(a: Affine, env: Mapping[str, int]) -> int:
    out = a.const
    for s, c in a.terms:
        out = out + c * env[s]
    for s, t in a.tables:
        out = out + t[env[s]]        # group-indexed lookup: static table
    return out


def _grid_points(grid) -> List[Dict[str, int]]:
    syms = [s for s, _ in grid]
    return [dict(zip(syms, pt))
            for pt in itertools.product(*(range(e) for _, e in grid))]


def _carry_predicates(plan: RegionPlan, env: Mapping[str, int]):
    """(first, last, idx-kwargs) for one grid point of a carry plan."""
    exts = dict(plan.grid)
    first = all(env[s] == 0 for s in plan.carry_syms)
    last = all(env[s] == exts[s] - 1 for s in plan.carry_syms)
    step = 0
    for s in plan.carry_syms:
        step = step * exts[s] + env[s]
    kwargs = {}
    if plan.carry.pass_idx:
        kwargs["idx"] = dict(
            step=step,
            outer=tuple(env[s] for s in plan.outer_syms),
            pump=env.get(PUMP_SYM, 0) if PUMP_SYM not in plan.carry_syms
            else 0)
    return first, last, kwargs


def _run_tiles(plan: RegionPlan, get_block: Callable[[str, int], Any]) -> Any:
    """Evaluate the region's compute chain for one grid point;
    ``get_block(compute, operand_idx)`` supplies memory operand blocks."""
    tiles: Dict[str, Any] = {}
    for c in plan.region.computes:
        bound = {}
        for k, src in enumerate(plan.region.bindings[c]):
            if src[0] == "mem":
                bound[f"in{k}"] = get_block(c, k)
            else:
                bound[f"in{k}"] = tiles[src[1]]
        r = plan.tile_fns[c](**bound)
        tiles[c] = r["out0"] if isinstance(r, dict) else r
    return tiles[plan.out_compute]


def _box(ba: BlockedAccess, env) -> Tuple[slice, ...]:
    return tuple(slice(o, o + b) for o, b in
                 zip((_affine_eval(a, env) for a in ba.offsets), ba.block))


def emit_blockloop(g: Graph, plan: RegionPlan) -> Callable:
    """Tiers ``blockloop`` / ``carryloop``: the hopper schedule walked one
    grid point at a time in PyTorch with element-unit slices.  Carry plans
    thread the loop-carried state through the walk and may write several
    output memories; region functions return ``{memory name: tensor}``."""
    points = _grid_points(plan.grid)

    def make_get_block(mems, env):
        def get_block(c, k):
            acc = plan.blocks[(c, k)]
            return mems[plan.region.bindings[c][k][1]][_box(acc, env)]
        return get_block

    def write_block(buf, ba: BlockedAccess, env, tile, add=False):
        tile = torch.as_tensor(tile).reshape(ba.block).to(buf.dtype)
        box = _box(ba, env)
        buf[box] = buf[box] + tile if add else tile

    mems_order = [mem for _c, mem, _ba in plan.outputs]

    if plan.carry is not None:
        spec = plan.carry
        n_step_out = spec.n_step_outs(len(plan.outputs))
        comp = plan.out_compute
        n_ops = len(plan.region.bindings[comp])

        def region_fn(mems: Dict[str, Any]) -> Dict[str, Any]:
            dev = mems[mems_order[0]].device
            init_state = tuple(
                torch.as_tensor(a, device=dev)
                for a in spec.init_arrays(np, narrow=plan.carry_narrow))
            bufs = [mems[m].clone() for m in mems_order]
            carry = init_state
            for env in points:
                first, last, kwargs = _carry_predicates(plan, env)
                if first:
                    carry = init_state
                get_block = make_get_block(mems, env)
                blocks = [get_block(comp, k) for k in range(n_ops)]
                carry, souts = spec.step_fn(carry, *blocks, **kwargs)
                for k in range(n_step_out):
                    write_block(bufs[k], plan.outputs[k][2], env,
                                souts[f"out{k}"])
                if spec.final_fn is not None and last:
                    fouts = spec.final_fn(carry)
                    for k in range(n_step_out, len(plan.outputs)):
                        write_block(bufs[k], plan.outputs[k][2], env,
                                    fouts[f"out{k}"])
            return dict(zip(mems_order, bufs))

        return region_fn

    if len(plan.outputs) > 1:
        # multi-output map: one tile_fn call per grid point writes every
        # output block (no reduction symbols by plan construction)
        comp = plan.out_compute
        n_ops = len(plan.region.bindings[comp])

        def region_fn(mems: Dict[str, Any]) -> Dict[str, Any]:
            bufs = [mems[m].clone() for m in mems_order]
            for env in points:
                get_block = make_get_block(mems, env)
                r = plan.tile_fns[comp](
                    **{f"in{k}": get_block(comp, k) for k in range(n_ops)})
                for k, (buf, (_c, _m, ba)) in enumerate(
                        zip(bufs, plan.outputs)):
                    write_block(buf, ba, env, r[f"out{k}"])
            return dict(zip(mems_order, bufs))

        return region_fn

    out_mem, out_block = plan.out_mem, plan.out_block

    def region_fn(mems: Dict[str, Any]) -> Dict[str, Any]:
        buf = mems[out_mem].clone()
        for env in points:
            tile = _run_tiles(plan, make_get_block(mems, env))
            first = all(env[s] == 0 for s in plan.reduce_syms)
            write_block(buf, out_block, env, tile, add=not first)
        return {out_mem: buf}

    return region_fn


def emit_gather(g: Graph, region: Region) -> Callable:
    """Tier ``gather``: region-level fallback — one fused gather →
    compute-chain → scatter, addresses frozen from the access patterns.
    Multi-output computes scatter each named output; carry computes run
    the sequence form shared with the per-node lowering."""
    carry_fns: Dict[str, Callable] = {}
    idx_in: Dict[Tuple[str, int], IndexCache] = {}
    for c in region.computes:
        if g.nodes[c].meta.get("carry") is not None:
            carry_fns[c] = carry_sequence_apply(g, g.nodes[c])
        elif g.nodes[c].fn is None:
            raise LoweringError(
                f"compute module {c!r} has no fn body to lower")
        for k, src in enumerate(region.bindings[c]):
            if src[0] == "mem":
                if src[2] is None:
                    raise LoweringError(
                        f"operand {k} of {c} has no access pattern")
                idx_in[(c, k)] = IndexCache(
                    _indices(src[2], g.nodes[src[1]].shape))
    # per compute: (out-edge position, sink memory, scatter indices) —
    # keyed by edge position so output name binding (out0, out1, ...)
    # matches the executor's edge-order convention
    idx_out: Dict[str, List[Tuple[int, str, IndexCache]]] = {}
    for c in region.computes:
        for kpos, e in enumerate(g.out_edges(c)):
            sunk = _trace_to_sink(g, e)
            if sunk is not None:
                mem, access = sunk
                idx_out.setdefault(c, []).append(
                    (kpos, mem, IndexCache(scatter_indices(
                        access, g.nodes[mem].shape, where=f"{c}->{mem}"))))

    def region_fn(mems: Dict[str, Any]) -> Dict[str, Any]:
        dev = next(iter(mems.values())).device
        tiles: Dict[str, Any] = {}
        results: Dict[str, Dict[str, Any]] = {}
        for c in region.computes:
            bound = {}
            for k, src in enumerate(region.bindings[c]):
                if src[0] == "mem":
                    bound[f"in{k}"] = gather(mems[src[1]],
                                             idx_in[(c, k)].on(dev))
                else:
                    bound[f"in{k}"] = tiles[src[1]]
            if c in carry_fns:
                r = carry_fns[c](bound)
            else:
                r = g.nodes[c].fn(**bound)
            if not isinstance(r, dict):
                r = {"out0": r}
            results[c] = r
            tiles[c] = r["out0"]
        outs = {}
        for c, sinks in idx_out.items():
            for kpos, mem, idx in sinks:
                target = outs.get(mem, mems[mem])
                outs[mem] = scatter(target, idx.on(dev),
                                    results[c][f"out{kpos}"])
        return outs

    return region_fn


# ------------------------------------------------------ the hopper tier --
def _mem_operands(plan: RegionPlan) -> Optional[List[Tuple[str, int]]]:
    comp = plan.out_compute
    keys = [(comp, k) for k in range(len(plan.region.bindings[comp]))]
    if any(plan.region.bindings[c][k][0] != "mem" for c, k in keys):
        return None
    return keys


def region_descriptor(g: Graph, plan: RegionPlan,
                      dtype: Optional[str] = None
                      ) -> Tuple[Optional[RegionDesc], str]:
    """The region kernel's descriptor of a single-output plan, or ``(None,
    reason)`` when the kernel cannot take it.  ``dtype`` overrides the
    memories' dtype (the kernel's own checks use it)."""
    name = plan.region.name
    op = g.nodes[plan.out_compute].meta.get("tile_op")
    if len(plan.region.computes) != 1:
        return None, (f"region {name}: {len(plan.region.computes)} fused "
                      "computes; the region kernel takes one compute")
    if op not in RegionDesc.OPS:
        return None, (f"region {name}: tile op {op!r} is not one the region "
                      f"kernel takes ({', '.join(RegionDesc.OPS)})")
    keys = _mem_operands(plan)
    if keys is None or len(keys) != 2:
        return None, (f"region {name}: the region kernel takes two memory "
                      "operands")
    mems = [plan.region.bindings[c][k][1] for c, k in keys]
    syms = [s for s, _ in plan.grid]
    desc, why = describe(
        op, [e for _, e in plan.grid], [s in plan.reduce_syms for s in syms],
        syms.index(PUMP_SYM) if PUMP_SYM in syms else -1, syms,
        [(plan.blocks[key], g.nodes[m].shape, dtype or g.nodes[m].dtype)
         for key, m in zip(keys, mems)],
        (plan.out_block, g.nodes[plan.out_mem].shape,
         dtype or g.nodes[plan.out_mem].dtype))
    return desc, "" if desc is not None else f"region {name}: {why}"


def _region_kernel_form(g: Graph, plan: RegionPlan
                        ) -> Tuple[Optional[Callable], str]:
    """The single-output map/reduce form through the region kernel:
    ``(region_fn, '')``, or ``(None, reason)`` when the kernel cannot take
    the plan.  ``region_fn.desc`` is the descriptor it launches."""
    desc, why = region_descriptor(g, plan)
    if desc is None:
        return None, why
    comp, out_mem = plan.out_compute, plan.out_mem
    mems = [plan.region.bindings[comp][k][1] for k in range(2)]

    def region_fn(m: Dict[str, Any]) -> Dict[str, Any]:
        return {out_mem: ops.region_map_reduce(
            desc, [m[x].contiguous() for x in mems])}

    region_fn.desc = desc
    return region_fn, ""


def _operand_mems(plan: RegionPlan, n_in: int, n_out: int,
                  what: str) -> Tuple[Optional[List[str]], str]:
    """The memory operands of a one-compute region with ``n_in`` memory
    operands and ``n_out`` outputs, or ``(None, reason)``."""
    keys = _mem_operands(plan)
    if len(plan.region.computes) != 1 or keys is None or len(keys) != n_in \
            or len(plan.outputs) != n_out:
        return None, (f"region {plan.region.name}: a {what} region has one "
                      f"compute, {n_in} memory operands and {n_out} outputs")
    return [plan.region.bindings[c][k][1] for c, k in keys], ""


def _carry_dtype(g: Graph, plan: RegionPlan, mems: List[str]
                 ) -> Tuple[Optional[torch.dtype], str]:
    """The one fp32 / bf16 dtype of a carry kernel's float operands."""
    dts = {g.nodes[m].dtype for m in mems if g.nodes[m].dtype != "int32"}
    if len(dts) != 1 or not dts <= {"float32", "bfloat16"}:
        return None, (f"region {plan.region.name}: operand dtypes "
                      f"{sorted(dts)}; the kernel takes one of float32, "
                      f"bfloat16")
    return torch_dtype(dts.pop()), ""


def _out_dtypes(g: Graph, plan: RegionPlan) -> List[Tuple[str, torch.dtype]]:
    return [(mem, torch_dtype(g.nodes[mem].dtype))
            for _c, mem, _ba in plan.outputs]


def _flash_form(g: Graph, plan: RegionPlan
                ) -> Tuple[Optional[Callable], str]:
    """``_flash_graph``'s carry region bound to ``ops.flash_attention``:
    operands (q, k, v), outputs (o, m, l)."""
    from ..kernels import flash_attention as fa
    name = plan.region.name
    mems, why = _operand_mems(plan, 3, 3, "flash_attention")
    if mems is None:
        return None, why
    qs, ks, vs = (g.nodes[m].shape for m in mems)
    if len(qs) != 4 or len(ks) != 4 or ks != vs or ks[0] != qs[0] \
            or ks[3] != qs[3] or qs[1] % ks[1]:
        return None, f"region {name}: flash operand shapes {qs}, {ks}, {vs}"
    dt, why = _carry_dtype(g, plan, mems)
    if dt is None:
        return None, why
    if not fa.built(plan.pump, plan.mode, qs[3], dt):
        return None, (f"region {name}: flash_attention is not built for "
                      f"M={plan.pump} mode {plan.mode} at D {qs[3]} in "
                      f"{dt}")
    args = g.nodes[plan.out_compute].meta["tile_args"]
    spec = (plan.pump, plan.mode)
    outs = _out_dtypes(g, plan)

    def region_fn(m: Dict[str, Any]) -> Dict[str, Any]:
        q, k, v = (m[x].to(dt) for x in mems)
        r = ops.flash_attention(q, k, v, causal=args["causal"],
                                scale=args["scale"], pump=spec, stats=True)
        return {mem: t.to(odt) for (mem, odt), t in zip(outs, r)}

    return region_fn, ""


def _decode_form(g: Graph, plan: RegionPlan
                 ) -> Tuple[Optional[Callable], str]:
    """``_decode_attention_graph``'s carry region bound to
    ``ops.decode_attention``: operands (q, k, v, pos), output o."""
    from ..kernels import decode_attention as da
    name = plan.region.name
    mems, why = _operand_mems(plan, 4, 1, "decode_attention")
    if mems is None:
        return None, why
    qs, ks, vs, ps = (g.nodes[m].shape for m in mems)
    if len(qs) != 3 or len(ks) != 4 or ks != vs or ks[0] != qs[0] \
            or ks[3] != qs[2] or qs[1] % ks[1] or ps != (qs[0],) \
            or g.nodes[mems[3]].dtype != "int32":
        return None, (f"region {name}: decode operand shapes {qs}, {ks}, "
                      f"{vs}, pos {ps}")
    dt, why = _carry_dtype(g, plan, mems)
    if dt is None:
        return None, why
    group = qs[1] // ks[1]
    if not da.built(plan.pump, plan.mode, group, qs[2], dt):
        return None, (f"region {name}: decode_attention is not built for "
                      f"M={plan.pump} mode {plan.mode} at D {qs[2]}, group "
                      f"{group} in {dt}")
    args = g.nodes[plan.out_compute].meta["tile_args"]
    spec = (plan.pump, plan.mode)
    (o_mem, o_dt), = _out_dtypes(g, plan)

    def region_fn(m: Dict[str, Any]) -> Dict[str, Any]:
        q, k, v = (m[x].to(dt) for x in mems[:3])
        o = ops.decode_attention(q, k, v, m[mems[3]], scale=args["scale"],
                                 pump=spec)
        return {o_mem: o.to(o_dt)}

    return region_fn, ""


def _ssd_scan_form(g: Graph, plan: RegionPlan
                   ) -> Tuple[Optional[Callable], str]:
    """``_ssd_graph``'s carry region bound to ``ops.ssd_scan``: operands
    (x, dt, A, B, C), outputs y and, with ``final_state``, the state."""
    from ..kernels import ssd_scan as ss
    name = plan.region.name
    n_out = len(plan.outputs)
    mems, why = _operand_mems(plan, 5, n_out, "ssd_scan")
    if mems is None:
        return None, why
    xs, ds, as_, bs, cs = (g.nodes[m].shape for m in mems)
    if len(xs) != 4 or ds != xs[:3] or as_ != (xs[2],) or len(bs) != 4 \
            or bs != cs or bs[:2] != xs[:2] or xs[2] % bs[2] \
            or n_out not in (1, 2):
        return None, (f"region {name}: ssd_scan operand shapes {xs}, {ds}, "
                      f"{as_}, {bs}, {cs} with {n_out} outputs")
    chunk = g.nodes[plan.out_compute].meta["tile_args"]["chunk"]
    if chunk > ss.MAX_CHUNK or bs[3] > ss.MAX_STATE \
            or xs[3] > ss.MAX_HEAD_DIM:
        return None, (f"region {name}: ssd_scan chunk {chunk}, N {bs[3]}, "
                      f"P {xs[3]} over the kernel's {ss.MAX_CHUNK}, "
                      f"{ss.MAX_STATE}, {ss.MAX_HEAD_DIM}")
    dt, why = _carry_dtype(g, plan, mems)
    if dt is None:
        return None, why
    if not ss.built(plan.pump, plan.mode):
        return None, (f"region {name}: ssd_scan is not built for "
                      f"M={plan.pump} mode {plan.mode}")
    spec = (plan.pump, plan.mode)
    outs = _out_dtypes(g, plan)

    def region_fn(m: Dict[str, Any]) -> Dict[str, Any]:
        x, dtv, a, bm, cm = (m[k] for k in mems)
        r = ops.ssd_scan(x.to(dt), dtv.to(dt), a.float().contiguous(),
                         bm.to(dt), cm.to(dt), chunk=chunk,
                         final_state=n_out == 2, pump=spec)
        r = r if n_out == 2 else (r,)
        return {mem: t.to(odt) for (mem, odt), t in zip(outs, r)}

    return region_fn, ""


def _ssd_decode_form(g: Graph, plan: RegionPlan
                     ) -> Tuple[Optional[Callable], str]:
    """The multi-output map form of an ``'ssd_state_step'`` compute bound to
    ``csrc/ssd_decode.cu``: operands (state, x, dt, A, B, C), outputs (y,
    state').  Mode R at M > 1 walks P in M sub-tiles; mode T at M > 1 walks
    M heads per block."""
    name = plan.region.name
    mems, why = _operand_mems(plan, 6, 2, "ssd_state_step")
    if mems is None:
        return None, why
    shapes = [g.nodes[m].shape for m in mems]
    (b, h, n, p), xs = shapes[0], shapes[1]
    if xs != (b, h, p) or shapes[2] != (b, h) or shapes[3] != (h,) \
            or len(shapes[4]) != 3 or shapes[5] != shapes[4] \
            or h % shapes[4][1]:
        return None, f"region {name}: ssd_state_step operand shapes {shapes}"
    for m in mems + [mem for _c, mem, _ba in plan.outputs]:
        if g.nodes[m].dtype not in ("float32", "bfloat16"):
            return None, (f"region {name}: memory {m} dtype "
                          f"{g.nodes[m].dtype} is not fp32 or bf16")
    spec = (plan.pump, plan.mode)
    (y_mem, y_dt), (s_mem, s_dt) = _out_dtypes(g, plan)

    def region_fn(m: Dict[str, Any]) -> Dict[str, Any]:
        st, x, dt, a, bm, cm = (m[k] for k in mems)
        y, st2 = ops.ssd_decode(st.float().contiguous(), x, dt,
                                a.float().contiguous(), bm, cm, pump=spec)
        return {y_mem: y.to(y_dt), s_mem: st2.to(s_dt)}

    return region_fn, ""


CARRY_FORMS = {"flash_attention": _flash_form,
               "decode_attention": _decode_form, "ssd_scan": _ssd_scan_form}


def emit_hopper_carry(g: Graph, plan: RegionPlan
                      ) -> Tuple[Optional[Callable], str]:
    """Tier ``hopper`` for a block-unit, covering carry plan: the carry form
    its compute's ``tile_op`` names, or ``(None, reason)`` to drop to
    ``carryloop``."""
    op = g.nodes[plan.out_compute].meta.get("tile_op")
    form = CARRY_FORMS.get(op)
    if form is None:
        return None, (f"region {plan.region.name}: no hand-written kernel "
                      f"for a carry compute with tile op {op!r} (bound: "
                      f"{', '.join(CARRY_FORMS)})")
    return form(g, plan)


def emit_hopper(g: Graph, plan: RegionPlan) -> Tuple[Optional[Callable], str]:
    """Tier ``hopper`` for a block-unit, covering, carry-free plan:
    ``(region_fn, '')``, or ``(None, reason)`` to drop a tier."""
    op = g.nodes[plan.out_compute].meta.get("tile_op")
    if len(plan.outputs) > 1:
        if op != "ssd_state_step":
            return None, (f"region {plan.region.name}: a multi-output map "
                          f"reaches a hand-written kernel only as "
                          f"'ssd_state_step' (tile op {op!r})")
        return _ssd_decode_form(g, plan)
    return _region_kernel_form(g, plan)


# ------------------------------------------------------------- entry point --
def lower_hopper(g: Graph, warn: Optional[Callable[[str], None]] = None,
                 emission: Optional[dict] = None,
                 device: Optional[torch.device] = None
                 ) -> Callable[[Mapping[str, Any]], Dict[str, torch.Tensor]]:
    """Lower ``g`` through the fused-region hopper backend.

    Each region is planned as in the reference and emitted at the highest
    tier it reaches (module docstring).  ``emission`` (a dict) receives
    per-region provenance with the reference's keys: tier, pump, mode,
    grid, reduce, carry, outputs and ``why`` (every note that kept the
    region below ``hopper``).  The returned function runs on its inputs'
    device (``device`` when no input is a tensor)."""
    g.validate()
    warn = warn or (lambda msg: None)
    device = torch.device("cpu") if device is None else device

    regions = partition_regions(g)
    emitted: List[Tuple[Region, str, Callable]] = []
    for region in regions:
        notes: List[str] = []
        plan = plan_region(g, region, notes.append)
        fn = None
        if plan is None:
            tier = "gather"
        elif not plan.pallas_ok:
            tier = "carryloop" if plan.carry is not None else "blockloop"
            notes.append(f"region {region.name}: plan is not block-unit or "
                         "does not cover its output; the hopper tier needs "
                         "both")
        else:
            fn, why = (emit_hopper_carry if plan.carry is not None
                       else emit_hopper)(g, plan)
            tier = "hopper" if fn is not None else \
                "carryloop" if plan.carry is not None else "blockloop"
            if fn is None:
                notes.append(why)
        if fn is None:
            fn = emit_blockloop(g, plan) if plan is not None \
                else emit_gather(g, region)
        for n in notes:
            warn(n)
        if emission is not None:
            emission[region.name] = {
                "tier": tier,
                "pump": plan.pump if plan is not None else 1,
                "mode": region.mode,
                "grid": [list(d) for d in plan.grid] if plan else None,
                "reduce": list(plan.reduce_syms) if plan else None,
                "carry": list(plan.carry_syms) if plan else None,
                "outputs": [mem for _c, mem, _a in region.outputs],
                "why": list(notes),
            }
        emitted.append((region, tier, fn))

    # a hopper region writes every element of its outputs into a new
    # tensor, so those memories need no zeros first (unless some region
    # reads one before its writer runs, which the region order forbids)
    fresh = {mem for region, tier, _fn in emitted if tier == "hopper"
             for _c, mem, _a in region.outputs
             if all(src[1] != mem for srcs in region.bindings.values()
                    for src in srcs)}

    def run_fn(inputs: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        mems = init_memories(g, inputs, device, skip=fresh)
        for _region, _tier, fn in emitted:
            mems.update(fn(mems))
        return mems

    run_fn.regions = emitted   # (region, tier, region function) in order
    return run_fn
