"""Mixture-of-Experts layer (DeepSeek style: shared + routed top-k experts):
the port of ``repro.models.moe``.

``moe_apply`` takes the reference's three routes:

  - **capacity** (no cache; training semantics): GShard capacity
    ``int(capacity_factor · t·k / E) + 1``, rounded up to 256 from 4096
    tokens; tokens past an expert's capacity are dropped.
  - **dense dropless** (serving, ``dropless=True``): capacity ``t·k`` for
    ``inference_capacity_factor <= 0``, else the capped form, which drops.
    Both scatter into an (E, cap + 1, d) buffer and run the expert SwiGLU
    as three batched products.
  - **ragged dropless** (serving with ``ragged_dropless`` and icf <= 0):
    tokens sort by expert into row groups padded to 16 rows, and the three
    expert products run as ragged grouped GEMMs (``kernels.ops.
    grouped_gemm``, ``csrc/grouped_gemm.cu`` on the card) over a tile table
    built on the device, in row tiles of 16, 64 or 128 rows as the routed
    row count asks (``row_tile``).  The reference builds its group tables
    on the host from concrete routing, so it takes this route only outside
    a jit trace; the port runs eagerly and always has concrete routing.
    Under ``kernel_plan='measure'`` the products go through the plan
    registry instead (``_ragged_registry_experts``), as in the reference:
    group sizes on the host, bucketed, the compiled ragged graph.

Routing is fp32 softmax, top-k, and gates renormalised to sum to 1, or
under ``moe.norm_topk_prob=False`` (DeepSeek-V2 as published) the top-k
softmax probabilities as they are; the Switch aux loss comes back beside
the output.  The routed experts are stacked (E, d, de)
parameters ``gate`` / ``up`` and (E, de, d) ``down``, as in the reference's
params tree.

**Tracing.**  A serving call's routed part is the span ``moe.experts``,
and ``TALLY`` (``ExpertTally``) keeps per phase the calls, the routed
rows, the rows of the route's buffer and the experts each call hit
(``Engine`` folds it into stamped samples while a profiler records).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import ops

from .layers import Dense, SwiGLU, dense, on_whole_module, placed, swiglu

# the ragged route's group bucket (the reference's 'direct' plan: group
# sizes rounded up to 16)
ROW_TILE = 16


def row_tile(tk: int, e: int, dtype: torch.dtype) -> int:
    """The grouped GEMM's row tile for ``tk`` routed rows over ``e``
    experts, chosen on the host: 16 for a decode step, whose groups hold a
    row or two, and up to 128 once the groups average that many rows (a
    prefill), so an expert's weight panel is read by few row tiles.  The
    layout stays padded to 16 rows; ``tile_table`` cuts each group into
    tiles of at most this many rows."""
    want = 128 if tk >= 128 * e else 64 if tk >= 32 * e else ROW_TILE
    return max(bc for bc, _bf, _bd in gg.TILES[dtype] if bc <= want)


PHASES = ("prefill", "decode")


class ExpertTally:
    """What the serving MoE calls routed, per phase (``decode``: a call
    over one position a row; ``prefill`` any other): calls, routed rows
    (t·k) and rows of the route's buffer, counted on the host, and per
    expert the calls that gave it at least one row, added in place on the
    routing's device, so a captured decode step tallies at every replay
    (``serve.decode_graph`` adds the host counts per replay).

    ``Engine`` calls ``reset`` before a step and ``fold`` after its
    synchronize, both only while a profiler records: ``fold`` reads the
    step's tally back and records one stamped sample of each of
    ``moe.<phase>_calls``, ``_rows``, ``_buffer_rows`` and
    ``_experts_hit`` (Σ over the calls of the experts each hit) for every
    phase that ran.  Off the profiler nothing is read back."""

    def __init__(self):
        # phase -> [calls, routed rows, buffer rows]
        self.host: Dict[str, list] = {p: [0, 0, 0] for p in PHASES}
        # (device, phase, experts) -> (E,) int64 calls that hit each expert
        self._hits: Dict[tuple, torch.Tensor] = {}

    def add(self, phase: str, rows: int, buffer_rows: int,
            sizes: torch.Tensor) -> None:
        """One call: ``sizes`` (E,) the rows each expert took (any count
        that is 0 exactly where the expert took none)."""
        h = self.host[phase]
        h[0] += 1
        h[1] += rows
        h[2] += buffer_rows
        key = (sizes.device, phase, sizes.shape[0])
        hits = self._hits.get(key)
        if hits is None:
            hits = self._hits[key] = torch.zeros(
                sizes.shape, dtype=torch.long, device=sizes.device)
        hits.add_(sizes > 0)

    def reset(self) -> None:
        for h in self.host.values():
            h[:] = [0, 0, 0]
        for hits in self._hits.values():
            hits.zero_()

    def fold(self) -> None:
        reg = obs.default_metrics()
        for phase in PHASES:
            calls, rows, buf = self.host[phase]
            if not calls:
                continue
            hit = sum(int(v.sum()) for (_d, p, _e), v in self._hits.items()
                      if p == phase)
            for name, v in (("calls", calls), ("rows", rows),
                            ("buffer_rows", buf), ("experts_hit", hit)):
                reg.histogram(f"moe.{phase}_{name}").record(v)


TALLY = ExpertTally()


class MoE(nn.Module):
    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        mo = cfg.moe
        d, de, e = cfg.d_model, mo.d_expert, mo.n_experts
        self.router = Dense(d, e, dtype=dtype)
        self.gate = nn.Parameter(torch.empty(e, d, de, dtype=dtype))
        self.up = nn.Parameter(torch.empty(e, d, de, dtype=dtype))
        self.down = nn.Parameter(torch.empty(e, de, d, dtype=dtype))
        if mo.n_shared_experts:
            self.shared = SwiGLU(d, de * mo.n_shared_experts, dtype)


def _bincount(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert.  ``torch.bincount`` reads the largest id back
    to the host on the card; a scatter-add of fixed length does not."""
    return torch.zeros((e,), dtype=flat_e.dtype, device=flat_e.device) \
        .scatter_add_(0, flat_e, torch.ones_like(flat_e))


def ragged_layout(idx: torch.Tensor, e: int, bc: int = ROW_TILE):
    """The ragged route's row layout for a routing ``idx`` (t, k), built on
    idx's device with no host round trip.  Assignments sort by expert id
    (stably) into a row-major concatenation of groups, each padded to a
    multiple of ``ROW_TILE`` rows; the buffer is sized for the worst case,
    ⌈t·k / 16⌉ + E tiles of 16 rows, and the tile table, in tiles of at
    most ``bc`` rows (``row_tile``), covers it, its surplus tiles' rows
    coming out zero.  Returns (rows: the buffer row of each assignment
    (t·k,), padded group sizes (E,), the tile table, the buffer's row
    count)."""
    t, k = idx.shape
    flat_e = idx.reshape(-1)                                      # (t·k,)
    counts = _bincount(flat_e, e)
    padded = (counts + ROW_TILE - 1) // ROW_TILE * ROW_TILE
    n_rows = (-(-t * k // ROW_TILE) + e) * ROW_TILE
    # a group of padded rows takes at most padded / bc + 1 tiles of bc
    n_tiles = n_rows // bc if bc == ROW_TILE else -(-n_rows // bc) + e
    return _layout_rows(flat_e, counts, padded), padded, \
        gg.tile_table(padded, bc, n_tiles), n_rows


def _layout_rows(flat_e: torch.Tensor, counts: torch.Tensor,
                 padded: torch.Tensor) -> torch.Tensor:
    """The buffer row of each assignment when assignments sort by expert id
    (stably) into consecutive groups of ``padded`` rows."""
    order = torch.argsort(flat_e, stable=True)
    offs = torch.cumsum(padded, 0) - padded
    starts = torch.cumsum(counts, 0) - counts
    sorted_e = flat_e[order]
    rows = torch.empty_like(flat_e)
    rows[order] = offs[sorted_e] + (torch.arange(
        flat_e.shape[0], device=flat_e.device) - starts[sorted_e])
    return rows


def _ragged_dropless_experts(p: MoE, xt: torch.Tensor, gate: torch.Tensor,
                             idx: torch.Tensor, phase: str) -> torch.Tensor:
    """Expert SwiGLU over ragged row groups (the megablocks idiom), the
    reference's ``_ragged_dropless_experts`` on its 'direct' plan: tokens
    scatter once into the padded layout of ``ragged_layout`` and the three
    products read it through one tile table of ``row_tile`` rows."""
    t, d = xt.shape
    k = idx.shape[1]
    e = p.gate.shape[0]
    bc = row_tile(t * k, e, xt.dtype)
    rows, padded, tiles, n_rows = ragged_layout(idx, e, bc)
    TALLY.add(phase, t * k, n_rows, padded)
    xs = torch.zeros((n_rows, d), dtype=xt.dtype, device=xt.device)
    xs[rows] = xt.repeat_interleave(k, dim=0)

    def gemm(a, w):
        return ops.grouped_gemm(a, w.to(xt.dtype), bc=bc, tiles=tiles)

    h = F.silu(gemm(xs, p.gate), inplace=True).mul_(gemm(xs, p.up))
    del xs
    y_pad = gemm(h, p.down)
    gathered = y_pad[rows].reshape(t, k, d)                       # dropless:
    return torch.einsum("tkd,tk->td", gathered.float(),
                        gate).to(xt.dtype)                        # keep all


def _ragged_registry_experts(p: MoE, xt: torch.Tensor, gate: torch.Tensor,
                             idx: torch.Tensor, phase: str) -> torch.Tensor:
    """The ragged route under ``kernel_plan='measure'`` (the reference's
    registry branch, ``repro/models/moe.py:74-80``): the group sizes come to
    the host (one sync a layer), each is bucketed by the registry's
    ``policy.bucket_group``, tokens scatter once into that padded layout and
    the three products run through ``PlanRegistry.grouped_gemm`` (the
    compiled ragged graph: the region kernel on the card) under its
    ``ragged_pump``, so a fresh routing is planned, never measured."""
    from repro_torch.compiler.registry import default_registry
    reg = default_registry()
    t, d = xt.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    counts = _bincount(flat_e, p.gate.shape[0])
    padded = [reg.policy.bucket_group(c) for c in counts.tolist()]
    TALLY.add(phase, t * k, sum(padded), counts)
    rows = _layout_rows(flat_e, counts, torch.tensor(
        padded, dtype=counts.dtype, device=counts.device))
    xs = torch.zeros((sum(padded), d), dtype=xt.dtype, device=xt.device)
    xs[rows] = xt.repeat_interleave(k, dim=0)

    def gemm(a, w):
        return reg.grouped_gemm(a, w.to(xt.dtype), group_sizes=padded)

    h = F.silu(gemm(xs, p.gate), inplace=True).mul_(gemm(xs, p.up))
    del xs
    gathered = gemm(h, p.down)[rows].reshape(t, k, d)
    return torch.einsum("tkd,tk->td", gathered.float(),
                        gate).to(xt.dtype)


def moe_apply(p: MoE, cfg, x: torch.Tensor, *, dropless: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux loss).  ``dropless=True`` (the serving path)
    sizes capacity so that no token is dropped when icf <= 0; training
    uses GShard capacity semantics."""
    if placed(p, x):
        # a sharded step: the routing, its data-dependent scatters and the
        # expert products have no DTensor sharding strategy, so the layer
        # runs whole on every rank (ROADMAP queue 3)
        return on_whole_module(p, lambda xw: moe_apply(p, cfg, xw,
                                                       dropless=dropless), x)
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mo.n_experts, mo.top_k
    if dropless:
        icf = mo.inference_capacity_factor
        cap = t * k if icf <= 0 else min(t * k, -(-int(icf * t * k) // e) + 1)
    else:
        cap = int(mo.capacity_factor * t * k / e) + 1
        if t >= 4096:                    # production shapes: align for EP×DP
            cap = ((cap + 255) // 256) * 256

    xt = x.reshape(t, d)
    logits = dense(p.router, xt.float())                          # (t, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                      # (t, k)
    if mo.norm_topk_prob:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones((t * k,), device=x.device)) / (t * k)
    aux = e * torch.sum(me * ce) * mo.router_aux_weight

    # a serving call is tallied by phase; a training call is not
    phase = ("decode" if s == 1 else "prefill") if dropless else None
    with obs.span("moe.experts", cat="moe", rows=t * k):
        if dropless and mo.ragged_dropless \
                and mo.inference_capacity_factor <= 0:
            ragged = _ragged_registry_experts \
                if cfg.kernel_plan == "measure" else _ragged_dropless_experts
            y = ragged(p, xt, gate, idx, phase)
        else:
            y = _capacity_experts(p, xt, gate, idx, cap, phase)
    if mo.n_shared_experts:
        y = y + swiglu(p.shared, xt)
    return y.reshape(b, s, d), aux


def _capacity_experts(p: MoE, xt: torch.Tensor, gate: torch.Tensor,
                      idx: torch.Tensor, cap: int,
                      phase: Optional[str] = None) -> torch.Tensor:
    """Capacity dispatch: a stable sort of (expert, arrival) assigns slots,
    tokens scatter into an (E, cap + 1, d) buffer whose last row takes the
    overflow, the expert SwiGLU runs as batched products over the first cap
    rows and the kept slots gather back, weighted by their gates.  The
    buffers are freed as the products go: at deepseek-v2-lite's serving
    prefill (cap = t·k = 24,576) each is several GB.  This is also the
    training route (GShard capacity, ``moe_apply(dropless=False)``): under
    grad mode the SwiGLU is out of place, as autograd keeps both
    products."""
    t, d = xt.shape
    e, k = p.gate.shape[0], idx.shape[1]
    dev = xt.device
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = _bincount(flat_e, e)
    if phase is not None:
        TALLY.add(phase, t * k, e * cap, counts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos < cap
    posc = torch.where(keep, pos, cap)                  # cap = the trash row

    buf = torch.zeros((e, cap + 1, d), dtype=xt.dtype, device=dev)
    buf[flat_e, posc] = xt.repeat_interleave(k, dim=0)
    expert_in = buf[:, :cap]
    gate_in = torch.bmm(expert_in, p.gate.to(xt.dtype))
    up = torch.bmm(expert_in, p.up.to(xt.dtype))
    if torch.is_grad_enabled():
        h = F.silu(gate_in) * up
    else:
        h = F.silu(gate_in, inplace=True).mul_(up)
    del gate_in, up
    del buf, expert_in
    expert_out = torch.bmm(h, p.down.to(xt.dtype))                # (E, cap, d)
    del h
    padded = torch.cat([expert_out, expert_out.new_zeros((e, 1, d))], dim=1)
    del expert_out
    gathered = padded[flat_e, posc].reshape(t, k, d)
    return torch.einsum("tkd,tk->td", gathered.float(),
                        gate * keep.reshape(t, k)).to(xt.dtype)
