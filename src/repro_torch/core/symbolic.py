"""Minimal symbolic affine-expression engine for data-movement analysis.

The paper's streaming / multi-pumping legality checks (§3.2) rest on comparing
the *order* in which connected modules produce and consume memory locations.
DaCe uses sympy for this; we implement the small affine subset the analysis
needs so the package stays dependency-free:

    expr ::= const + sum_k coeff_k * sym_k

Access patterns are tuples of affine expressions over a rectangular iteration
domain.  Two patterns are *sequence-equivalent* when, walking their domains in
lexicographic order, they touch the same addresses in the same order — the
condition under which a memory edge can be replaced by a FIFO stream.

For grouped / ragged iteration (a MoE expert id selecting a weight slab, a
tile id selecting its group's row offset) the pure-affine subset is extended
with *group-indexed table terms*: ``Affine.table(sym, values)`` contributes
``values[sym]`` — a static integer lookup keyed by a domain symbol.  Tables
keep every analysis static (the lookup is data-independent, fixed at graph
construction), so streaming legality, blocked-view derivation and Pallas
index maps all continue to work; only the expression is no longer linear in
the table symbol.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Mapping, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Affine:
    """``const + Σ coeff[sym]·sym + Σ table[sym]`` with integer coefficients.

    ``tables`` holds group-indexed lookup terms ``(sym, values)``: the term
    contributes ``values[sym]`` — ragged row offsets, expert→slab ids, GQA
    head folding.  Lookups are static integer tables, so the expression
    stays analyzable; they are simply not linear in the table symbol.
    """

    terms: Tuple[Tuple[str, int], ...] = ()
    const: int = 0
    tables: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()

    # -- constructors -------------------------------------------------------
    @staticmethod
    def of(sym: str, coeff: int = 1, const: int = 0) -> "Affine":
        if coeff == 0:
            return Affine((), const)
        return Affine(((sym, coeff),), const)

    @staticmethod
    def constant(c: int) -> "Affine":
        return Affine((), c)

    @staticmethod
    def table(sym: str, values: Iterable[int]) -> "Affine":
        """Group-indexed term ``values[sym]`` (static integer lookup)."""
        return Affine((), 0, ((sym, tuple(int(v) for v in values)),))

    def _as_dict(self) -> Dict[str, int]:
        return dict(self.terms)

    @staticmethod
    def _from_dict(d: Mapping[str, int], const: int,
                   tables: Tuple = ()) -> "Affine":
        items = tuple(sorted((s, c) for s, c in d.items() if c != 0))
        return Affine(items, const, tables)

    # -- algebra -------------------------------------------------------------
    def __add__(self, other: "Affine | int") -> "Affine":
        if isinstance(other, int):
            return Affine(self.terms, self.const + other, self.tables)
        d = self._as_dict()
        for s, c in other.terms:
            d[s] = d.get(s, 0) + c
        return Affine._from_dict(d, self.const + other.const,
                                 self.tables + other.tables)

    def __radd__(self, other: int) -> "Affine":
        return self.__add__(other)

    def __mul__(self, k: int) -> "Affine":
        if not isinstance(k, int):
            raise TypeError("Affine supports multiplication by int only")
        return Affine._from_dict(
            {s: c * k for s, c in self.terms}, self.const * k,
            tuple((s, tuple(v * k for v in t)) for s, t in self.tables))

    __rmul__ = __mul__

    def __sub__(self, other: "Affine | int") -> "Affine":
        if isinstance(other, int):
            other = Affine.constant(other)
        return self + other * (-1)

    # -- queries --------------------------------------------------------------
    def symbols(self) -> Tuple[str, ...]:
        return tuple(s for s, _ in self.terms) \
            + tuple(s for s, _ in self.tables)

    def coeff(self, sym: str) -> int:
        return self._as_dict().get(sym, 0)

    def table_range(self) -> Tuple[int, int]:
        """(min, max) total contribution of the table terms."""
        lo = hi = 0
        for _s, t in self.tables:
            lo += min(t)
            hi += max(t)
        return lo, hi

    def evaluate(self, env: Mapping[str, int]) -> int:
        out = self.const + sum(c * env[s] for s, c in self.terms)
        for s, t in self.tables:
            out += t[env[s]]
        return out

    def substitute(self, mapping: Mapping[str, "Affine"]) -> "Affine":
        for s, _t in self.tables:
            if s in mapping:
                raise ValueError(
                    f"cannot substitute table-indexed symbol {s!r}; "
                    "group-indexed lookups are not linear")
        out = Affine((), self.const, self.tables)
        for s, c in self.terms:
            repl = mapping.get(s)
            if repl is None:
                out = out + Affine.of(s, c)
            else:
                out = out + repl * c
        return out

    def rename(self, mapping: Mapping[str, str]) -> "Affine":
        return Affine._from_dict(
            {mapping.get(s, s): c for s, c in self.terms}, self.const,
            tuple((mapping.get(s, s), t) for s, t in self.tables)
        )

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        parts = [f"{c}*{s}" for s, c in self.terms]
        parts += [f"tbl[{s}]" for s, _ in self.tables]
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts)


@dataclasses.dataclass(frozen=True)
class Domain:
    """Rectangular iteration domain; dims walked in lexicographic order."""

    dims: Tuple[Tuple[str, int, int, int], ...]  # (sym, start, stop, step)

    @staticmethod
    def of(*dims: Tuple[str, int, int] | Tuple[str, int, int, int]) -> "Domain":
        norm = []
        for d in dims:
            if len(d) == 3:
                norm.append((d[0], d[1], d[2], 1))
            else:
                norm.append(tuple(d))
        return Domain(tuple(norm))

    @property
    def symbols(self) -> Tuple[str, ...]:
        return tuple(d[0] for d in self.dims)

    @property
    def extents(self) -> Tuple[int, ...]:
        return tuple(
            max(0, (stop - start + step - 1) // step)
            for _, start, stop, step in self.dims
        )

    def size(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n

    def points(self, limit: int | None = None) -> Iterable[Dict[str, int]]:
        ranges = [range(start, stop, step) for _, start, stop, step in self.dims]
        for i, combo in enumerate(itertools.product(*ranges)):
            if limit is not None and i >= limit:
                return
            yield dict(zip(self.symbols, combo))

    def scaled(self, sym: str, factor: int) -> "Domain":
        """Divide extent of ``sym`` by ``factor`` (vectorization of a range)."""
        out = []
        for s, start, stop, step in self.dims:
            if s == sym:
                n = (stop - start + step - 1) // step
                if n % factor != 0:
                    raise ValueError(
                        f"extent of {sym} ({n}) not divisible by pump factor {factor}"
                    )
                out.append((s, start, start + (n // factor) * step, step))
            else:
                out.append((s, start, stop, step))
        return Domain(tuple(out))


@dataclasses.dataclass(frozen=True)
class AccessPattern:
    """Multi-dimensional affine access walked over a Domain."""

    domain: Domain
    exprs: Tuple[Affine, ...]
    # number of contiguous elements touched per point along the last dim
    width: int = 1

    def addresses(self, shape: Sequence[int], limit: int | None = None):
        """Linearized addresses in iteration order (for brute-force checks)."""
        strides = []
        acc = 1
        for s in reversed(shape):
            strides.append(acc)
            acc *= s
        strides = list(reversed(strides))
        for env in self.domain.points(limit=limit):
            base = sum(
                e.evaluate(env) * st for e, st in zip(self.exprs, strides)
            )
            for w in range(self.width):
                yield base + w

    def normalized_exprs(self) -> Tuple[Affine, ...]:
        """Rename domain symbols to canonical names _i0, _i1, ..."""
        mapping = {s: f"_i{k}" for k, s in enumerate(self.domain.symbols)}
        return tuple(e.rename(mapping) for e in self.exprs)


@dataclasses.dataclass(frozen=True)
class BlockedAccess:
    """A block-structured reading of an :class:`AccessPattern`.

    The Pallas emission backend consumes this instead of the flat address
    sequence: every grid point ``env`` (one integer per outer symbol) touches
    the dense box ``[offsets[d](env) : offsets[d](env) + block[d]]`` per
    memory dimension.  ``offsets`` are *element-unit* affines over the grid
    symbols; dividing them by ``block`` (when exact) yields the block-unit
    index map a ``pl.BlockSpec`` wants — see :meth:`block_unit_offsets`.
    """

    block: Tuple[int, ...]                 # slice extent per memory dim
    grid: Tuple[Tuple[str, int], ...]      # (symbol, extent), outermost first
    offsets: Tuple[Affine, ...]            # element-unit start per memory dim

    @property
    def grid_symbols(self) -> Tuple[str, ...]:
        return tuple(s for s, _ in self.grid)

    def block_unit_offsets(self) -> "Tuple[Affine, ...] | None":
        """Offsets divided by the block extents, or None when any coefficient
        is not an exact multiple (the access is then not expressible as a
        Pallas block-index map, only as an element-unit ``dynamic_slice``)."""
        out = []
        for a, b in zip(self.offsets, self.block):
            if b == 1:
                out.append(a)
                continue
            if a.const % b or any(c % b for _, c in a.terms) \
                    or any(v % b for _, t in a.tables for v in t):
                return None
            out.append(Affine(tuple((s, c // b) for s, c in a.terms),
                              a.const // b,
                              tuple((s, tuple(v // b for v in t))
                                    for s, t in a.tables)))
        return tuple(out)

    def covers(self, shape: Sequence[int]) -> bool:
        """True when the grid×block tiling exactly covers ``shape`` element
        count (no gaps) — the precondition for emitting this access as a
        Pallas *output* whose buffer starts uninitialized."""
        n = 1
        for b in self.block:
            n *= b
        for _, e in self.grid:
            n *= e
        total = 1
        for s in shape:
            total *= s
        return n == total


def blocked_access(acc: AccessPattern, shape: Sequence[int],
                   protect: Sequence[str] = ()) -> "BlockedAccess | None":
    """Derive a :class:`BlockedAccess` from ``acc`` over a memory ``shape``.

    Two sources contribute to the block: the contiguous ``width`` (spilling
    backwards over trailing dimensions whose expression is identically 0),
    and a suffix of unit-coefficient, unit-step domain symbols that each walk
    one dimension densely (e.g. the row symbol of a matmul panel).  Remaining
    (outer) symbols become the grid.  Returns None when the pattern does not
    decompose this way — callers fall back to flat gather/scatter lowering.

    ``protect`` lists domain symbols that must stay *grid* symbols even when
    they walk a dimension densely.  A compute's step-domain symbols are
    protected by the region planner/carry layout: an access like
    ``o[bi, hi, :]`` over the domain ``(bi, hi)`` is locally one dense
    ``(b, h, d)`` block, but the kernel visits it one ``(1, 1, d)`` tile per
    (bi, hi) grid point — absorbing the step symbols would collapse the
    emission grid (and mis-size per-sweep carry outputs).
    """
    rank = len(shape)
    if len(acc.exprs) != rank:
        return None

    block = [1] * rank
    exprs = list(acc.exprs)

    # 1. distribute the contiguous width over trailing dims
    w = acc.width
    d = rank - 1
    while w > 1 and d >= 0:
        if w >= shape[d]:
            if w % shape[d] or exprs[d].terms or exprs[d].const:
                return None        # spill requires a full, zero-based dim
            block[d] = shape[d]
            w //= shape[d]
        else:
            block[d] = w
            w = 1
        d -= 1
    if w > 1:
        return None

    # 2. absorb a dense suffix of intra-block symbols (unit coeff/step/base)
    dims = list(acc.domain.dims)
    extents = list(acc.domain.extents)
    while dims:
        sym, start, _stop, step = dims[-1]
        ext = extents[-1]
        if sym in protect:
            break
        hits = [i for i, e in enumerate(exprs) if e.coeff(sym)]
        if len(hits) != 1 or exprs[hits[0]].coeff(sym) != 1:
            break
        if start != 0 or step != 1:
            break
        i = hits[0]
        if block[i] != 1:
            break                   # width already owns this dimension
        rest = exprs[i].substitute({sym: Affine.constant(0)})
        if rest.const % ext or any(c % ext for _, c in rest.terms) \
                or any(v % ext for _, t in rest.tables for v in t):
            break                   # unaligned dense walk: keep as grid dim
        block[i] = ext
        exprs[i] = rest
        dims.pop()
        extents.pop()

    # 3. remaining (outer) symbols form the grid; emission walks raw indices
    #    0..extent-1, so they must be zero-based with unit step
    for sym, start, _stop, step in dims:
        if start != 0 or step != 1:
            return None
    grid = tuple((s, e) for (s, _, _, _), e in zip(dims, extents))
    grid_syms = {s for s, _ in grid}
    for e in exprs:
        if any(s not in grid_syms for s in e.symbols()):
            return None             # leftover intra symbol in an offset
    # 4. every grid point's box must stay in bounds (no row straddling)
    for d_i, (e, b) in enumerate(zip(exprs, block)):
        tlo, thi = e.table_range()
        lo = e.const + tlo
        hi = e.const + thi
        for s, c in e.terms:
            ext = dict(grid)[s]
            if c >= 0:
                hi += c * (ext - 1)
            else:
                lo += c * (ext - 1)
        if lo < 0 or hi + b > shape[d_i]:
            return None
    return BlockedAccess(tuple(block), grid, tuple(exprs))


def split_temporal(acc: BlockedAccess, sym: str, factor: int,
                   pump_sym: str = "_pump") -> BlockedAccess:
    """Mode-T temporal realization: split grid symbol ``sym`` (extent G) into
    an outer symbol of extent G/factor and the innermost temporal symbol
    ``pump_sym`` of extent ``factor`` — one wide transaction per outer step,
    ``factor`` narrow beats per transaction.  Offsets are rewritten by the
    exact substitution ``sym -> sym*factor + pump_sym``."""
    repl = Affine.of(sym, factor) + Affine.of(pump_sym)
    grid = []
    for s, e in acc.grid:
        if s == sym:
            if e % factor:
                raise ValueError(f"extent {e} of {sym} not divisible by "
                                 f"pump factor {factor}")
            grid.append((s, e // factor))
        else:
            grid.append((s, e))
    grid.append((pump_sym, factor))
    offsets = tuple(e.substitute({sym: repl}) for e in acc.offsets)
    return BlockedAccess(acc.block, tuple(grid), offsets)


def narrow_block(acc: BlockedAccess, dim: int, factor: int,
                 pump_sym: str = "_pump") -> BlockedAccess:
    """Mode-R temporal realization for one access: narrow ``block[dim]`` by
    ``factor`` and walk the ``factor`` sub-tiles with the temporal symbol
    (which the caller appends to the region grid)."""
    b = acc.block[dim]
    if b % factor:
        raise ValueError(f"block extent {b} not divisible by {factor}")
    block = list(acc.block)
    block[dim] = b // factor
    offsets = list(acc.offsets)
    offsets[dim] = offsets[dim] + Affine.of(pump_sym, b // factor)
    return BlockedAccess(tuple(block), acc.grid, tuple(offsets))


def sequence_equivalent(
    a: AccessPattern, b: AccessPattern, shape: Sequence[int], probe: int = 4096
) -> bool:
    """True iff ``a`` and ``b`` touch the same address sequence in order.

    This is the intersection/order check from §3.2 used to decide whether a
    memory edge between two modules may become a FIFO stream.  Fast path:
    identical domains (up to symbol names) and identical normalized affine
    expressions.  Slow path (small domains / differing shapes): brute-force
    compare the first ``probe`` linearized addresses.
    """
    if (
        a.domain.extents == b.domain.extents
        and a.width == b.width
        and a.normalized_exprs() == b.normalized_exprs()
    ):
        return True
    # brute force fallback, bounded
    if a.domain.size() * a.width != b.domain.size() * b.width:
        return False
    seq_a = a.addresses(shape, limit=probe)
    seq_b = b.addresses(shape, limit=probe)
    return all(x == y for x, y in itertools.zip_longest(seq_a, seq_b))
