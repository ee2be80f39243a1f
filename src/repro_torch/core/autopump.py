"""Automatic multi-pumping: the paper's end-to-end workflow as one call.

The paper's §3 pipeline is: program → dataflow IR → streaming pass →
(greedy largest-subgraph) multi-pump transform → codegen.  This module is
that pipeline for our kernel library: each registered kernel carries an IR
*builder* describing its data movement; :func:`autopump` runs the passes,
checks legality, consults the capacity model for the factor, and returns
both the transformed graph (for inspection/reporting) and the
:class:`~repro_torch.core.ir.PumpSpec` the kernel layer consumes.

    spec, report = autopump("matmul", m=4096, n=4096, k=4096)
    out = kernels.matmul(a, b, pump=spec)

This is the "automatic application" contribution: the user never chooses M
or identifies the streamable subgraph by hand.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .ir import CarrySpec, Graph, PumpSpec
from .multipump import PumpReport
from .pump_plan import KernelEstimate, SMEM_BYTES, dot_panel_bytes
from .symbolic import AccessPattern, Affine, Domain


@dataclasses.dataclass
class AutopumpResult:
    spec: PumpSpec
    graph: Graph                 # transformed IR (streamed + pumped)
    streaming_report: object
    pump_report: Optional[PumpReport]
    estimate: KernelEstimate
    pipeline_report: object = None   # repro_torch.compiler PipelineReport
    kernel: object = None            # CompiledKernel when backend != 'none'

    def summary(self) -> str:
        r = self.graph.resources()
        return (f"M={self.spec.factor} mode={self.spec.mode} "
                f"units={r['compute_units']} adapters={r['adapters']} "
                f"modeled_tp={self.estimate.throughput(self.spec.factor):.3g}/s")


def _xp(a):
    """numpy/torch dispatch for fn bodies that need library calls (not just
    operators): ``torch`` for a tensor, ``numpy`` for anything else (the
    executor's arrays and scalars).  The bodies keep to calls both modules
    spell alike (``exp``, ``where``, ``maximum``, ``amax``, ``cumsum`` with
    ``axis``, ``sum(axis=, keepdims=)``); ``_f32`` and ``_arange`` cover the
    two that differ."""
    if isinstance(a, torch.Tensor):
        return torch
    return np


def _f32(a):
    """``a`` as float32: ``.astype`` for numpy, ``.to`` for torch."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return np.asarray(a).astype(np.float32)


def _arange(n: int, like):
    """``arange(n)`` beside ``like`` (on its device for a tensor)."""
    if isinstance(like, torch.Tensor):
        return torch.arange(n, device=like.device)
    return np.arange(n)


# ------------------------------------------------------------ IR builders --
# fn bodies are numpy/torch polymorphic (operator-based) so the same body runs
# in the reference executor and in the compiler's lowering backends.  The
# optional meta['tile_fn'] is the *per-grid-step* form consumed by the
# fused-region backend: it maps operand blocks (shaped per the blocked view of
# the access pattern) to one output block, while fn maps whole FIFO
# sequences.  meta['reduce']='add' marks tile_fn outputs as partial
# contributions accumulated over grid dims absent from the output access.
# Kernels with a loop-carried dependency declare meta['carry'] (a CarrySpec:
# per-step step_fn + per-sweep final_fn over block-shaped operands) instead
# of fn/tile_fn, and meta['axes'] labels each operand/output/state dimension
# with a logical axis so mode-R narrowing follows the dataflow
# correspondence rather than a size/symbol heuristic.
def _vecadd_graph(n: int, vector_width: int = 8, itemsize: int = 4):
    v = vector_width
    g = Graph("vecadd")
    g.memory("x", (n,))
    g.memory("y", (n,))
    g.memory("z", (n,))
    dom = Domain.of(("i", 0, max(n // v, 1)))
    acc = AccessPattern(dom, (Affine.of("i", v),), width=v)
    add = lambda in0, in1: {"out0": in0 + in1}   # noqa: E731 - elementwise
    g.compute("add", dom, fn=add, vector_width=v, tile_fn=add, tile_op="add")
    g.connect("x", "add", acc)
    g.connect("y", "add", acc)
    g.connect("add", "z", acc)
    est = KernelEstimate(block_bytes_in=2 * v * itemsize,
                         block_bytes_out=v * itemsize,
                         flops_per_block=float(v))
    return g, est


def _matmul_graph(m: int, n: int, k: int, bm: int = 128, bn: int = 128,
                  bk: int = 128, itemsize: int = 4,
                  vector_width: Optional[int] = None):
    g = Graph("matmul")
    g.memory("a", (m, k))
    g.memory("b", (k, n))
    g.memory("c", (m, n))
    dom = Domain.of(("i", 0, max(m // bm, 1)), ("j", 0, max(n // bn, 1)),
                    ("kk", 0, max(k // bk, 1)))
    fn = None
    if m % bm == 0 and n % bn == 0 and k % bk == 0:
        # Executable form: access patterns walk full (row-contiguous) operand
        # panels per block point, so the FIFO sequences carry all the data
        # and the compute body is a real blocked matmul.
        nbm, nbn, nbk = m // bm, n // bn, k // bk
        dom_a = Domain.of(("i", 0, nbm), ("j", 0, nbn), ("kk", 0, nbk),
                          ("r", 0, bm))
        acc_a = AccessPattern(
            dom_a, (Affine.of("i", bm) + Affine.of("r"), Affine.of("kk", bk)),
            width=bk)
        dom_b = Domain.of(("i", 0, nbm), ("j", 0, nbn), ("kk", 0, nbk),
                          ("r", 0, bk))
        acc_b = AccessPattern(
            dom_b, (Affine.of("kk", bk) + Affine.of("r"), Affine.of("j", bn)),
            width=bn)
        dom_c = Domain.of(("i", 0, nbm), ("j", 0, nbn), ("r", 0, bm))
        acc_c = AccessPattern(
            dom_c, (Affine.of("i", bm) + Affine.of("r"), Affine.of("j", bn)),
            width=bn)

        def fn(in0, in1):
            a = in0.reshape(nbm, nbn, nbk, bm, bk)
            b = in1.reshape(nbm, nbn, nbk, bk, bn)
            return {"out0": (a @ b).sum(axis=2).reshape(-1)}

        # per-tile form: one MXU panel product, accumulated over the kk
        # grid dimension (absent from the output access) by the backend
        tile_fn = lambda in0, in1: {"out0": in0 @ in1}   # noqa: E731
    else:
        # Fallback (non-divisible shapes): corner-sampled transaction
        # schedule — enough for planning/legality, not executable.
        acc_a = AccessPattern(dom, (Affine.of("i", bm), Affine.of("kk", bk)),
                              width=1)
        acc_b = AccessPattern(dom, (Affine.of("kk", bk), Affine.of("j", bn)),
                              width=1)
        acc_c = AccessPattern(dom, (Affine.of("i", bm), Affine.of("j", bn)),
                              width=1)
        tile_fn = None
    if vector_width is None:
        vector_width = bm * bn // (128 * 128) or 1
    g.compute("mxu_tile", dom, fn=fn, vector_width=vector_width,
              tile_fn=tile_fn, reduce="add", tile_op="dot")
    g.connect("a", "mxu_tile", acc_a)
    g.connect("b", "mxu_tile", acc_b)
    g.connect("mxu_tile", "c", acc_c)
    est = KernelEstimate(block_bytes_in=(bm * bk + bk * bn) * itemsize,
                         block_bytes_out=0.0,
                         flops_per_block=2.0 * bm * bn * bk,
                         panel_bytes=dot_panel_bytes(bm, bn, bk, itemsize))
    return g, est


def _stencil_graph(d0: int, d1: int, d2: int, itemsize: int = 4,
                   coef: float = 0.25):
    """Plane-sweep Jacobi update along axis 0: each interior plane i+1 of
    ``y`` is rebuilt from the three-plane halo window x[i:i+3]; boundary
    planes keep the output memory's initial contents (zeros)."""
    g = Graph("stencil")
    g.memory("x", (d0, d1, d2))
    g.memory("y", (d0, d1, d2))
    ni = max(d0 - 2, 1)
    dom = Domain.of(("i", 0, ni))
    # overlapping halo reads: plane window [i, i+3); interior-plane writes
    acc_in = AccessPattern(dom, (Affine.of("i"), Affine.constant(0),
                                 Affine.constant(0)), width=3 * d1 * d2)
    acc_out = AccessPattern(dom, (Affine.of("i") + 1, Affine.constant(0),
                                  Affine.constant(0)), width=d1 * d2)

    def tile_fn(in0):
        # one halo window (3, d1', d2') -> one interior plane (1, d1', d2');
        # shape-polymorphic in the trailing dims (mode R narrows them)
        return {"out0": coef * (in0[0:1] + in0[2:3])
                + (1.0 - 2.0 * coef) * in0[1:2]}

    def fn(in0):
        w = in0.reshape(-1, 3, d1, d2)
        out = coef * (w[:, 0] + w[:, 2]) + (1.0 - 2.0 * coef) * w[:, 1]
        return {"out0": out.reshape(-1)}

    g.compute("plane_update", dom, fn=fn, tile_fn=tile_fn,
              vector_width=max(d1 * d2 // 128, 4))
    g.connect("x", "plane_update", acc_in)
    g.connect("plane_update", "y", acc_out)
    est = KernelEstimate(block_bytes_in=3 * d1 * d2 * itemsize,
                         block_bytes_out=d1 * d2 * itemsize,
                         flops_per_block=7.0 * d1 * d2)
    return g, est


def _floyd_graph(n: int, itemsize: int = 4):
    """All-pairs shortest paths.  The k-relaxation carries a loop-borne
    dependency through the whole matrix, so the IR models one compute whose
    fn runs the full pivot loop; the access pattern streams the matrix
    row-by-row (duplicate-free, so the graph is lowerable)."""
    g = Graph("floyd_warshall")
    g.memory("dist", (n, n))
    g.memory("out", (n, n))
    dom = Domain.of(("r", 0, n))
    acc = AccessPattern(dom, (Affine.of("r"), Affine.constant(0)), width=n)

    def fn(in0):
        xp = _xp(in0)
        d = in0.reshape(n, n)
        for k in range(n):
            d = xp.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
        return {"out0": d.reshape(-1)}

    g.compute("relax", dom, fn=fn, vector_width=max(n // 128, 4),
              data_dependent_io=False)
    g.connect("dist", "relax", acc)
    g.connect("relax", "out", acc)
    est = KernelEstimate(block_bytes_in=2 * n * itemsize,   # pivot row+col
                         block_bytes_out=0.0,
                         flops_per_block=2.0 * n * n)
    return g, est


NEG_INF = -1e30


def _blk(sym: str, size: int, nblocks: int) -> Affine:
    """Block-offset expression ``sym*size``; collapses to the constant 0
    when the axis has a single block (a symbolically nonzero expression on a
    width-spanned dimension would defeat blocked-view derivation)."""
    return Affine.of(sym, size) if nblocks > 1 else Affine.constant(0)


def _flash_graph(b: int, h: int, s: int, t: int, d: int, bq: int = 128,
                 bkv: int = 128, itemsize: int = 2, hkv: Optional[int] = None,
                 causal: bool = False, scale: Optional[float] = None,
                 dtype: str = "float32", vector_width: Optional[int] = None):
    """Flash attention as an executable carry graph.

    The online-softmax recurrence over KV blocks is the sequential-carry
    axis (``ji``); the compute is *multi-output* — the attention tile plus
    its running max and denominator land in three memories (``o``, ``m``,
    ``l``).  GQA head folding is a group-indexed table on the KV head dim.
    """
    hkv = hkv or h
    g = Graph("flash_attention")
    g.memory("q", (b, h, s, d), dtype=dtype)
    g.memory("k", (b, hkv, t, d), dtype=dtype)
    g.memory("v", (b, hkv, t, d), dtype=dtype)
    g.memory("o", (b, h, s, d), dtype=dtype)
    g.memory("m", (b, h, s))
    g.memory("l", (b, h, s))
    bq, bkv = min(bq, s), min(bkv, t)
    if scale is None:
        scale = d ** -0.5
    if vector_width is None:
        vector_width = bq * d // 128 or 1
    est = KernelEstimate(block_bytes_in=2 * bkv * d * itemsize,
                         block_bytes_out=0.0,
                         flops_per_block=4.0 * bq * bkv * d)

    nq, nj = s // bq, t // bkv
    dom = Domain.of(("bi", 0, b), ("hi", 0, h), ("qi", 0, max(nq, 1)),
                    ("ji", 0, max(nj, 1)))
    if s % bq or t % bkv or h % hkv:
        # corner-sampled transaction schedule: planning/legality only
        acc_kv = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                     Affine.of("ji", bkv),
                                     Affine.constant(0)), width=1)
        acc_o = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                    Affine.of("qi", bq), Affine.constant(0)),
                              width=1)
        g.compute("online_softmax", dom, vector_width=vector_width)
        g.connect("q", "online_softmax", acc_o)
        g.connect("k", "online_softmax", acc_kv)
        g.connect("v", "online_softmax", acc_kv)
        g.connect("online_softmax", "o", acc_o)
        return g, est

    group = h // hkv
    head = Affine.of("hi") if group == 1 else \
        Affine.table("hi", [i // group for i in range(h)])
    dom_q = Domain.of(("bi", 0, b), ("hi", 0, h), ("qi", 0, nq),
                      ("ji", 0, nj), ("r", 0, bq))
    acc_q = AccessPattern(dom_q, (Affine.of("bi"), Affine.of("hi"),
                                  _blk("qi", bq, nq) + Affine.of("r"),
                                  Affine.constant(0)), width=d)
    dom_kv = Domain.of(("bi", 0, b), ("hi", 0, h), ("qi", 0, nq),
                       ("ji", 0, nj), ("r", 0, bkv))
    acc_kv = AccessPattern(dom_kv, (Affine.of("bi"), head,
                                    _blk("ji", bkv, nj) + Affine.of("r"),
                                    Affine.constant(0)), width=d)
    dom_o = Domain.of(("bi", 0, b), ("hi", 0, h), ("qi", 0, nq),
                      ("r", 0, bq))
    acc_o = AccessPattern(dom_o, (Affine.of("bi"), Affine.of("hi"),
                                  _blk("qi", bq, nq) + Affine.of("r"),
                                  Affine.constant(0)), width=d)
    acc_ml = AccessPattern(dom_o, (Affine.of("bi"), Affine.of("hi"),
                                   _blk("qi", bq, nq) + Affine.of("r")),
                           width=1)

    def step_fn(carry, q_blk, k_blk, v_blk, idx=None):
        xp = _xp(q_blk)
        m_run, l_run, acc = carry
        q2 = _f32(q_blk.reshape(q_blk.shape[-2], q_blk.shape[-1]))
        k2 = _f32(k_blk.reshape(k_blk.shape[-2], k_blk.shape[-1]))
        v2 = _f32(v_blk.reshape(v_blk.shape[-2], v_blk.shape[-1]))
        sc = (q2 * scale) @ k2.T                            # (bq', bkv)
        if causal:
            q_pos = idx["outer"][2] * bq + idx["pump"] * q2.shape[0] \
                + _arange(q2.shape[0], q2)[:, None]
            k_pos = idx["step"] * bkv + _arange(k2.shape[0], k2)[None, :]
            sc = xp.where(q_pos >= k_pos, sc, NEG_INF)
        m_new = xp.maximum(m_run, xp.amax(sc, axis=-1, keepdims=True))
        alpha = xp.exp(m_run - m_new)
        prob = xp.exp(sc - m_new)
        l_new = l_run * alpha + prob.sum(axis=-1, keepdims=True)
        acc_new = acc * alpha + prob @ v2
        return (m_new, l_new, acc_new), None

    def final_fn(carry):
        xp = _xp(carry[0])
        m_run, l_run, acc = carry
        l_safe = xp.where(l_run == 0.0, 1.0, l_run)
        o_blk = acc / l_safe
        return {"out0": o_blk[None, None],            # (1, 1, bq', d)
                "out1": m_run[None, None, :, 0],      # (1, 1, bq')
                "out2": l_run[None, None, :, 0]}

    # tile_op / tile_args: the hopper tier binds this carry region to
    # ops.flash_attention (compiler/hopper_backend.py::_flash_form)
    g.compute(
        "online_softmax", dom, vector_width=vector_width,
        tile_op="flash_attention",
        tile_args=dict(causal=bool(causal), scale=float(scale)),
        carry=CarrySpec(
            axis="ji",
            state=(((bq, 1), "float32", NEG_INF), ((bq, 1), "float32"),
                   ((bq, d), "float32")),
            step_fn=step_fn, final_fn=final_fn, pass_idx=True),
        axes=dict(ins=({2: "q", 3: "d"}, {2: "kv", 3: "d"}, {2: "kv", 3: "d"}),
                  outs=({2: "q", 3: "d"}, {2: "q"}, {2: "q"}),
                  carry=({0: "q"}, {0: "q"}, {0: "q", 1: "d"}),
                  narrow="q"))
    g.connect("q", "online_softmax", acc_q)
    g.connect("k", "online_softmax", acc_kv)
    g.connect("v", "online_softmax", acc_kv)
    g.connect("online_softmax", "o", acc_o)
    g.connect("online_softmax", "m", acc_ml)
    g.connect("online_softmax", "l", acc_ml)
    return g, est


def _ssd_graph(b: int, l: int, h: int, p: int, n: int, chunk: int = 64,
               itemsize: int = 2, n_groups: Optional[int] = None,
               dtype: str = "float32", vector_width: Optional[int] = None,
               final_state: bool = False):
    """Mamba-2 SSD chunked scan as an executable carry graph.

    The inter-chunk state recurrence is the sequential-carry axis (``ci``);
    each step consumes one chunk of (x, dt, B, C), emits one chunk of y, and
    threads the (n, p) state.  Group→head folding (B/C shared by ``h/g``
    heads) is a group-indexed table on the head symbol.

    ``final_state=True`` adds a second output memory ``state`` (b, h, n, p)
    carrying the post-sweep carry state — ``y`` stays a per-step output while
    ``state`` is emitted once per sweep through ``CarrySpec.final_fn``
    (``step_outs=1``).  This is what lets cached SSM prefill route through
    the compiler: decode needs the final inter-chunk state, which the
    plain scan graph never surfaced.
    """
    grp = n_groups or h
    g = Graph("ssd_scan")
    g.memory("x", (b, l, h, p), dtype=dtype)
    g.memory("dt", (b, l, h), dtype=dtype)
    g.memory("a", (h,), dtype=dtype)
    g.memory("bmat", (b, l, grp, n), dtype=dtype)
    g.memory("cmat", (b, l, grp, n), dtype=dtype)
    g.memory("y", (b, l, h, p), dtype=dtype)
    if final_state:
        g.memory("state", (b, h, n, p))
    chunk = min(chunk, l)
    if vector_width is None:
        vector_width = chunk * p // 128 or 1
    est = KernelEstimate(block_bytes_in=chunk * (p + 1 + 2 * n) * itemsize,
                         block_bytes_out=chunk * p * itemsize,
                         flops_per_block=2.0 * chunk * chunk * (n + p))

    nc = l // chunk
    dom = Domain.of(("bi", 0, b), ("hi", 0, h), ("ci", 0, max(nc, 1)))
    if l % chunk or h % grp:
        acc = AccessPattern(dom, (Affine.of("bi"), Affine.of("ci", chunk),
                                  Affine.of("hi"), Affine.constant(0)),
                            width=1)
        g.compute("chunk_update", dom, vector_width=vector_width)
        g.connect("x", "chunk_update", acc)
        g.connect("chunk_update", "y", acc)
        return g, est

    hpg = h // grp
    gexpr = Affine.of("hi") if hpg == 1 else \
        Affine.table("hi", [i // hpg for i in range(h)])
    dom_r = Domain.of(("bi", 0, b), ("hi", 0, h), ("ci", 0, nc),
                      ("r", 0, chunk))
    row = _blk("ci", chunk, nc) + Affine.of("r")
    acc_x = AccessPattern(dom_r, (Affine.of("bi"), row, Affine.of("hi"),
                                  Affine.constant(0)), width=p)
    acc_dt = AccessPattern(dom_r, (Affine.of("bi"), row, Affine.of("hi")),
                           width=1)
    acc_a = AccessPattern(dom, (Affine.of("hi"),), width=1)
    acc_bc = AccessPattern(dom_r, (Affine.of("bi"), row, gexpr,
                                   Affine.constant(0)), width=n)

    def step_fn(carry, x_blk, dt_blk, a_blk, b_blk, c_blk):
        xp = _xp(x_blk)
        (state,) = carry                                   # (n, p')
        xc = _f32(x_blk.reshape(x_blk.shape[1], x_blk.shape[-1]))
        dtc = _f32(dt_blk.reshape(-1))                     # (c,)
        a_dec = _f32(a_blk.reshape(-1)[0])
        bc_ = _f32(b_blk.reshape(b_blk.shape[1], b_blk.shape[-1]))
        cc_ = _f32(c_blk.reshape(c_blk.shape[1], c_blk.shape[-1]))
        logp = xp.cumsum(a_dec * dtc, axis=0)              # (c,) running decay
        y_carry = xp.exp(logp)[:, None] * (cc_ @ state)    # (c, p')
        cb = cc_ @ bc_.T                                   # (c, c)
        ratio = logp[:, None] - logp[None, :]
        t_idx = _arange(dtc.shape[0], dtc)
        mask = t_idx[:, None] >= t_idx[None, :]
        gmat = xp.where(mask,
                        cb * xp.exp(xp.where(mask, ratio, 0.0))
                        * dtc[None, :], 0.0)
        y = y_carry + gmat @ xc
        w = xp.exp(logp[-1] - logp) * dtc                  # (c,)
        state = state * xp.exp(logp[-1]) + (bc_ * w[:, None]).T @ xc
        return (state,), {"out0": y[None, :, None, :]}     # (1, c, 1, p')

    final_fn = None
    out_axes = ({3: "p"},)
    if final_state:
        # surface the post-sweep carry state as a real graph output
        # (out1 — absolute edge position, after the per-step y)
        final_fn = lambda carry: {"out1": carry[0][None, None]}  # noqa: E731
        out_axes = ({3: "p"}, {3: "p"})
    # tile_op / tile_args: the hopper tier binds this carry region to
    # ops.ssd_scan (compiler/hopper_backend.py::_ssd_scan_form)
    g.compute(
        "chunk_update", dom, vector_width=vector_width,
        tile_op="ssd_scan", tile_args=dict(chunk=chunk),
        carry=CarrySpec(axis="ci", state=(((n, p), "float32"),),
                        step_fn=step_fn, final_fn=final_fn,
                        step_outs=1 if final_state else 0),
        axes=dict(ins=({3: "p"}, {}, {}, {}, {}),
                  outs=out_axes,
                  carry=({1: "p"},),
                  narrow="p"))
    g.connect("x", "chunk_update", acc_x)
    g.connect("dt", "chunk_update", acc_dt)
    g.connect("a", "chunk_update", acc_a)
    g.connect("bmat", "chunk_update", acc_bc)
    g.connect("cmat", "chunk_update", acc_bc)
    g.connect("chunk_update", "y", acc_x)
    if final_state:
        dom_s = Domain.of(("bi", 0, b), ("hi", 0, h))
        acc_s = AccessPattern(dom_s, (Affine.of("bi"), Affine.of("hi"),
                                      Affine.constant(0), Affine.constant(0)),
                              width=n * p)
        g.connect("chunk_update", "state", acc_s)
    return g, est


def _decode_attention_graph(b: int, h: int, t: int, d: int, bkv: int = 128,
                            itemsize: int = 4, hkv: Optional[int] = None,
                            scale: Optional[float] = None,
                            dtype: str = "float32",
                            vector_width: Optional[int] = None):
    """Incremental (S=1) attention against a preallocated KV cache.

    One query row per (batch, head) runs the online-softmax recurrence over
    KV tiles — the same sequential-carry axis (``ji``) as prefill flash
    attention, but with the causal mask replaced by a *position-offset*
    validity mask: an int32 ``pos`` input (one per batch row) marks the last
    written cache slot, and each step masks keys symbolically via
    ``k_pos <= pos`` (k_pos derived from the carry step index — no
    materialized boolean, so a bucketed cache length costs only the mask
    compare).  GQA head folding is the same group-indexed table as prefill.
    """
    hkv = hkv or h
    g = Graph("decode_attention")
    g.memory("q", (b, h, d), dtype=dtype)
    g.memory("k", (b, hkv, t, d), dtype=dtype)
    g.memory("v", (b, hkv, t, d), dtype=dtype)
    g.memory("pos", (b,), dtype="int32")
    g.memory("o", (b, h, d), dtype=dtype)
    bkv = min(bkv, t)
    if scale is None:
        scale = d ** -0.5
    if vector_width is None:
        vector_width = d // 128 or 1
    est = KernelEstimate(block_bytes_in=2 * bkv * d * itemsize,
                         block_bytes_out=0.0,
                         flops_per_block=4.0 * bkv * d)

    nj = t // bkv
    dom = Domain.of(("bi", 0, b), ("hi", 0, h), ("ji", 0, max(nj, 1)))
    if t % bkv or h % hkv:
        # corner-sampled transaction schedule: planning/legality only
        acc_kv = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                     Affine.of("ji", bkv),
                                     Affine.constant(0)), width=1)
        acc_o = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                    Affine.constant(0)), width=1)
        g.compute("decode_softmax", dom, vector_width=vector_width)
        g.connect("q", "decode_softmax", acc_o)
        g.connect("k", "decode_softmax", acc_kv)
        g.connect("v", "decode_softmax", acc_kv)
        g.connect("decode_softmax", "o", acc_o)
        return g, est

    group = h // hkv
    head = Affine.of("hi") if group == 1 else \
        Affine.table("hi", [i // group for i in range(h)])
    acc_q = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                Affine.constant(0)), width=d)
    dom_kv = Domain.of(("bi", 0, b), ("hi", 0, h), ("ji", 0, nj),
                       ("r", 0, bkv))
    acc_kv = AccessPattern(dom_kv, (Affine.of("bi"), head,
                                    _blk("ji", bkv, nj) + Affine.of("r"),
                                    Affine.constant(0)), width=d)
    acc_pos = AccessPattern(dom, (Affine.of("bi"),), width=1)
    dom_o = Domain.of(("bi", 0, b), ("hi", 0, h))
    acc_o = AccessPattern(dom_o, (Affine.of("bi"), Affine.of("hi"),
                                  Affine.constant(0)), width=d)

    def step_fn(carry, q_blk, k_blk, v_blk, pos_blk, idx=None):
        xp = _xp(q_blk)
        m_run, l_run, acc = carry
        q2 = _f32(q_blk.reshape(1, q_blk.shape[-1]))
        k2 = _f32(k_blk.reshape(k_blk.shape[-2], k_blk.shape[-1]))
        v2 = _f32(v_blk.reshape(v_blk.shape[-2], v_blk.shape[-1]))
        sc = (q2 * scale) @ k2.T                           # (1, bkv)
        k_pos = idx["step"] * bkv + _arange(k2.shape[0], k2)[None, :]
        sc = xp.where(k_pos <= pos_blk.reshape(-1)[0], sc, NEG_INF)
        m_new = xp.maximum(m_run, xp.amax(sc, axis=-1, keepdims=True))
        alpha = xp.exp(m_run - m_new)
        prob = xp.exp(sc - m_new)
        l_new = l_run * alpha + prob.sum(axis=-1, keepdims=True)
        acc_new = acc * alpha + prob @ v2
        return (m_new, l_new, acc_new), None

    def final_fn(carry):
        xp = _xp(carry[0])
        m_run, l_run, acc = carry
        l_safe = xp.where(l_run == 0.0, 1.0, l_run)
        return {"out0": (acc / l_safe)[None]}              # (1, 1, d')

    # tile_op / tile_args: the hopper tier binds this carry region to
    # ops.decode_attention (compiler/hopper_backend.py::_decode_form)
    g.compute(
        "decode_softmax", dom, vector_width=vector_width,
        tile_op="decode_attention", tile_args=dict(scale=float(scale)),
        carry=CarrySpec(
            axis="ji",
            state=(((1, 1), "float32", NEG_INF), ((1, 1), "float32"),
                   ((1, d), "float32")),
            step_fn=step_fn, final_fn=final_fn, pass_idx=True),
        # the query row and the scores span the full head dim (it is the
        # softmax contraction), so mode R narrows only the value path:
        # v / accumulator / output walk d in M sub-tiles
        axes=dict(ins=({}, {}, {3: "d"}, {}),
                  outs=({2: "d"},),
                  carry=({}, {}, {1: "d"}),
                  narrow="d"))
    g.connect("q", "decode_softmax", acc_q)
    g.connect("k", "decode_softmax", acc_kv)
    g.connect("v", "decode_softmax", acc_kv)
    g.connect("pos", "decode_softmax", acc_pos)
    g.connect("decode_softmax", "o", acc_o)
    return g, est


def _ssd_decode_graph(b: int, h: int, p: int, n: int, itemsize: int = 4,
                      n_groups: Optional[int] = None, dtype: str = "float32",
                      vector_width: Optional[int] = None):
    """Single-token SSD recurrent step: one state update per (batch, head).

    ``state' = state · exp(A·dt) + (B·dt) ⊗ x`` and ``y = C · state'`` — a
    pure per-(bi, hi) map with *two* outputs (the token's y and the new
    state), expressed as a multi-output tile compute so the fused-region
    backend emits it as one blocked kernel.  Group→head folding of B/C is
    the group-indexed table shared with the chunked scan.
    """
    grp = n_groups or h
    g = Graph("ssd_decode")
    g.memory("state", (b, h, n, p))                       # fp32 carried state
    g.memory("x", (b, h, p), dtype=dtype)
    g.memory("dt", (b, h), dtype=dtype)
    g.memory("a", (h,), dtype=dtype)
    g.memory("bmat", (b, grp, n), dtype=dtype)
    g.memory("cmat", (b, grp, n), dtype=dtype)
    g.memory("y", (b, h, p), dtype=dtype)
    g.memory("state_out", (b, h, n, p))
    if vector_width is None:
        vector_width = n * p // 128 or 1
    est = KernelEstimate(block_bytes_in=(n * p + p + 2 * n) * itemsize,
                         block_bytes_out=(n * p + p) * itemsize,
                         flops_per_block=4.0 * n * p)
    if h % grp:
        dom = Domain.of(("bi", 0, b), ("hi", 0, h))
        acc = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                  Affine.constant(0)), width=1)
        g.compute("state_step", dom, vector_width=vector_width)
        g.connect("x", "state_step", acc)
        g.connect("state_step", "y", acc)
        return g, est

    hpg = h // grp
    gexpr = Affine.of("hi") if hpg == 1 else \
        Affine.table("hi", [i // hpg for i in range(h)])
    dom = Domain.of(("bi", 0, b), ("hi", 0, h))
    acc_state = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                    Affine.constant(0), Affine.constant(0)),
                              width=n * p)
    acc_x = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi"),
                                Affine.constant(0)), width=p)
    acc_dt = AccessPattern(dom, (Affine.of("bi"), Affine.of("hi")), width=1)
    acc_a = AccessPattern(dom, (Affine.of("hi"),), width=1)
    acc_bc = AccessPattern(dom, (Affine.of("bi"), gexpr,
                                 Affine.constant(0)), width=n)

    def tile_fn(in0, in1, in2, in3, in4, in5):
        xp = _xp(in1)
        st = _f32(in0.reshape(in0.shape[-2], in0.shape[-1]))        # (n, p')
        xv = _f32(in1.reshape(-1))                                  # (p',)
        dtv = _f32(in2.reshape(-1)[0])
        av = _f32(in3.reshape(-1)[0])
        bv = _f32(in4.reshape(-1))                                  # (n,)
        cv = _f32(in5.reshape(-1))
        st2 = st * xp.exp(av * dtv) + (bv * dtv)[:, None] * xv[None, :]
        yv = cv @ st2                                               # (p',)
        return {"out0": yv[None, None, :], "out1": st2[None, None]}

    def fn(in0, in1, in2, in3, in4, in5):
        xp = _xp(in1)
        st = _f32(in0.reshape(b, h, n, p))
        xv = _f32(in1.reshape(b, h, p))
        dtv = _f32(in2.reshape(b, h))
        av = _f32(in3.reshape(b, h))
        bv = _f32(in4.reshape(b, h, n))           # head-expanded by the FIFO
        cv = _f32(in5.reshape(b, h, n))
        decay = xp.exp(av * dtv)                                    # (b, h)
        st2 = st * decay[..., None, None] \
            + (bv * dtv[..., None])[..., :, None] * xv[..., None, :]
        yv = (cv[..., :, None] * st2).sum(axis=-2)                  # (b, h, p)
        return {"out0": yv.reshape(-1), "out1": st2.reshape(-1)}

    g.compute("state_step", dom, fn=fn, tile_fn=tile_fn,
              vector_width=vector_width, tile_op="ssd_state_step",
              axes=dict(ins=({3: "p"}, {2: "p"}, {}, {}, {}, {}),
                        outs=({2: "p"}, {3: "p"}), carry=(), narrow="p"))
    g.connect("state", "state_step", acc_state)
    g.connect("x", "state_step", acc_x)
    g.connect("dt", "state_step", acc_dt)
    g.connect("a", "state_step", acc_a)
    g.connect("bmat", "state_step", acc_bc)
    g.connect("cmat", "state_step", acc_bc)
    g.connect("state_step", "y", acc_x)
    g.connect("state_step", "state_out", acc_state)
    return g, est


def _grouped_gemm_graph(e: int, c: int, d: int, f: int, bc: int = 128,
                        bf: int = 128, bd: int = 128, itemsize: int = 2,
                        group_sizes: Optional[Sequence[int]] = None,
                        dtype: str = "float32",
                        vector_width: Optional[int] = None):
    """Grouped (per-expert) GEMM as an executable IR graph.

    Dense form (``group_sizes=None``): ``o[e] = x[e] @ w[e]`` with the
    expert axis as the outermost grid symbol — a derivable BlockSpec per
    operand, the contraction accumulated over the ``ki`` reduction symbol.

    Ragged form: ``x`` is a row-major concatenation of per-expert row
    groups (``sum(group_sizes)`` rows).  The iteration flattens to a *tile
    list*: group-indexed tables map each row-tile id to its expert slab and
    its row offset (the megablocks idiom) — still a derivable BlockSpec,
    via table-affine index maps.  Each group size must divide the row
    block ``bc``.
    """
    bc, bf, bd = min(bc, c), min(bf, f), min(bd, d)
    if vector_width is None:
        vector_width = bc * bf // (128 * 128) or 1
    est = KernelEstimate(block_bytes_in=(bc * bd + bd * bf) * itemsize,
                         block_bytes_out=0.0,
                         flops_per_block=2.0 * bc * bf * bd,
                         panel_bytes=dot_panel_bytes(bc, bf, bd, itemsize))
    nbf, nbd = f // bf, d // bd

    if group_sizes is not None:
        sizes = [int(sz) for sz in group_sizes]
        if len(sizes) != e:
            raise ValueError(f"{len(sizes)} group sizes for {e} experts")
        rows = sum(sizes)
        g = Graph("grouped_gemm")
        g.memory("x", (rows, d), dtype=dtype)
        g.memory("w", (e, d, f), dtype=dtype)
        g.memory("o", (rows, f), dtype=dtype)
        if any(sz % bc for sz in sizes) or f % bf or d % bd:
            dom = Domain.of(("ti", 0, max(rows // bc, 1)))
            acc = AccessPattern(dom, (Affine.of("ti", bc),
                                      Affine.constant(0)), width=1)
            g.compute("expert_tile", dom, vector_width=vector_width)
            g.connect("x", "expert_tile", acc)
            g.connect("expert_tile", "o", acc)
            return g, est
        experts, row_starts = [], []
        for ei, sz in enumerate(sizes):
            for r0 in range(0, sz, bc):
                experts.append(ei)
                row_starts.append(sum(sizes[:ei]) + r0)
        nt = len(experts)
        row0 = Affine.table("ti", row_starts)
        dom_x = Domain.of(("ti", 0, nt), ("ji", 0, nbf), ("ki", 0, nbd),
                          ("r", 0, bc))
        acc_x = AccessPattern(dom_x, (row0 + Affine.of("r"),
                                      _blk("ki", bd, nbd)), width=bd)
        dom_w = Domain.of(("ti", 0, nt), ("ji", 0, nbf), ("ki", 0, nbd),
                          ("r", 0, bd))
        acc_w = AccessPattern(dom_w, (Affine.table("ti", experts),
                                      _blk("ki", bd, nbd) + Affine.of("r"),
                                      _blk("ji", bf, nbf)), width=bf)
        dom_o = Domain.of(("ti", 0, nt), ("ji", 0, nbf), ("r", 0, bc))
        acc_o = AccessPattern(dom_o, (row0 + Affine.of("r"),
                                      _blk("ji", bf, nbf)), width=bf)

        def fn(in0, in1):
            x_ = in0.reshape(nt, nbf, nbd, bc, bd)
            w_ = in1.reshape(nt, nbf, nbd, bd, bf)
            return {"out0": (x_ @ w_).sum(axis=2).reshape(-1)}

        tile_fn = lambda in0, in1: {"out0": in0 @ in1[0]}   # noqa: E731
        g.compute("expert_tile", Domain.of(("ti", 0, nt), ("ji", 0, nbf),
                                           ("ki", 0, nbd)),
                  fn=fn, tile_fn=tile_fn, reduce="add", tile_op="dot",
                  vector_width=vector_width,
                  axes=dict(ins=({0: "c", 1: "k"}, {1: "k", 2: "f"}),
                            outs=({0: "c", 1: "f"},), carry=(), narrow="f"))
        g.connect("x", "expert_tile", acc_x)
        g.connect("w", "expert_tile", acc_w)
        g.connect("expert_tile", "o", acc_o)
        return g, est

    g = Graph("grouped_gemm")
    g.memory("x", (e, c, d), dtype=dtype)
    g.memory("w", (e, d, f), dtype=dtype)
    g.memory("o", (e, c, f), dtype=dtype)
    nbc = c // bc
    dom = Domain.of(("ei", 0, e), ("ii", 0, max(nbc, 1)),
                    ("ji", 0, max(nbf, 1)), ("ki", 0, max(nbd, 1)))
    if c % bc or f % bf or d % bd:
        acc_x = AccessPattern(dom, (Affine.of("ei"), Affine.of("ii", bc),
                                    Affine.of("ki", bd)))
        acc_w = AccessPattern(dom, (Affine.of("ei"), Affine.of("ki", bd),
                                    Affine.of("ji", bf)))
        acc_o = AccessPattern(dom, (Affine.of("ei"), Affine.of("ii", bc),
                                    Affine.of("ji", bf)))
        g.compute("expert_tile", dom, vector_width=vector_width)
        g.connect("x", "expert_tile", acc_x)
        g.connect("w", "expert_tile", acc_w)
        g.connect("expert_tile", "o", acc_o)
        return g, est

    dom_x = Domain.of(("ei", 0, e), ("ii", 0, nbc), ("ji", 0, nbf),
                      ("ki", 0, nbd), ("r", 0, bc))
    acc_x = AccessPattern(dom_x, (Affine.of("ei"),
                                  _blk("ii", bc, nbc) + Affine.of("r"),
                                  _blk("ki", bd, nbd)), width=bd)
    dom_w = Domain.of(("ei", 0, e), ("ii", 0, nbc), ("ji", 0, nbf),
                      ("ki", 0, nbd), ("r", 0, bd))
    acc_w = AccessPattern(dom_w, (Affine.of("ei"),
                                  _blk("ki", bd, nbd) + Affine.of("r"),
                                  _blk("ji", bf, nbf)), width=bf)
    dom_o = Domain.of(("ei", 0, e), ("ii", 0, nbc), ("ji", 0, nbf),
                      ("r", 0, bc))
    acc_o = AccessPattern(dom_o, (Affine.of("ei"),
                                  _blk("ii", bc, nbc) + Affine.of("r"),
                                  _blk("ji", bf, nbf)), width=bf)

    def fn(in0, in1):
        x_ = in0.reshape(e, nbc, nbf, nbd, bc, bd)
        w_ = in1.reshape(e, nbc, nbf, nbd, bd, bf)
        return {"out0": (x_ @ w_).sum(axis=3).reshape(-1)}

    tile_fn = lambda in0, in1: {"out0": in0 @ in1}   # noqa: E731
    g.compute("expert_tile", dom, fn=fn, tile_fn=tile_fn, reduce="add",
              tile_op="dot", vector_width=vector_width,
              axes=dict(ins=({1: "c", 2: "k"}, {1: "k", 2: "f"}),
                        outs=({1: "c", 2: "f"},), carry=(), narrow="f"))
    g.connect("x", "expert_tile", acc_x)
    g.connect("w", "expert_tile", acc_w)
    g.connect("expert_tile", "o", acc_o)
    return g, est


BUILDERS: Dict[str, Callable] = {
    "grouped_gemm": _grouped_gemm_graph,
    "vecadd": _vecadd_graph,
    "matmul": _matmul_graph,
    "stencil": _stencil_graph,
    "floyd_warshall": _floyd_graph,
    "flash_attention": _flash_graph,
    "ssd_scan": _ssd_graph,
    "decode_attention": _decode_attention_graph,
    "ssd_decode": _ssd_decode_graph,
}


def autopump(kernel: str, *args, mode: str = "T", max_factor: int = 16,
             smem_budget: int = SMEM_BYTES, cache=None,
             backend: str = "none", autotune=None, device=None,
             **kwargs) -> AutopumpResult:
    """Run the full §3 pipeline for a registered kernel.

    1. build the dataflow IR; 2. drive the ``repro_torch.compiler`` pass
    pipeline (streaming → stream-fusion → multipump with the capacity-model
    factor → FIFO sizing).  Falls back to M=1 (untransformed) when the
    legality checks reject.  Pipeline decisions are memoized in the
    persistent compile cache (``cache=False`` disables).

    ``backend`` defaults to ``'none'`` (plan only); pass ``'hopper'`` or
    ``'torch'`` to also lower the transformed graph (the executable lands in
    ``AutopumpResult.kernel``), and ``autotune='measure'`` to pick the pump
    factor from runtimes measured on ``device`` (default the card).
    """
    if kernel not in BUILDERS:
        raise KeyError(f"no IR builder for kernel {kernel!r}; "
                       f"known: {sorted(BUILDERS)}")
    g, est = BUILDERS[kernel](*args, **kwargs)

    # imported lazily: repro_torch.compiler depends on core's submodules
    from repro_torch import compiler

    kern = compiler.compile(g, factor="auto", mode=mode,
                            smem_budget=smem_budget, max_factor=max_factor,
                            estimate=est, backend=backend, cache=cache,
                            autotune=autotune, device=device)
    report = kern.report
    srec = report.record("streaming")
    prec = report.record("multipump")
    from .streaming import StreamingReport
    s_report = srec.report if srec is not None and srec.report is not None \
        else StreamingReport()
    p_report = prec.report if prec is not None and prec.applied else None
    return AutopumpResult(kern.spec, kern.graph, s_report, p_report, est,
                          pipeline_report=report,
                          kernel=kern if backend != "none" else None)
