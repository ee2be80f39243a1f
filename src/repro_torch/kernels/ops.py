"""Public kernel wrappers: the port's ``repro.kernels.ops``.

A CUDA tensor launches the hand-written kernel or raises a
``_build.KernelError`` (no build, no case for its inputs, a failed
launch); a CPU tensor takes the plain PyTorch version in ``ref``.
Nothing falls back from the card to the plain version.  The kernels have
no backward (nor does the reference define one), so on the card a wrapper
refuses, with an ``InputError`` naming its kernel, any tensor operand that
requires grad while grad mode is on (``_launch``, ``grad_refusal``): a
launch would silently cut the gradient there.  Training runs the plain
routes; a CPU tensor keeps its differentiable plain version.  The
kernels take raw pointers, so a DTensor operand on the kernel's route
raises ``InputError`` too (a step on a replicated mesh hands them its
local tensors: ``launch.steps.on_mesh``).  The launch
counts live on the kernel modules (``flash_attention.launches``,
``decode_attention.launches``, ``ssd_scan.launches``,
``ssd_decode.launches``, ``vecadd.launches``, ``matmul.launches``,
``stencil.launches``, ``floyd_warshall.launches``,
``grouped_gemm.launches``, ``region_map_reduce.launches``).

The paper's four kernels take ``pump`` as a factor or a ``PumpSpec`` and
raise the reference's ``ValueError`` for shapes the pump cannot divide, on
either device.  ``vecadd``, ``matmul``, ``grouped_gemm``,
``flash_attention``, ``decode_attention``, ``ssd_scan`` and ``ssd_decode``
also take ``pump='auto'`` (the capacity model's factor, cached by
``compiler.plan_pump``) and ``pump='measure'`` (the factor measured on the
kernel's IR graph through ``compile(backend='hopper',
autotune='measure')``, cached likewise), as the reference's ``_as_spec``
does; the chosen spec then drives the direct kernel.  The attention and
SSD ops also take ``(factor, mode)``.  The pump never changes a value: a
CPU tensor takes the plain version at any pump, a CUDA tensor the kernel
at that pump, which raises where the case is not built.  Where a kernel is
built for no pump at all (a head dim, dtype or head group it does not
take), ``'auto'`` and ``'measure'`` plan the unpumped case.

``ragged_request_args`` and ``ragged_grouped_gemm_compiled`` are the
ragged grouped GEMM through the compiler (its plan key and its execution),
the route of the plan registry's ``grouped_gemm``.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..core.ir import PumpSpec
from ..core.pump_plan import dot_panel_bytes
from . import decode_attention as _da
from . import flash_attention as _fa
from . import floyd_warshall as _fw
from . import grouped_gemm as _gg
from . import matmul as _mm
from . import ref
from . import region_map_reduce as _rmr
from . import ssd_decode as _sd
from . import ssd_scan as _ss
from . import stencil as _st
from . import vecadd as _va
from ._build import InputError


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def _route(x: torch.Tensor, name: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise InputError(f"{name}: unsupported device {x.device}")


def grad_refusal(name: str, tensors: Sequence) -> Optional[str]:
    """Why ``name``'s kernel cannot take ``tensors`` under autograd: the
    message when grad mode is on and a tensor among them requires grad,
    else None."""
    if not torch.is_grad_enabled():
        return None
    which = [i for i, t in enumerate(tensors)
             if isinstance(t, torch.Tensor) and t.requires_grad]
    if not which:
        return None
    return (f"{name}: operand(s) {which} require grad, and the CUDA kernel "
            f"has no backward; train on the plain route (attention_impl="
            f"'xla_chunked', ssm_impl='xla', the MoE capacity route) or "
            f"call it under torch.no_grad()")


def _launch(name: str, *tensors) -> bool:
    """``_route`` on the first tensor: True for the kernel, False for the
    plain version.  On the kernel's route, a DTensor operand (whose
    pointer is not its data's) or a tensor that requires grad under grad
    mode (``grad_refusal``) raises ``InputError``."""
    if not _route(tensors[0], name):
        return False
    which = [i for i, t in enumerate(tensors) if isinstance(t, DTensor)]
    if which:
        raise InputError(f"{name}: operand(s) {which} are DTensors; the "
                         f"CUDA kernel takes plain tensors (a step on a "
                         f"replicated mesh passes the local ones)")
    why = grad_refusal(name, tensors)
    if why is not None:
        raise InputError(why)
    return True


Pump = Union[PumpSpec, int, Tuple[int, str], str]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _max_built(built) -> int:
    """The largest mode-T factor a kernel is built for (``built(f)``), or 1
    where it is built for none (a head dim, dtype or head group it does not
    take): the plan is then the unpumped one, which a CPU tensor runs as
    the plain version and a CUDA tensor refuses with the kernel's own
    error."""
    return max((f for f in (1, 2, 4, 8, 16) if built(f)), default=1)


def _estimate_spec(pump: str, x: torch.Tensor, kernel: str, builder_args,
                   builder_kwargs, max_factor: int) -> PumpSpec:
    """``_as_spec`` planned from the builder's own estimate (the
    reference's compile(factor='auto', estimate=est) of the kernel)."""
    from ..core.autopump import BUILDERS
    _g, est = BUILDERS[kernel](*builder_args, **builder_kwargs)
    return _as_spec(pump, x, kernel=kernel, builder_args=builder_args,
                    builder_kwargs=builder_kwargs, max_factor=max_factor,
                    block_bytes_in=est.block_bytes_in,
                    block_bytes_out=est.block_bytes_out,
                    flops_per_block=est.flops_per_block,
                    panel_bytes=est.panel_bytes)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    bq: int = 128, bkv: int = 128, pump: Pump = 1,
                    stats: bool = False):
    """Multi-head attention, q (B, H, S, D), k / v (B, Hkv, T, D); GQA maps
    q head h to kv head h // (H / Hkv).  Causal is top-left aligned.
    ``pump='auto'`` plans with the reference's (bq, bkv) blocks
    (``repro/kernels/ops.py:282-285``), ``'measure'`` times the
    ``_flash_graph`` carry kernel at those blocks; either is capped at the
    largest factor the kernel is built for at this head dim and dtype.
    ``stats=True`` also returns the fp32 (B, H, S) final running max m and
    denominator l, the carry graph's second and third outputs."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    isz = q.element_size()
    spec = PumpSpec.of(pump) if not isinstance(pump, str) else _as_spec(
        pump, q, kernel="flash_attention", builder_args=(b, h, s, t, d),
        builder_kwargs=dict(bq=bq, bkv=bkv, itemsize=isz, hkv=hkv,
                            causal=causal, scale=scale,
                            dtype=_dtype_name(q)),
        max_factor=_max_built(lambda f: _fa.built(f, "T", d, q.dtype)),
        block_bytes_in=2 * bkv * d * isz, block_bytes_out=0,
        flops_per_block=4.0 * bq * bkv * d)
    if _launch("flash_attention", q, k, v):
        return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale,
                                        pump=spec, stats=stats)
    return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               stats=stats)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None, bkv: int = 128,
                     pump: Pump = 1) -> torch.Tensor:
    """Single-position attention against a preallocated cache: q (B, H, D),
    caches (B, Hkv, T, D), valid slots 0..pos[b] (scalar or (B,) pos).
    ``pump='auto'`` plans from ``_decode_attention_graph``'s estimate at
    ``bkv``, ``'measure'`` times that graph's carry kernel."""
    b, h, d = q.shape
    hkv, t = k_cache.shape[1], k_cache.shape[2]
    spec = PumpSpec.of(pump) if not isinstance(pump, str) else \
        _estimate_spec(
            pump, q, "decode_attention", (b, h, t, d),
            dict(bkv=min(bkv, t), itemsize=q.element_size(), hkv=hkv,
                 scale=scale, dtype=_dtype_name(q)),
            _max_built(lambda f: _da.built(f, "T", h // max(hkv, 1), d,
                                           k_cache.dtype)))
    if _launch("decode_attention", q, k_cache, v_cache, pos):
        return _da.decode_attention_cuda(q, k_cache, v_cache, pos,
                                         scale=scale, pump=spec)
    return ref.decode_attention(q, k_cache, v_cache, pos, scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             final_state: bool = False, pump: Pump = 1):
    """Mamba-2 chunked SSD scan: x (B, L, H, P), dt (B, L, H), A (H,), B / C
    (B, L, G, N).  Returns y, or (y, fp32 (B, H, N, P) final state).
    ``pump='auto'`` plans with the reference's block bytes
    (``repro/kernels/ops.py:337-340``), ``'measure'`` times the
    ``_ssd_graph`` carry kernel; either is capped at the largest factor the
    kernel is built for."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    spec = PumpSpec.of(pump) if not isinstance(pump, str) else _as_spec(
        pump, x, kernel="ssd_scan", builder_args=(b, l, h, p, n),
        builder_kwargs=dict(chunk=chunk, itemsize=x.element_size(),
                            n_groups=g, dtype=_dtype_name(x),
                            final_state=final_state),
        max_factor=_max_built(lambda f: _ss.built(f, "T")),
        block_bytes_in=chunk * (p + 1 + 2 * n) * 4,
        block_bytes_out=chunk * p * 4,
        flops_per_block=2.0 * chunk * chunk * (n + p))
    if _launch("ssd_scan", x, dt, A, B, C):
        return _ss.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk,
                                 final_state=final_state, pump=spec)
    return ref.ssd_scan(x, dt, A, B, C, chunk=chunk, final_state=final_state)


def ssd_decode(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
               A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
               pump: Pump = 1):
    """One-token SSD step: state (B, H, N, P) fp32, x (B, H, P), dt (B, H),
    A (H,), B / C (B, G, N).  Returns (y fp32 (B, H, P), new state).
    ``pump`` (a factor, a ``PumpSpec``, ``(factor, mode)``, ``'auto'`` from
    ``_ssd_decode_graph``'s estimate or ``'measure'``) only changes how the
    kernel walks the step (mode R: P in M sub-tiles; mode T: M heads per
    block), never the values."""
    b, h, n, p = state.shape
    spec = PumpSpec.of(pump) if not isinstance(pump, str) else \
        _estimate_spec(
            pump, x, "ssd_decode", (b, h, p, n),
            dict(itemsize=x.element_size(), n_groups=B.shape[1],
                 dtype=_dtype_name(x)),
            _max_built(lambda f: h % f == 0))
    if _launch("ssd_decode", x, state, dt, A, B, C):
        return _sd.ssd_decode_cuda(state, x, dt, A, B, C, pump=spec)
    return ref.ssd_decode(state, x, dt, A, B, C)


def region_map_reduce(desc, operands: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fused-region map/reduce kernel on a ``RegionDesc`` (see
    ``kernels.region_map_reduce``): CUDA operands launch it, CPU operands
    take its plain version."""
    if _launch("region_map_reduce", *operands):
        return _rmr.region_map_reduce_cuda(desc, operands)
    return ref.region_map_reduce(desc, operands)


# ------------------------------------------------ the paper's four kernels --
def _as_spec(pump: Pump, x: Optional[torch.Tensor] = None,
             kernel: Optional[str] = None, builder_args=(),
             builder_kwargs=None, max_factor: int = 16,
             **plan_kwargs) -> PumpSpec:
    """A factor, a ``PumpSpec``, ``(factor, mode)``, or ``'auto'`` /
    ``'measure'`` planned for ``kernel`` (the reference's ``_as_spec``).
    ``max_factor`` is the largest M the direct kernel is built for."""
    if pump == "auto":
        # capacity-model planning, memoized in the persistent compile cache
        from ..compiler import plan_pump
        return plan_pump(max_factor=max_factor, **plan_kwargs)
    if pump == "measure":
        # measured-runtime planning: compile the kernel's IR graph through
        # the fused-region backend with autotune='measure' on x's device and
        # reuse the winning factor here; the measured plan persists in the
        # same compile cache, so only the first process pays the timing runs
        spec = _measured_spec(kernel, builder_args, builder_kwargs or {},
                              x.device, max_factor)
        if spec is not None:
            return spec
        from ..compiler import plan_pump
        return plan_pump(max_factor=max_factor, **plan_kwargs)
    return PumpSpec.of(pump)


def _fixed_spec(pump: Union[PumpSpec, int, str], name: str) -> PumpSpec:
    if isinstance(pump, str):
        raise TypeError(f"{name}: pump={pump!r} is not planned by the "
                        f"compiler for the stencil and Floyd-Warshall "
                        f"kernels, as in the reference; pass a factor or a "
                        f"PumpSpec")
    return PumpSpec.of(pump)


def _measured_spec(kernel, builder_args, builder_kwargs, device,
                   max_factor: int) -> Optional[PumpSpec]:
    if kernel is None:
        return None
    from .. import compiler
    from ..core.autopump import BUILDERS
    try:
        g, est = BUILDERS[kernel](*builder_args, **builder_kwargs)
        kern = compiler.compile(g, factor="auto", estimate=est,
                                backend="hopper", autotune="measure",
                                max_factor=max_factor, device=device)
    except (compiler.LoweringError, compiler.AutotuneError) as e:
        # expected for non-executable builder shapes (non-divisible blocks
        # leave fn=None, so every candidate fails to lower): fall back to
        # the capacity model, visibly
        warnings.warn(f"pump='measure' for {kernel}: graph not executable "
                      f"({e}); falling back to capacity-model planning",
                      stacklevel=3)
        return None
    return kern.spec


def vecadd(x: torch.Tensor, y: torch.Tensor, *, vector_width: int = 8,
           pump: Union[PumpSpec, int, str] = 1) -> torch.Tensor:
    """z = x + y, 1-D, with spatial width V and temporal pump M (paper
    Table 2); any length (the kernel masks the ragged tail)."""
    isz = x.element_size()
    spec = _as_spec(pump, x, kernel="vecadd", builder_args=(x.shape[0],),
                    builder_kwargs=dict(vector_width=vector_width),
                    max_factor=_pow2_floor(_va.MAX_TX_BYTES
                                           // (vector_width * isz)),
                    block_bytes_in=2 * vector_width * isz,
                    block_bytes_out=vector_width * isz,
                    flops_per_block=vector_width)
    if spec.mode == "R" and vector_width % spec.factor:
        raise ValueError(f"V={vector_width} not divisible by M={spec.factor} "
                         f"in mode R")
    if _launch("vecadd", x, y):
        return _va.vecadd_cuda(x, y, vector_width=vector_width, pump=spec)
    return ref.vecadd(x, y)


def matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 64, bn: int = 64,
           bk: int = 32, pump: Union[PumpSpec, int, str] = 1,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """a (M, K) · b (K, N) with a pump-M K stream (paper Table 3), fp32
    accumulation over the whole K, rounded once to ``out_dtype`` (default
    a's).  The default tile is one the kernel is built for (the reference's
    default is 128 x 128 x 128)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not chain")
    isz = a.element_size()
    spec = _as_spec(
        pump, a, kernel="matmul",
        builder_args=(a.shape[0], b.shape[1], a.shape[1]),
        builder_kwargs=dict(bm=bm, bn=bn, bk=bk),
        max_factor=max(f for f, _m in _mm.PUMPS),
        block_bytes_in=(bm * bk + bk * bn) * isz,
        block_bytes_out=0,  # accumulated in registers, written once per tile
        flops_per_block=2.0 * bm * bn * bk,
        panel_bytes=dot_panel_bytes(bm, bn, bk, isz))
    if spec.mode == "R" and bn % spec.factor:
        raise ValueError(f"bn={bn} not divisible by M={spec.factor} for "
                         f"mode R")
    if _launch("matmul", a, b):
        return _mm.matmul_cuda(a, b, bm=bm, bn=bn, bk=bk, pump=spec,
                               out_dtype=out_dtype)
    return ref.matmul(a, b, out_dtype=out_dtype or a.dtype)


def stencil_chain(x: torch.Tensor, stages: int, *, kind: str = "jacobi",
                  coef: float = 0.1,
                  pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """``stages`` 7-point stages (jacobi or diffusion) over a (d0, d1, d2)
    volume, M interior planes per program (paper Tables 4-5)."""
    f = _fixed_spec(pump, "stencil_chain").factor
    if (x.shape[0] - 2) % f:
        raise ValueError("interior plane count must divide the pump factor")
    if _launch("stencil_chain", x):
        return _st.stencil_chain_cuda(x, stages, kind=kind, coef=coef,
                                      pump=f)
    return ref.stencil_chain(x, stages, kind=kind, coef=coef)


def floyd_warshall(dist: torch.Tensor, *,
                   pump: Union[PumpSpec, int] = 1) -> torch.Tensor:
    """All-pairs shortest paths, M dependent pivots per slab (paper
    Table 6)."""
    f = _fixed_spec(pump, "floyd_warshall").factor
    n = dist.shape[0]
    if n % f:
        raise ValueError(f"n={n} must divide pump factor {f}")
    if _launch("floyd_warshall", dist):
        return _fw.floyd_warshall_cuda(dist, pump=f)
    return ref.floyd_warshall(dist)


# ------------------------------------------------------- the grouped GEMM --
def ragged_request_args(e, d, f, padded, bc, bf, bd, dtype, itemsize):
    """Canonical (builder_args, builder_kwargs) of one ragged grouped-GEMM
    request (the reference's ``ragged_request_args``): the single source of
    the plan key, shared by the plan registry's warmup and the execution
    path below, so a warmed plan is a hit for the real call."""
    rows_p = sum(padded)
    dp = -(-d // bd) * bd
    fp = -(-f // bf) * bf
    return ((e, rows_p, dp, fp),
            dict(bc=bc, bf=bf, bd=bd, group_sizes=tuple(padded),
                 dtype=dtype, itemsize=itemsize))


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``."""
    rem = -x.shape[axis] % mult
    if rem == 0:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, rem]
    return F.pad(x, pads)


def ragged_grouped_gemm_compiled(x: torch.Tensor, w: torch.Tensor, sizes,
                                 padded, bc: int, bf: int, bd: int, *,
                                 kernel_fn) -> torch.Tensor:
    """The ragged grouped GEMM through the compiler (the reference's
    ``ragged_grouped_gemm_compiled``, the megablocks idiom): x is the
    row-major concatenation of the groups (``sum(sizes)`` rows); each group
    is zero-padded up to ``padded[i]`` (a multiple of the row tile ``bc``,
    0 skips the expert), the ragged builder's graph is compiled at
    ``ragged_request_args`` and run (on the card the region kernel,
    ``csrc/region_map_reduce.cu``), and the real rows come back out.  A
    caller that already holds the padded layout (``sizes == padded``)
    skips the per-group segmentation.  ``kernel_fn(builder_args,
    builder_kwargs)`` returns the compiled plan: the plan registry owns the
    compile."""
    e, d, f = w.shape
    if sum(padded) == 0:
        return x.new_zeros((0, f))
    prepadded = list(sizes) == list(padded)
    if prepadded:
        xp = x
    else:
        parts, off = [], 0
        for sz, psz in zip(sizes, padded):
            seg = x[off:off + sz]
            off += sz
            if psz:
                parts.append(_pad_to(seg, 0, psz) if psz > sz else seg)
        xp = torch.cat(parts) if len(parts) > 1 else parts[0]
    xp = _pad_to(xp, 1, bd)
    wp = _pad_to(_pad_to(w, 1, bd), 2, bf)
    args, kwargs = ragged_request_args(e, d, f, padded, bc, bf, bd,
                                       _dtype_name(x), x.element_size())
    kern = kernel_fn(args, kwargs)
    out = kern({"x": xp.contiguous(), "w": wp.contiguous()})["o"][:, :f]
    if prepadded:
        return out
    outs, off = [], 0
    for sz, psz in zip(sizes, padded):
        if sz:
            outs.append(out[off:off + sz])
        off += psz
    if not outs:
        return x.new_zeros((0, f))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, *, bc: int = 16,
                 bf: int = 128, bd: int = 32,
                 pump: Union[PumpSpec, int, str] = 1,
                 group_sizes: Optional[Sequence[int]] = None,
                 tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-expert batched GEMM, the MoE hot spot, with a pump-M contraction
    stream (the reference's ``ops.grouped_gemm``).  Three forms, each summed
    over the whole D in fp32 and rounded once to x's dtype:

    - dense (no ``group_sizes``, no ``tiles``): x (E, C, D) · w (E, D, F)
      -> (E, C, F);
    - ragged, ``group_sizes`` a sequence of per-expert row counts: x is the
      (sum, D) row-major concatenation of the groups and the result keeps
      that layout;
    - ragged, ``tiles`` a table from ``grouped_gemm.tile_table`` on x's
      device with row counts of at most ``bc``: x (rows, D) in the layout
      the table describes, the result (rows, F), zero where no tile covers
      a row.  This is the form a routing made on the card uses.

    The kernel masks a ragged C, F, D or group where the reference pads
    it, so every ``bc`` serves every size.  The default tile is one the
    kernel is built for (the reference's is 128 x 128 x 128)."""
    if w.dim() != 3:
        raise ValueError(f"grouped_gemm: w must be (E, D, F), got "
                         f"{tuple(w.shape)}")
    e, d, f = w.shape
    isz = x.element_size()
    # 'measure' times the builder's graph: the ragged one at the groups
    # padded to bc (the reference's ragged_request_args), the dense one at
    # x's shape; a device tile table has no host graph, so it is planned
    # by the capacity model
    gkw = dict(bc=bc, bf=bf, bd=bd, itemsize=isz,
               dtype=str(x.dtype).replace("torch.", ""))
    kernel = "grouped_gemm"
    if group_sizes is not None:
        padded = tuple(-(-int(s_) // bc) * bc for s_ in group_sizes)
        gargs = (e, sum(padded), d, f)
        gkw["group_sizes"] = padded
    elif tiles is None and x.dim() == 3:
        gargs = (e, x.shape[1], d, f)
    else:
        gargs, kernel = (), None
    spec = _as_spec(
        pump, x, kernel=kernel, builder_args=gargs, builder_kwargs=gkw,
        max_factor=max(f_ for f_, _m in _gg.PUMPS),
        block_bytes_in=(bc * bd + bd * bf) * isz, block_bytes_out=0,
        flops_per_block=2.0 * bc * bf * bd,
        panel_bytes=dot_panel_bytes(bc, bf, bd, isz))
    if spec.mode == "R" and bf % spec.factor:
        raise ValueError(f"bf={bf} not divisible by M={spec.factor} in "
                         f"mode R")
    if group_sizes is not None:
        if tiles is not None:
            raise ValueError("grouped_gemm: pass group_sizes or tiles, not "
                             "both")
        sizes = [int(sz) for sz in group_sizes]
        if x.dim() != 2 or x.shape[0] != sum(sizes):
            raise ValueError(f"ragged x has {x.shape[0]} rows, group_sizes "
                             f"sum to {sum(sizes)}")
        if len(sizes) != e:
            raise ValueError(f"{len(sizes)} group sizes for {e} experts")
        tiles = _gg.tile_table(torch.tensor(sizes, device=x.device), bc,
                               sum(-(-sz // bc) for sz in sizes))
    if tiles is not None:
        if x.dim() != 2 or x.shape[1] != d:
            raise ValueError(f"ragged x {tuple(x.shape)} does not chain with "
                             f"w {tuple(w.shape)}")
        if _launch("grouped_gemm", x, w, tiles):
            return _gg.grouped_gemm_cuda(x, w, tiles, bc=bc, bf=bf, bd=bd,
                                         pump=spec)
        return ref.ragged_grouped_gemm(x, w, tiles)
    if x.dim() != 3 or x.shape[0] != e or x.shape[2] != d:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if not _launch("grouped_gemm", x, w):
        return ref.grouped_gemm(x, w)
    c = x.shape[1]
    tiles = _gg.tile_table(torch.full((e,), c, device=x.device), bc,
                           e * -(-c // bc))
    out = _gg.grouped_gemm_cuda(x.reshape(e * c, d).contiguous(), w, tiles,
                                bc=bc, bf=bf, bd=bd, pump=spec)
    return out.reshape(e, c, f)
