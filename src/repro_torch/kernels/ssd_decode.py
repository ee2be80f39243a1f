"""SSD decode step on Hopper: the wrapper of ``csrc/ssd_decode.cu``.

Replaces the multi-output map kernel the reference emits over
``repro.core.autopump._ssd_decode_graph``.  The state is fp32 in and out
(a new tensor: the step is out of place, as in the reference); x, dt, B
and C go in through their strides, each in its own dtype (fp32 or bf16).
y comes out fp32 (ROADMAP.md queue 3).  ``pump`` realizes the region
plan's temporal axis without changing a value: mode R at M > 1 makes one
block walk P in M narrowed sub-tiles, mode T at M > 1 makes one block walk
M consecutive heads.  ``launches`` counts the kernel's launches; nothing
else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ..core.ir import PumpSpec
from . import _build
from ._build import DtypeError, InputError, KernelError

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                 # a block; P / 4 must divide it

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd_decode").ssd_decode_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 11 + [p, p]
        fn.restype = i
        _fn = fn
    return _fn


def ssd_decode_cuda(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
                    pump: Union[PumpSpec, int, Tuple[int, str]] = 1):
    """state (B, H, N, P) fp32 contiguous; x (B, H, P); dt (B, H)
    post-softplus; A (H,) fp32; B / C (B, G, N).  Returns (y fp32
    (B, H, P), state' fp32 (B, H, N, P)).  ``pump``: a factor (mode T), a
    ``PumpSpec`` or ``(factor, mode)``."""
    global launches
    spec = PumpSpec.of(pump)
    factor, mode = spec.factor, spec.mode
    for name, t, dim in (("state", state, 4), ("x", x, 3), ("dt", dt, 2),
                         ("A", A, 1), ("B", B, 3), ("C", C, 3)):
        if t.dim() != dim:
            raise InputError(f"ssd_decode: {name} must be {dim}-D, got "
                             f"{tuple(t.shape)}")
        if not t.is_cuda:
            raise InputError(f"ssd_decode: {name} is not a CUDA tensor")
        if t.dtype not in DTYPES:
            raise DtypeError(f"ssd_decode: {name} dtype {t.dtype} not "
                             f"supported")
    b, h, n, p = state.shape
    g = B.shape[1]
    if x.shape != (b, h, p) or dt.shape != (b, h) or A.shape != (h,) \
            or B.shape != (b, g, n) or C.shape != B.shape:
        raise InputError(f"ssd_decode: shapes state {tuple(state.shape)}, x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not match")
    if state.dtype != torch.float32 or A.dtype != torch.float32:
        raise DtypeError("ssd_decode: state and A must be float32")
    if not state.is_contiguous() or state.data_ptr() % 16 \
            or not A.is_contiguous():
        raise InputError("ssd_decode: state must be contiguous and 16-byte "
                         "aligned, A contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise InputError(f"ssd_decode: {name} needs a contiguous last "
                             f"dim, got strides {t.stride()}")
    if len({state.device, x.device, dt.device, A.device, B.device,
            C.device}) != 1:
        raise InputError("ssd_decode: inputs are on different devices")
    if g == 0 or h % g or n == 0 or p == 0 or p > 4 * THREADS:
        raise InputError(f"ssd_decode: unsupported shape H={h} G={g} N={n} "
                         f"P={p} (P at most {4 * THREADS})")
    sub = factor if mode == "R" else 1
    heads = factor if mode == "T" else 1
    if factor < 1 or mode not in ("T", "R") or p % sub or h % heads:
        raise InputError(f"ssd_decode: pump M={factor} mode {mode} does not "
                         f"divide P={p} (mode R) or H={h} (mode T)")
    y = torch.empty((b, h, p), dtype=torch.float32, device=x.device)
    out = torch.empty_like(state)
    if b == 0:
        return y, out
    strides = (ctypes.c_longlong * 8)(*x.stride()[:2], *dt.stride(),
                                      *B.stride()[:2], *C.stride()[:2])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(state.data_ptr(), x.data_ptr(), dt.data_ptr(),
                        A.data_ptr(), B.data_ptr(), C.data_ptr(),
                        y.data_ptr(), out.data_ptr(), DTYPES[x.dtype],
                        DTYPES[dt.dtype], DTYPES[B.dtype], DTYPES[C.dtype],
                        b, h, g, n, p, sub, heads, strides, stream)
    if err:
        raise KernelError(f"ssd_decode kernel launch failed: CUDA error "
                          f"{err}")
    launches += 1
    return y, out
