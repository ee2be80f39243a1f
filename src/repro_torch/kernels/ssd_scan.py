"""SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` and the carry-form
kernel the reference emits over ``_ssd_graph`` with its ``final_state``
output.  x, dt, B and C go in through their strides (the last dim of x, B
and C contiguous), so the model's strided views of the conv output are not
copied; each is read in its own dtype (fp32 or bf16).  A ragged L is
masked in the kernel.  ``built`` says which pump cases exist.  ``launches``
counts the kernel's launches; nothing else adds to it.
"""
from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from ..core.ir import PumpSpec
from . import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 64, 128, 64   # the kernel's shared memory
PUMPS = ((1, "T"), (2, "T"), (4, "T"), (2, "R"), (4, "R"))
SMEM_BYTES = 227 * 1024

launches = 0
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 11 + [p, i, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _check(name: str, t: torch.Tensor, dim: int, dtypes=DTYPES) -> None:
    if t.dim() != dim:
        raise ValueError(f"ssd_scan: {name} must be {dim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_cuda:
        raise ValueError(f"ssd_scan: {name} is not a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"ssd_scan: {name} dtype {t.dtype} not supported")


def smem_bytes(factor: int, mode: str) -> int:
    """Shared memory of a pump case (``csrc/ssd_scan.cu::smem_floats``):
    the state, the chunk's c x c matrix and decay vectors, and ``factor``
    (mode T) or one (mode R) chunks of x, B, C and dt, all fp32 at the
    kernel's largest chunk, state and head dims."""
    fixed = MAX_STATE * MAX_HEAD_DIM + MAX_CHUNK * (MAX_CHUNK + 1) \
        + 3 * MAX_CHUNK
    chunk = MAX_CHUNK * MAX_HEAD_DIM + 2 * MAX_CHUNK * (MAX_STATE + 1) \
        + MAX_CHUNK
    return 4 * (fixed + (factor if mode == "T" else 1) * chunk)


def built(factor: int, mode: str) -> bool:
    """True where the kernel is built for pump (``factor``, ``mode``): a
    listed pump whose panel fits 227 KB (T1, T2, R2 and R4; T4 does not
    fit)."""
    if factor == 1:
        mode = "T"
    return (factor, mode) in PUMPS and smem_bytes(factor, mode) <= SMEM_BYTES


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                  final_state: bool = False,
                  pump: Union[PumpSpec, int, Tuple[int, str]] = 1):
    """x (B, L, H, P); dt (B, L, H) post-softplus; A (H,) fp32; B / C
    (B, L, G, N).  Returns y (B, L, H, P) in x's dtype, and with
    ``final_state`` also the fp32 (B, H, N, P) state after the last step.
    ``pump`` (a factor, a ``PumpSpec`` or ``(factor, mode)``) changes how
    the kernel walks the chunks, never the values; a case outside
    ``built`` raises."""
    global launches
    _check("x", x, 4)
    _check("dt", dt, 3)
    _check("A", A, 1, {torch.float32: 0})
    _check("B", B, 4)
    _check("C", C, 4)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if dt.shape != (b, l, h) or A.shape != (h,) or B.shape != (b, l, g, n) \
            or C.shape != B.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} do not match")
    if len({x.device, dt.device, A.device, B.device, C.device}) != 1:
        raise ValueError("ssd_scan: inputs are on different devices")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"ssd_scan: {name} needs a contiguous last dim, "
                             f"got strides {t.stride()}")
    if not A.is_contiguous():
        raise ValueError("ssd_scan: A must be contiguous")
    if g == 0 or h % g or not 1 <= chunk <= MAX_CHUNK \
            or not 1 <= n <= MAX_STATE or not 1 <= p <= MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: unsupported shape H={h} G={g} N={n} "
                         f"P={p} chunk={chunk} (chunk <= {MAX_CHUNK}, N <= "
                         f"{MAX_STATE}, P <= {MAX_HEAD_DIM})")
    spec = PumpSpec.of(pump)
    if not built(spec.factor, spec.mode):
        raise ValueError(f"ssd_scan: no kernel for M={spec.factor} mode "
                         f"{spec.mode}; built for {PUMPS} where the panel "
                         f"fits {SMEM_BYTES} B")
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
             if final_state else None)
    if b and l:
        strides = (ctypes.c_longlong * 12)(*x.stride()[:3], *dt.stride(),
                                           *B.stride()[:3], *C.stride()[:3])
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel()(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(),
                state.data_ptr() if state is not None else None,
                DTYPES[x.dtype], DTYPES[dt.dtype], DTYPES[B.dtype],
                DTYPES[C.dtype], b, l, h, g, n, p, chunk, strides,
                spec.factor, int(spec.mode == "R"), stream)
        if err:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                               f"{err}")
        launches += 1
    elif state is not None:
        state.zero_()
    return (y, state) if final_state else y
