"""SSD chunked scan on Hopper: the wrapper of ``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas`` (``pallas_call``
at :97) and the carry-form kernel the reference emits over ``_ssd_graph``
with its ``final_state`` output.  At mamba2-1.3b's prefill the bytes bound
it (86.5 MB, 0.026 ms); its products, issued as bf16 terms on the tensor
cores, take about as long (0.024 ms at 989 TFLOP/s).  x, B and C all bf16
(the serving path) take the tensor-core body: four warps per (b, h), each
keeping its 16 rows of the state in registers as mma accumulators, the
panels staged in bf16 by ``cp.async`` through a ring of two transactions,
the decay cumsum a warp scan, built with the widths constant at mamba2's
(chunk 64, N 128, P 64).  Its fp32 operands are split into bf16 terms
(``TERMS``): S and G two, x * w three (the state is held to 1e-5), C.B^T
on bf16 inputs none.  Any of x, B, C in fp32 takes the CUDA-core body
(fp32 FMAs), the port's first design.  x, dt, B and C go in through their
strides (the last dim of x, B and C contiguous), so the model's strided
views of the conv output are not copied; each is read in its own dtype.
A ragged L is masked in the kernel.  ``built`` says which pump cases
exist.  ``launches`` counts the kernel's launches; nothing else adds to it.
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
# bf16 terms each product of the tensor-core body issues: C.B^T on bf16
# inputs is exact as one; S (in y's C.S) and G (in G.x) take two, within
# about 2^-17 of the fp32 value; x * w (in the state's update) three
TERMS = {"C.B^T": 1, "C.S": 2, "G.x": 2, "state": 3}

launches = 0
_fn = None


def _lib():
    global _fn
    if _fn is None:
        lib = _build.load("ssd_scan")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_fwd.argtypes = [p] * 7 + [i] * 11 + [p, i, i, p]
        lib.ssd_scan_fwd.restype = i
        lib.ssd_scan_blocks_per_sm.argtypes = [i, i, i, ctypes.POINTER(i)]
        lib.ssd_scan_blocks_per_sm.restype = i
        _fn = lib
    return _fn


def _check(name: str, t: torch.Tensor, dim: int, dtypes=DTYPES,
           cuda: bool = True) -> None:
    if t.dim() != dim:
        raise ValueError(f"ssd_scan: {name} must be {dim}-D, got "
                         f"{tuple(t.shape)}")
    if cuda and not t.is_cuda:
        raise ValueError(f"ssd_scan: {name} is not a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"ssd_scan: {name} dtype {t.dtype} not supported")


def smem_bytes(factor: int, mode: str, tensor_cores: bool = True) -> int:
    """Shared memory of a pump case (``csrc/ssd_scan.cu``), at the
    kernel's largest chunk, state and head dims.  The tensor-core body
    (``tensor_cores::smem_bytes``): G's two bf16 terms (rows padded to 72)
    and each of 4 warps' fp32 logP, exp(logP) and w, then a ring of two
    transactions of ``factor`` (mode T) or one (mode R) chunk slots, each
    x (rows of 72 bf16), B and C (rows of 136) and dt (fp32).  The
    CUDA-core body (``cuda_cores::smem_bytes``): the fp32 state, the c x
    c matrix (rows of 65) and decay vectors, and ``factor`` (mode T) or
    one (mode R) chunks of x, B and C (rows of 129) and dt, all fp32."""
    tiles = factor if mode == "T" else 1
    if tensor_cores:
        fixed = 2 * 2 * MAX_CHUNK * (MAX_CHUNK + 8) + 4 * 3 * 4 * MAX_CHUNK
        slot = 2 * (MAX_CHUNK * (MAX_HEAD_DIM + 8)
                    + 2 * MAX_CHUNK * (MAX_STATE + 8)) + 4 * MAX_CHUNK
        return fixed + 2 * tiles * slot
    fixed = MAX_STATE * MAX_HEAD_DIM + MAX_CHUNK * (MAX_CHUNK + 1) \
        + 3 * MAX_CHUNK
    chunk = MAX_CHUNK * MAX_HEAD_DIM + 2 * MAX_CHUNK * (MAX_STATE + 1) \
        + MAX_CHUNK
    return 4 * (fixed + tiles * chunk)


def built(factor: int, mode: str) -> bool:
    """True where the kernel is built for pump (``factor``, ``mode``): a
    listed pump whose shared memory fits 227 KB in both bodies (T1, T2, R2
    and R4; T4 fits in neither)."""
    if factor == 1:
        mode = "T"
    return (factor, mode) in PUMPS and all(
        smem_bytes(factor, mode, tc) <= SMEM_BYTES for tc in (True, False))


def blocks_per_sm(factor: int, mode: str, tensor_cores: bool = True) -> int:
    """Blocks of a built pump case one SM holds at once, as the CUDA
    runtime computes it from the kernel's registers, threads and shared
    memory (needs the card): the tensor-core body as built for mamba2's
    widths, or the CUDA-core body."""
    if not built(factor, mode):
        raise ValueError(f"ssd_scan: no kernel for M={factor} mode {mode}")
    out = ctypes.c_int(0)
    err = _lib().ssd_scan_blocks_per_sm(int(tensor_cores), factor,
                                        int(mode == "R" and factor > 1),
                                        ctypes.byref(out))
    if err:
        raise RuntimeError(f"ssd_scan occupancy query failed: CUDA error "
                           f"{err}")
    return out.value


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 cuda: bool = False) -> None:
    """Raises ``ValueError`` (``TypeError`` for a dtype) on inputs the
    kernel does not take: ranks, dtypes, shapes that do not match, devices
    that differ, a last dim of x, B or C that is not contiguous, a
    non-contiguous A, G that does not divide H, chunk > 64, N > 128 or P >
    64; with ``cuda`` also on a tensor that is not on the card."""
    _check("x", x, 4, cuda=cuda)
    _check("dt", dt, 3, cuda=cuda)
    _check("A", A, 1, {torch.float32: 0}, cuda=cuda)
    _check("B", B, 4, cuda=cuda)
    _check("C", C, 4, cuda=cuda)
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
    check_inputs(x, dt, A, B, C, chunk, cuda=True)
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
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
            err = _lib().ssd_scan_fwd(
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
