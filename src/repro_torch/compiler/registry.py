"""Process-level plan registry: shape-bucketed measured execution plans,
the port of ``repro.compiler.registry``.

The compile cache (:mod:`.cache`) makes a *repeat* compile O(1), but every
serving shape would still be a graph of its own and a cold
``autotune='measure'`` search.  The registry closes that gap:

* **Shape bucketing** — batch and sequence dims round up to a ladder of
  buckets (powers of two above a floor), so the serving shapes collapse
  onto a handful of plans: a growing decode context touches O(log T).
* **Measured plans** — every bucket compiles through
  ``compiler.compile(autotune='measure', backend='hopper')``: the pump
  factor M is chosen from measured runtimes, persisted in the compile
  cache, and replayed (no re-measurement) by every later process.
* **Warm lookup** — an in-process ``{call signature → plan}`` map serves
  steady-state calls with one dict lookup; :meth:`PlanRegistry.warmup`
  pre-measures the whole bucket grid at launch so the first real request
  is already a hit.

``models/*`` route their kernel hot paths here when
``ModelConfig.kernel_plan == 'measure'``; ``'direct'`` (the port's
default) keeps the ``kernels.ops`` calls at pump 1.

How a plan runs, and where this departs from the reference:

* **A plan is keyed on its bucket and run at the call's own shape.**  The
  plan's graph is the builder's at the bucket, and on the card its carry
  region (flash, decode attention, the SSD scan) or state-step map (the
  SSD decode step) is the direct kernel at the pump the region was
  emitted with (``hopper_backend.CARRY_FORMS``; ``launch_spec``).  So the
  wrappers launch ``kernels.ops.*`` at that spec on the unpadded tensors:
  the kernels mask ragged edges themselves, padding changes no value
  (padded keys are masked, padded steps carry dt = 0, padded rows are
  cut), and at the served shapes (B 8, S = L = 512) the bucket is the
  shape anyway.  Decode
  attention in particular is given the whole cache and ``pos``, never a
  slice padded up to the bucket: the reference copies about twice the
  cache per layer and step there, while the kernel reads only slots
  ``0..pos``.  The ragged grouped GEMM runs its compiled graph (the region
  kernel), as in the reference, but only where the plan was compiled by
  the ``hopper`` backend and every region of its graph was emitted at the
  ``hopper`` tier: a ``torch``-rung plan or a lower tier (``blockloop``,
  ``gather``) would run plain PyTorch, so such a plan is refused and the
  call falls back, counted, to ``csrc/grouped_gemm.cu``.
* **A tensor ``pos`` is the traced position**: it keys one plan on the
  full cache length and is never read on the host.
* **A cold miss while a CUDA graph is being captured never measures**: it
  takes the capacity-model plan, memoized per key (the reference's
  in-trace branch).
* **Ragged plans run unpumped by default** (``ragged_pump=1``; the
  reference's default is ``'auto'``): a fresh routing is a new plan key,
  so it is never measured, and on the card the capacity model's pick for
  deepseek-v2-lite's prefill (T8) runs the region kernel several times
  slower than T1.
* **Plans stay inside each kernel's built set**: the largest mode-T factor
  the kernel is built for at the call's head dim, dtype and head group
  (decode: the cache's dtype) caps the search, and ``compile`` counts a
  candidate that drops a region below the ``hopper`` tier as failed.
* **No fallback hides the kernel**: a plan that cannot be made or run
  falls back to the direct op at pump 1 (on a CUDA tensor, the same
  hand-written kernel; on a CPU tensor, its plain version), counted in
  ``stats.fallbacks``.  Where that raises too, the call raises.

Robustness, as in the reference: plans compile through
``compiler.compile_degraded`` (hopper, then the per-node PyTorch lowering,
each step down counted as ``degrade.compile``); a plan that fails its spot
check is purged from the compile memo, quarantined and recompiled once
(``registry.spotcheck_failed``), and a second failure refuses it (the call
falls back as above).  The spot check runs the compiled graph itself
(where ``emission.exec`` wraps it), not the direct op.  On a CPU tensor
a plan degraded to the ``torch`` rung runs as the direct op (the plain
version) at its pump.  On a CUDA tensor the direct op is the
hand-written kernel, and only a ``hopper`` plan's spot check ran it: a
plan of any other rung (the recompile of a plan that failed its spot
check among them) is refused, once for the process, and its calls fall
back as above.  Plans installed while fault rules are active get the
``registry.exec`` seam around the call their wrapper really makes (the
direct op at ``launch_spec``; the compiled graph for the ragged route);
a plan installed before a rule is never wrapped.  A warm hit makes no
``obs`` call: hits count in ``RegistryStats``, which the active default
registry publishes as the ``plan_registry`` snapshot view; misses,
fallbacks and each plan's compile (``registry.compile`` span;
``registry.measure`` / ``registry.replay`` / ``registry.plan_compile``)
count through ``obs``.  :meth:`PlanRegistry.preload_artifact` installs
a tuner fleet's verified plans (:mod:`repro_torch.tune`) before warmup.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import device as device_mod
from .. import obs
from ..testing import faults
from .cache import resolve as resolve_cache


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def _fit_block(block: int, n: int) -> int:
    """Largest block size ≤ ``block`` that divides ``n`` (n ≥ 1)."""
    cand = min(block, n)
    if n % cand:
        cand = math.gcd(n, cand)
    return max(cand, 1)


def _capturing() -> bool:
    """True while the current CUDA stream is capturing a graph (a CPU-only
    build of torch cannot capture)."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:
        return False


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """How call shapes are rounded up to plan buckets.

    ``seq_min`` / ``batch_min`` floor the respective ladders; buckets are
    the powers of two above the floor, so a growing decode context touches
    O(log T) plans instead of O(T).  ``row_block`` is the ragged
    grouped-GEMM row tile: each expert's token group pads to a power-of-two
    multiple of it (0 stays 0 — empty experts contribute no tiles).
    """
    seq_min: int = 16
    batch_min: int = 1
    row_block: int = 16

    def bucket_seq(self, n: int, multiple: int = 1) -> int:
        b = max(self.seq_min, _next_pow2(max(n, 1)))
        if multiple > 1 and b % multiple:
            b = -(-b // multiple) * multiple
        return b

    def bucket_batch(self, n: int) -> int:
        return max(self.batch_min, _next_pow2(max(n, 1)))

    def bucket_pos(self, pos) -> int:
        """Decode pos bucket: the seq bucket covering slots ``0..pos``.
        A per-slot sequence of positions buckets on its furthest row.  A
        tensor is refused: the registry never reads a position on the
        host (its decode wrapper keys a tensor pos on the full cache)."""
        if isinstance(pos, torch.Tensor):
            raise TypeError("bucket_pos: a tensor position is not read on "
                            "the host; key it on the full cache length")
        if not isinstance(pos, int):
            import numpy as np
            pos = int(np.max(np.asarray(pos)))
        return self.bucket_seq(pos + 1)

    def bucket_group(self, n: int) -> int:
        """Ragged group-size bucket: 0, or a pow2 multiple of row_block."""
        if n <= 0:
            return 0
        tiles = -(-n // self.row_block)
        return self.row_block * _next_pow2(tiles)

    def seq_grid(self, max_len: int, multiple: int = 1) -> List[int]:
        """All seq buckets from the floor up to ``bucket_seq(max_len)``."""
        top = self.bucket_seq(max_len, multiple)
        out, b = [], self.bucket_seq(1, multiple)
        while b < top:
            out.append(b)
            b = self.bucket_seq(b + 1, multiple)
        out.append(top)
        return out


# the S == 1 serving path: plans of these kernels count under the "decode"
# phase, everything else (prefill, forward) under "prefill"
DECODE_KERNELS = frozenset({"decode_attention", "ssd_decode"})


def _phase_of(kernel: str) -> str:
    return "decode" if kernel in DECODE_KERNELS else "prefill"


@dataclasses.dataclass
class RegistryStats:
    """Hit / miss / fallback accounting, split by serving phase.  Misses
    and fallbacks also count through ``obs`` (``registry.{phase}.miss``,
    ``registry.fallback.{phase}``); hits do not, so a warm call stays one
    dict lookup (the ``plan_registry`` view publishes them)."""
    hits: int = 0
    misses: int = 0
    measure_s: float = 0.0    # cold measured-autotune compiles
    compile_s: float = 0.0    # replayed / non-measured compiles
    fallbacks: int = 0        # calls that fell back to the direct op
    phase: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {
            "prefill": {"hits": 0, "misses": 0, "fallbacks": 0},
            "decode": {"hits": 0, "misses": 0, "fallbacks": 0}})

    def count(self, kernel: str, hit: bool) -> None:
        bucket = self.phase[_phase_of(kernel)]
        if hit:
            self.hits += 1
            bucket["hits"] += 1
        else:
            self.misses += 1
            bucket["misses"] += 1
            obs.count(f"registry.{_phase_of(kernel)}.miss", kernel=kernel)

    def fallback(self, kernel: str, why: str = "") -> None:
        ph = _phase_of(kernel)
        self.fallbacks += 1
        self.phase[ph]["fallbacks"] += 1
        obs.count(f"registry.fallback.{ph}", kernel=kernel, why=why)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate, 4),
                "measure_s": round(self.measure_s, 4),
                "compile_s": round(self.compile_s, 4),
                "fallbacks": self.fallbacks,
                "prefill": dict(self.phase["prefill"]),
                "decode": dict(self.phase["decode"])}


def _label(spec) -> str:
    """A pump spec as the kernel tables write it: T1, T2, R4 ..."""
    return f"{'T' if spec.factor == 1 else spec.mode}{spec.factor}"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def _max_factor(kernel: str, args: Tuple, kwargs: Dict[str, Any],
                kv_dtype: Optional[str] = None) -> int:
    """The largest mode-T pump the kernel is built for at this request (the
    cap of its plan search).  ``kv_dtype`` is decode attention's cache
    dtype, where it is not q's."""
    from ..kernels import decode_attention as da
    from ..kernels import flash_attention as fa
    from ..kernels import ssd_scan as ss
    from ..kernels.ops import _max_built
    dt = getattr(torch, kwargs.get("dtype", "float32"), None)
    if kernel == "flash_attention":
        return _max_built(lambda f: fa.built(f, "T", args[4], dt))
    if kernel == "decode_attention":
        kv = getattr(torch, kv_dtype) if kv_dtype else dt
        group = args[1] // max(kwargs.get("hkv") or args[1], 1)
        return _max_built(lambda f: da.built(f, "T", group, args[3], kv))
    if kernel == "ssd_scan":
        return _max_built(lambda f: ss.built(f, "T"))
    if kernel == "ssd_decode":
        return _max_built(lambda f: args[1] % f == 0)
    return 16


class PlanRegistry:
    """Shape-bucketed front for ``compiler.compile`` on the serving path.

    ``pump`` is ``'measure'`` (measured-runtime autotune, the default),
    ``'auto'`` (capacity model) or an int factor; ``ragged_pump`` the same
    for the ragged grouped GEMM, whose plans are keyed on routing-dependent
    group sizes and so default to 1 (never measured on the hot path; the
    module docstring says why not ``'auto'``).  ``cache`` is a :class:`~repro_torch.compiler.cache.CompileCache`,
    ``None`` for the default persistent cache or ``False`` for none.
    ``spot_check`` runs each new plan once on probe inputs: ``'finite'``
    rejects non-finite output, ``'diff'`` also holds it to the port's numpy
    executor (small shapes only).  Plans compile for the ``hopper``
    backend, whose regions run the hand-written kernels.
    """

    def __init__(self, policy: Optional[BucketPolicy] = None, *,
                 pump="measure", ragged_pump=1, cache=None,
                 spot_check: str = "finite"):
        if spot_check not in ("finite", "diff"):
            raise ValueError(f"unknown spot_check {spot_check!r}")
        self.policy = policy or BucketPolicy()
        self.pump = pump
        self.ragged_pump = ragged_pump
        self._cache = cache
        self.spot_check = spot_check
        self._plans: Dict[Tuple, Any] = {}
        # call signature -> the installed plan's PumpSpec: a warm call is
        # this one dict lookup (no bucket math, no key building)
        self._lookup: Dict[Tuple, Any] = {}
        # capacity-model plans served to cold misses during graph capture
        self._capture_memo: Dict[Tuple, Any] = {}
        # ids of the plans installed while fault rules were active: their
        # wrapper calls go through the ``registry.exec`` seam
        self._seamed: set = set()
        # plan key -> why the plan is refused on the card (``_runs_kernel``):
        # its calls fall back without compiling it again
        self._refused: Dict[Tuple, str] = {}
        self.stats = RegistryStats()

    # ------------------------------------------------------------- lookup --
    def _request(self, pump) -> Tuple[Any, str, Optional[str]]:
        if pump == "measure":
            return "auto", "T", "measure"
        if pump == "auto":
            return "auto", "T", None
        return int(pump), "T", None

    def kernel(self, kernel: str, builder_args: Tuple,
               builder_kwargs: Dict[str, Any], pump=None, *, device=None,
               max_factor: Optional[int] = None):
        """Compiled kernel for one canonical (bucketed) request on
        ``device`` (default the card) — the only place the registry talks
        to the compiler.  ``pump`` overrides the registry-wide policy (the
        ragged path uses it); ``max_factor`` defaults to the largest
        factor the kernel is built for at this request."""
        from .. import compiler
        from ..core.autopump import BUILDERS
        pump = self.pump if pump is None else pump
        dev = device if isinstance(device, torch.device) \
            else device_mod.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            # one key for 'cuda' and the tensors' 'cuda:<n>'
            dev = torch.device("cuda", torch.cuda.current_device())
        if max_factor is None:
            max_factor = _max_factor(kernel, builder_args, builder_kwargs)
        key = (kernel, tuple(builder_args),
               tuple(sorted(builder_kwargs.items())), pump, str(dev),
               max_factor)
        kern = self._plans.get(key)
        if kern is not None:
            self.stats.count(kernel, hit=True)
            return kern
        if pump == "measure" and _capturing():
            # timing runs cannot happen inside a capture: serve this miss
            # from the capacity-model plan space and leave the measured
            # slot empty for warmup() or an uncaptured call to fill
            kern = self._capture_memo.get(key)
            if kern is not None:
                self.stats.count(kernel, hit=True)
                return kern
            warnings.warn(
                f"plan registry: cold miss for {kernel}{tuple(builder_args)}"
                " during CUDA graph capture — using capacity-model "
                "planning; call warmup() at launch to pre-measure this "
                "bucket", stacklevel=3)
            kern = self.kernel(kernel, builder_args, builder_kwargs,
                               pump="auto", device=dev,
                               max_factor=max_factor)
            self._capture_memo[key] = kern
            return kern
        if key in self._refused:
            raise RuntimeError(self._refused[key])
        self.stats.count(kernel, hit=False)
        factor, mode, autotune = self._request(pump)
        with obs.span("registry.compile", cat="serve", kernel=kernel,
                      args=list(builder_args), pump=str(pump)) as sp:
            g, est = BUILDERS[kernel](*builder_args, **builder_kwargs)
            t0 = time.perf_counter()

            def build():
                # hopper, then the per-node PyTorch lowering, each step
                # down counted (``degrade.compile``)
                return compiler.compile_degraded(
                    g, factor=factor, mode=mode, estimate=est,
                    backend="hopper", autotune=autotune, cache=self._cache,
                    max_factor=max_factor, device=dev)

            kern = build()
            bad = self._spot_check_reason(kern, dev)
            if bad is not None:
                # a poisoned plan (it compiles, and computes garbage): purge
                # the memo so the retry is not served the same artifact,
                # quarantine the rung that made it, recompile once
                obs.count("registry.spotcheck_failed", kernel=kernel,
                          backend=kern.backend, reason=bad)
                ckey = kern.report.cache_key
                if ckey:
                    compiler.forget(ckey)
                store = resolve_cache(self._cache)
                if store is not None and ckey:
                    store.record_failure(f"{ckey}:{kern.backend}", bad)
                kern = build()
                bad2 = self._spot_check_reason(kern, dev)
                if bad2 is not None:
                    raise RuntimeError(
                        f"plan registry: {kernel}{tuple(builder_args)} "
                        f"failed the {bad!r} spot check and its recompile "
                        f"failed {bad2!r}; the plan is not installed")
                kern.report.warn(
                    f"spot check rejected the first compile ({bad}); "
                    f"serving the recompile (backend={kern.backend})")
            if kern.backend != "hopper" and _runs_kernel(dev):
                # the wrappers would launch the hand-written kernel at this
                # plan's spec, which no spot check of this plan ran
                self._refused[key] = (
                    f"plan registry: {kernel}{tuple(builder_args)} compiled "
                    f"at backend={kern.backend}, whose spot check ran no "
                    f"kernel; refused on {dev}")
                raise RuntimeError(self._refused[key])
            dt = time.perf_counter() - t0
            tuned = kern.report.autotune
            if tuned and not tuned.get("replayed"):
                self.stats.measure_s += dt   # paid the timing runs
                obs.count("registry.measure", kernel=kernel)
            else:
                self.stats.compile_s += dt   # replayed plan / plain compile
                obs.count("registry.replay" if tuned
                          else "registry.plan_compile", kernel=kernel)
            sp.set(factor=kern.spec.factor, backend=kern.backend,
                   measured=bool(tuned and not tuned.get("replayed")))
        if faults.active():
            # chaos seam: a plan that fails or corrupts on the serving path
            # after installation (never taken without rules).  The compiled
            # graph is wrapped (the ragged route runs it); the other
            # wrappers wrap their direct op (``_spec``)
            kern = dataclasses.replace(kern, fn=faults.wrap(
                "registry.exec", kern.fn, kernel=kernel))
            self._seamed.add(id(kern))
        self._plans[key] = kern
        return kern

    def _spot_check_reason(self, kern, device: torch.device
                           ) -> Optional[str]:
        """Run a freshly compiled plan once on probe inputs; returns the
        failure (``exec:*``, ``nonfinite``, ``diff:*``) or None.  Skipped
        during graph capture, where no value can be read."""
        if _capturing():
            return None
        inputs = _probe_inputs(kern.graph, device)
        try:
            out = kern.fn(inputs)
        except Exception as e:  # noqa: BLE001 — any exec failure poisons it
            return f"exec:{type(e).__name__}"
        for name, a in out.items():
            if name not in inputs and a.is_floating_point() \
                    and not bool(torch.isfinite(a).all()):
                return "nonfinite"
        if self.spot_check == "diff":
            import numpy as np
            from ..core import executor
            host = {k: v.float().cpu().numpy() if v.is_floating_point()
                    else v.cpu().numpy() for k, v in inputs.items()}
            want = executor.run(kern.graph, dict(host))
            for name, a in out.items():
                if name in inputs or name not in want:
                    continue
                got = a.double().cpu().numpy()
                ref = np.asarray(want[name], np.float64)
                if got.shape == ref.shape and \
                        not np.allclose(got, ref, rtol=1e-2, atol=1e-3):
                    return f"diff:{name}"
        return None

    def plans(self) -> List[Dict[str, Any]]:
        """Summaries of every resident plan (the report surface)."""
        out = []
        for (kernel, args, _kw, pump, dev, _mf), kern in self._plans.items():
            tuned = kern.report.autotune or {}
            out.append({
                "kernel": kernel, "args": list(args),
                "factor": kern.spec.factor, "mode": kern.spec.mode,
                "launch": _label(launch_spec(kern)),
                "pump": pump, "device": dev,
                "measured": tuned.get("policy") == "measure",
                "replayed": bool(tuned.get("replayed")),
                "served_from": kern.report.served_from,
            })
        return out

    def reset(self) -> None:
        self._plans.clear()
        self._lookup.clear()
        self._capture_memo.clear()
        self._seamed.clear()
        self._refused.clear()
        self.stats = RegistryStats()

    # ----------------------------------------------------------- requests --
    # Canonical (builder_args, builder_kwargs, padded dims) per kernel, the
    # reference's own: wrappers and warmup() share them, so a warmed bucket
    # is a hit for the real call.
    def flash_request(self, *, b: int, h: int, hkv: int, s: int, t: int,
                      d: int, causal: bool, dtype: str, bq: int = 128,
                      bkv: int = 128):
        bb = self.policy.bucket_batch(b)
        sb = self.policy.bucket_seq(s)
        bq_e = _fit_block(bq, sb)
        # keys pad only under causality (padded keys sit past every query)
        tb = self.policy.bucket_seq(t) if causal else t
        bkv_e = _fit_block(bkv, tb)
        args = (bb, h, sb, tb, d)
        kwargs = dict(bq=bq_e, bkv=bkv_e, hkv=hkv, causal=causal,
                      dtype=dtype, itemsize=_itemsize(dtype))
        return args, kwargs, (bb, sb, tb)

    def ssd_request(self, *, b: int, l: int, h: int, p: int, n: int,
                    chunk: int, n_groups: int, dtype: str,
                    final_state: bool = False):
        bb = self.policy.bucket_batch(b)
        lb = self.policy.bucket_seq(l)
        chunk_e = _fit_block(chunk, lb)
        args = (bb, lb, h, p, n)
        kwargs = dict(chunk=chunk_e, n_groups=n_groups, dtype=dtype,
                      itemsize=_itemsize(dtype),
                      final_state=bool(final_state))
        return args, kwargs, (bb, lb)

    def decode_request(self, *, b: int, h: int, hkv: int, t: int, d: int,
                       dtype: str, bkv: int = 128):
        """S == 1 decode attention bucket: ``t`` is the attended cache
        prefix (pos + 1 for a host position, the full cache length for a
        tensor one), on the same pow2 ladder as prefill lengths."""
        bb = self.policy.bucket_batch(b)
        tb = self.policy.bucket_seq(t)
        bkv_e = _fit_block(bkv, tb)
        args = (bb, h, tb, d)
        kwargs = dict(bkv=bkv_e, hkv=hkv, dtype=dtype,
                      itemsize=_itemsize(dtype))
        return args, kwargs, (bb, tb)

    def ssd_decode_request(self, *, b: int, h: int, p: int, n: int,
                           n_groups: int, dtype: str):
        bb = self.policy.bucket_batch(b)
        args = (bb, h, p, n)
        kwargs = dict(n_groups=n_groups, dtype=dtype,
                      itemsize=_itemsize(dtype))
        return args, kwargs, (bb,)

    def grouped_request(self, *, e: int, d: int, f: int,
                        group_sizes: Sequence[int], dtype: str,
                        bf: int = 128, bd: int = 128):
        from ..kernels.ops import ragged_request_args
        bc = self.policy.row_block
        padded = tuple(self.policy.bucket_group(int(sz))
                       for sz in group_sizes)
        bd_e, bf_e = _fit_block(bd, d), _fit_block(bf, f)
        args, kwargs = ragged_request_args(e, d, f, padded, bc, bf_e, bd_e,
                                           dtype, _itemsize(dtype))
        return args, kwargs, padded

    # ------------------------------------------------------------ wrappers --
    def _fallback(self, kernel: str, err: Exception,
                  direct: Callable[[], Any]):
        """The one fallback rung: the direct op at pump 1 (the kernel on a
        CUDA tensor, the plain version on a CPU one), counted."""
        self.stats.fallback(kernel, why=type(err).__name__)
        warnings.warn(f"plan registry: {kernel} fell back to the direct op "
                      f"at pump 1 ({err})", stacklevel=3)
        return direct()

    def _spec(self, lk: Tuple, kernel: str, request: Callable[[], Tuple],
              device: torch.device, op: Callable,
              kv_dtype: Optional[str] = None):
        """``(spec, run)`` for call signature ``lk``: the plan's PumpSpec
        and the call to make at it, ``op`` (or ``op`` behind the
        ``registry.exec`` seam, for a plan installed under fault rules).
        One dict lookup when warm, else the bucketed request through
        :meth:`kernel`."""
        hit = self._lookup.get(lk)
        if hit is not None:
            self.stats.count(kernel, hit=True)
            return hit
        args, kwargs, _pads = request()
        kern = self.kernel(kernel, args, kwargs, device=device,
                           max_factor=_max_factor(kernel, args, kwargs,
                                                  kv_dtype))
        run = faults.wrap("registry.exec", op, kernel=kernel) \
            if id(kern) in self._seamed else op
        hit = (launch_spec(kern), run)
        if not _capturing():
            # a capture-time plan is the capacity model's: never freeze it
            # into the fast path ahead of the measured one
            self._lookup[lk] = hit
        return hit

    def flash_attention(self, q, k, v, *, causal: bool = False,
                        bq: int = 128, bkv: int = 128):
        """Bucketed flash attention.  q (B, H, S, D); k / v (B, Hkv, T, D)."""
        from ..kernels import ops
        b, h, s, d = q.shape
        hkv, t = k.shape[1], k.shape[2]
        lk = ("flash_attention", b, h, hkv, s, t, d, causal, q.dtype,
              q.device, bq, bkv)
        try:
            spec, run = self._spec(
                lk, "flash_attention", lambda: self.flash_request(
                    b=b, h=h, hkv=hkv, s=s, t=t, d=d, causal=causal,
                    dtype=_dtype_name(q.dtype), bq=bq, bkv=bkv), q.device,
                ops.flash_attention)
            return run(q, k, v, causal=causal, pump=spec)
        except Exception as e:  # noqa: BLE001 — serving must not die
            return self._fallback("flash_attention", e,
                                  lambda: ops.flash_attention(
                                      q, k, v, causal=causal))

    def ssd_scan(self, x, dt, A, B, C, *, chunk: int = 16,
                 final_state: bool = False):
        """Bucketed SSD scan.  x (B, L, H, P); returns y, or (y, fp32 (B, H,
        N, P) final state) with ``final_state=True``.  Runs at the plan's
        chunk (the configured one fitted to the length bucket)."""
        from ..kernels import ops
        b, l, h, p = x.shape
        grp, n = B.shape[2], B.shape[3]
        lk = ("ssd_scan", b, l, h, p, n, grp, chunk, final_state, x.dtype,
              x.device)
        try:
            spec, run = self._spec(lk, "ssd_scan", lambda: self.ssd_request(
                b=b, l=l, h=h, p=p, n=n, chunk=chunk, n_groups=grp,
                dtype=_dtype_name(x.dtype), final_state=final_state),
                x.device, ops.ssd_scan)
            chunk_e = _fit_block(chunk, self.policy.bucket_seq(l))
            return run(x, dt, A, B, C, chunk=chunk_e,
                       final_state=final_state, pump=spec)
        except Exception as e:  # noqa: BLE001
            return self._fallback("ssd_scan", e, lambda: ops.ssd_scan(
                x, dt, A, B, C, chunk=chunk, final_state=final_state))

    def decode_attention(self, q, k_cache, v_cache, pos, *, bkv: int = 128):
        """Kernelized S == 1 decode: one query row against the preallocated
        cache.  q (B, H, D); caches (B, Hkv, T, D); ``pos`` the last valid
        slot (a Python int, a per-row sequence, or a tensor).  A host
        position keys the plan on the bucket of ``pos + 1`` (at most the
        cache length), a tensor one on the full cache length; either way
        the kernel gets the whole cache and ``pos`` and reads slots
        ``0..pos`` only (no slice, no padding: module docstring)."""
        from ..kernels import ops
        b, h, d = q.shape
        hkv, t = k_cache.shape[1], k_cache.shape[2]
        try:
            if isinstance(pos, torch.Tensor):
                t_req = t
            elif isinstance(pos, int):
                t_req = min(self.policy.bucket_seq(pos + 1), t)
            else:
                # per-row host positions: bucket on the furthest row
                t_req = min(self.policy.bucket_pos(pos), t)
                pos = torch.as_tensor(pos, dtype=torch.int32,
                                      device=q.device)
            lk = ("decode_attention", b, h, hkv, t_req, d, q.dtype,
                  k_cache.dtype, q.device, bkv)
            spec, run = self._spec(lk, "decode_attention",
                                   lambda: self.decode_request(
                                       b=b, h=h, hkv=hkv, t=t_req, d=d,
                                       dtype=_dtype_name(q.dtype), bkv=bkv),
                                   q.device, ops.decode_attention,
                                   _dtype_name(k_cache.dtype))
            return run(q, k_cache, v_cache, pos, pump=spec)
        except Exception as e:  # noqa: BLE001 — serving must not die
            return self._fallback("decode_attention", e,
                                  lambda: ops.decode_attention(
                                      q, k_cache, v_cache, pos))

    def ssd_decode(self, state, x, dt, A, B, C):
        """Kernelized single-token SSD step.  state (B, H, N, P) fp32; x
        (B, H, P); dt (B, H) (post-softplus); A (H,); B / C (B, G, N).
        Returns (y, new_state)."""
        from ..kernels import ops
        b, h, n, p = state.shape
        grp = B.shape[1]
        lk = ("ssd_decode", b, h, p, n, grp, x.dtype, x.device)
        try:
            spec, run = self._spec(lk, "ssd_decode",
                                   lambda: self.ssd_decode_request(
                                       b=b, h=h, p=p, n=n, n_groups=grp,
                                       dtype=_dtype_name(x.dtype)), x.device,
                                   ops.ssd_decode)
            return run(state, x, dt, A, B, C, pump=spec)
        except Exception as e:  # noqa: BLE001
            return self._fallback("ssd_decode", e, lambda: ops.ssd_decode(
                state, x, dt, A, B, C))

    def grouped_gemm(self, x, w, *, group_sizes: Sequence[int],
                     bf: int = 128, bd: int = 128):
        """Bucketed ragged grouped GEMM.  x (sum(group_sizes), D) rows
        grouped by expert; w (E, D, F).  Empty groups emit no tiles.  Runs
        the compiled plan (the region kernel on the card) under
        ``ragged_pump``; a plan with a region below the ``hopper`` tier is
        refused (``_hopper_plan``), so the call falls back to the direct
        op."""
        from ..kernels import ops
        sizes = [int(sz) for sz in group_sizes]
        e, d, f = w.shape
        try:
            args, kwargs, padded = self.grouped_request(
                e=e, d=d, f=f, group_sizes=sizes,
                dtype=_dtype_name(x.dtype), bf=bf, bd=bd)
            return ops.ragged_grouped_gemm_compiled(
                x, w, sizes, padded, kwargs["bc"], kwargs["bf"],
                kwargs["bd"], kernel_fn=lambda a, kw: _hopper_plan(
                    self.kernel("grouped_gemm", a, kw, pump=self.ragged_pump,
                                device=x.device)))
        except Exception as err:  # noqa: BLE001 — serving must not die
            return self._fallback("grouped_gemm", err,
                                  lambda: ops.grouped_gemm(
                                      x, w, group_sizes=sizes, bc=16))

    # ----------------------------------------------------------- artifact --
    def preload_artifact(self, path, *, device=None) -> Dict[str, Any]:
        """Warm-start from a published plan artifact (:mod:`repro_torch.
        tune`): verify each manifest entry, install the verified plans into
        this registry's backing store in one locked write, and let the
        :meth:`warmup` that follows replay them, with zero autotune
        measurements on the replica.  ``device`` (default the card) is
        where this replica serves: an entry timed on another kind of
        device is ``stale``.

        Degrades per entry, never whole-artifact: a ``corrupt`` (hash
        mismatch), ``stale`` (another toolchain or device), ``missing``
        (no manifest row) or ``invalid`` entry is rejected
        (``artifact.rejected``) and recorded in the store's quarantine
        ledger under ``<key>:artifact``, a suffix ``compiler.compile``
        never gates on, so the local re-measure proceeds and only the
        artifact's provenance is marked bad.  An unreadable or
        wrong-schema artifact degrades to an empty preload (a full local
        warmup), counted ``artifact.load_failed``."""
        from ..tune import artifact as artifact_mod
        report: Dict[str, Any] = {"path": str(path), "total": 0,
                                  "verified": 0, "rejected": 0,
                                  "missing": 0, "reasons": {}}
        try:
            doc = artifact_mod.load(path)
        except Exception as e:  # noqa: BLE001 — unreadable artifact: the
            # replica tunes locally, as if no artifact existed
            obs.count("artifact.load_failed", path=str(path),
                      error=type(e).__name__)
            report["error"] = repr(e)
            return report
        kind = artifact_mod.device_kind(device_mod.resolve(device))
        store = resolve_cache(self._cache)
        entries = doc["entries"]
        manifest = doc["manifest"]
        report["total"] = len(entries)
        report["missing"] = len(doc.get("missing", []))
        verified: Dict[str, dict] = {}
        for key, plan in entries.items():
            try:
                reason = artifact_mod.verify_entry(
                    key, plan, manifest.get(key), device=kind)
            except Exception as e:  # noqa: BLE001 — an injected or exotic
                # verification failure: a rejected entry
                reason = f"verify-error:{type(e).__name__}"
            if reason is None:
                verified[key] = plan
                obs.count("artifact.verified", key=key)
            else:
                report["rejected"] += 1
                report["reasons"][reason] = \
                    report["reasons"].get(reason, 0) + 1
                obs.count("artifact.rejected", key=key, reason=reason)
                if store is not None:
                    store.record_failure(f"{key}:artifact",
                                         f"artifact:{reason}")
        report["verified"] = len(verified)
        if store is not None and verified:
            store.put_many(verified)
        return report

    # ------------------------------------------------------------- warmup --
    def warmup(self, requests, *, device=None) -> List[Dict[str, Any]]:
        """Pre-measure the bucket grid on ``device`` (default the card):
        ``requests`` is an iterable of ``(kernel, shape_kwargs)``
        descriptors (``models.transformer.plan_requests``); a decode
        descriptor may carry ``kv_dtype``, its cache's dtype.  Returns one
        record per request: the chosen factor and mode, whether the plan
        was measured now or replayed from the persistent cache, the
        winner's measured µs and the wall time paid."""
        canon = {"flash_attention": self.flash_request,
                 "ssd_scan": self.ssd_request,
                 "grouped_gemm": self.grouped_request,
                 "decode_attention": self.decode_request,
                 "ssd_decode": self.ssd_decode_request}
        dev = device_mod.resolve(device)
        requests = list(requests)
        report: List[Dict[str, Any]] = []
        surfaced: List[str] = []
        with obs.span("registry.warmup", cat="serve",
                      requests=len(requests)) as wspan:
            self._warmup(requests, canon, dev, report, surfaced)
            wspan.set(failed=sum(1 for r in report if "error" in r))
        # each unique compile warning once per sweep, not once per bucket
        for msg in surfaced:
            warnings.warn(f"plan warmup: {msg}", stacklevel=2)
        return report

    def _warmup(self, requests, canon, dev, report, surfaced) -> None:
        """:meth:`warmup`'s loop: one record per request into ``report``,
        each new compile warning into ``surfaced``."""
        for kernel, spec in requests:
            t0 = time.perf_counter()
            spec = dict(spec)
            kv_dtype = spec.pop("kv_dtype", None)
            # per-request isolation: one unplannable bucket yields a
            # failure record, not an aborted grid
            try:
                args, kwargs, _pads = canon[kernel](**spec)
                pump = self.ragged_pump if kernel == "grouped_gemm" \
                    else None
                kern = self.kernel(kernel, args, kwargs, pump=pump,
                                   device=dev,
                                   max_factor=_max_factor(kernel, args,
                                                          kwargs, kv_dtype))
            except Exception as e:  # noqa: BLE001
                obs.count("registry.warmup_failed", kernel=kernel,
                          error=type(e).__name__)
                report.append({
                    "kernel": kernel, "args": list(spec.values()),
                    "factor": None, "mode": None, "launch": None,
                    "measured": False,
                    "replayed": False, "winner_us": None,
                    "time_s": round(time.perf_counter() - t0, 4),
                    "tiers": [], "error": repr(e)})
                continue
            for msg in kern.report.warnings:
                if msg not in surfaced:
                    surfaced.append(msg)
            tuned = kern.report.autotune or {}
            emission = kern.report.emission or {}
            report.append({
                "kernel": kernel, "args": list(args),
                "factor": kern.spec.factor, "mode": kern.spec.mode,
                "launch": _label(launch_spec(kern)),
                "measured": tuned.get("policy") == "measure",
                "replayed": bool(tuned.get("replayed")),
                "winner_us": tuned.get("timings_us", {}).get(
                    str(tuned.get("winner"))),
                "time_s": round(time.perf_counter() - t0, 4),
                "tiers": sorted({v["tier"] for v in emission.values()}),
            })


def _hopper_plan(kern):
    """``kern`` if the ``hopper`` backend compiled it and emitted every
    region of it at the ``hopper`` tier (the hand-written kernels); else
    raise, since a ``torch``-rung plan or a lower tier runs the regions as
    plain PyTorch."""
    emission = kern.report.emission or {}
    if kern.backend != "hopper" or not emission:
        raise RuntimeError(f"plan compiled at backend={kern.backend}, "
                           f"not emitted by the hopper backend")
    low = {r: e["tier"] for r, e in emission.items()
           if e["tier"] != "hopper"}
    if low:
        raise RuntimeError(f"plan emitted below the hopper tier: {low}")
    return kern


def _runs_kernel(device: torch.device) -> bool:
    """True where a wrapper's direct op is the hand-written kernel (a CUDA
    tensor: ``kernels.ops._route``), so that a plan serves there only if
    its spot check ran that kernel."""
    return device.type == "cuda"


def launch_spec(kern):
    """The (pump, mode) at which a plan's one region launches its kernel:
    the emitted region's own, since the pipeline may drop the temporal axis
    (a grid extent the factor does not divide) and so emit the region
    unpumped under a plan factor above 1."""
    from ..core.ir import PumpSpec
    ems = list((kern.report.emission or {}).values())
    if len(ems) == 1:
        return PumpSpec(factor=ems[0]["pump"], mode=ems[0]["mode"])
    return kern.spec


def _probe_inputs(g, device: torch.device) -> Dict[str, torch.Tensor]:
    """Small deterministic non-zero operands for the plan spot check, made
    on ``device``: a repeating pattern in [-0.75, 0.75] per external input
    memory (integer inputs — decode positions — land at 0, always a valid
    position)."""
    from ..core.ir import NodeKind
    from .lowering import torch_dtype
    out = {}
    for n in g.nodes.values():
        if n.kind != NodeKind.MEMORY or g.in_edges(n.name):
            continue
        size = max(math.prod(n.shape) if n.shape else 1, 1)
        vals = (torch.arange(size, device=device) % 7 - 3) / 4.0
        out[n.name] = vals.reshape(n.shape or ()).to(torch_dtype(n.dtype))
    return out


# --------------------------------------------------------------- singleton --
_DEFAULT: Optional[PlanRegistry] = None

# the active default registry's stats in every metrics snapshot (a view,
# not a copy: it follows whichever instance is installed)
obs.register_view(
    "plan_registry",
    lambda: _DEFAULT.stats.as_dict() if _DEFAULT is not None else None)


def default_registry() -> PlanRegistry:
    """Process-wide registry the model layers share."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PlanRegistry()
    return _DEFAULT


def set_default_registry(reg: Optional[PlanRegistry]
                         ) -> Optional[PlanRegistry]:
    """Swap the process-wide registry (tests, benchmarks); returns the
    old one."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, reg
    return old
