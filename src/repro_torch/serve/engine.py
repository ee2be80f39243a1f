"""Serving engine: batched prefill + decode, greedy or sampled, the port
of ``repro.serve.engine``.

``Engine.generate`` is the main path: one fresh-cache prefill of the whole
prompt batch, then one decode step per new token for every row together.
The engine sets ``cfg.fresh_prefill_kernel`` as the reference does, since
its prefill always starts on a new cache; under ``attention_impl='pallas'``
the prefill runs the flash kernel and every decode step the decode kernel.
An SSM model is served the same way: under ``ssm_impl='pallas'`` the
prefill runs the SSD scan kernel and every decode step the SSD decode
kernel; ``max_len`` sizes no SSM cache.  An MoE model with MLA
(deepseek-v2-lite) is served with its compressed cache; with
``moe.ragged_dropless`` and ``inference_capacity_factor <= 0`` each MoE
layer's three expert products run the grouped-GEMM kernel, in the prefill
and in every decode step.  An enc-dec model (whisper-base) is served with
its encoder output: the caller runs ``encdec.encode`` outside the engine,
as the reference launcher does, and ``generate(..., enc_out=...)`` puts it
in every step's batch for the decoder's cross-attention.  A VLM
(internvl2-2b) is served text-only, as the dense family, as in the
reference; patches reach it only through ``model.forward``.
Steps run through ``StepTimer``, so the first call of each phase is kept
apart from steady-state time.

**Plan warmup.**  Under ``kernel_plan='measure'`` (the config's, or
``ServeConfig.kernel_plan`` overriding it) the model's kernels go through
the plan registry (``compiler.registry``), which the engine captures once
at construction and installs as the process default for the length of
each ``prefill`` and ``generate``, so its layers plan against that one
registry.  ``Engine.warmup`` (run at construction unless
``ServeConfig.warmup`` is off) plans the whole bucket grid of
``transformer.plan_requests(..., cached=True)`` on the engine's device:
a cold bucket is measured there, a bucket in the persistent compile cache
replays.  So every kernel call of ``generate`` after it is a registry hit;
its cost is ``warmup_s``, never step time.  With
``ServeConfig.plan_artifact`` (a tuner fleet's artifact,
:mod:`repro_torch.tune`) the warmup first preloads the artifact's verified
plans (``PlanRegistry.preload_artifact``, reported as ``artifact_report``
and ``stats()["artifact"]``), so every bucket it covers replays with zero
measurements.

**Sampling.**  ``temperature > 0`` draws each token with
``jax.random.categorical``'s Gumbel-max on the reference's key chain
(:mod:`.prng`, the port's threefry2x32): the first token with
``PRNGKey(seed)`` itself, every later one with the second half of a split
of the running key.  On a CUDA tensor the draw runs on the card; only the
``(B,)`` token ids reach the host, as in the greedy step.

**Continuous batching.**  ``Engine.serve_stream`` serves a stream of
requests through ``serve.scheduler``: ``max_slots`` decode lanes over one
per-slot cache (each row's ``pos`` an int32 device tensor), admission into
freed lanes, grouped fresh prefills scattered into the lanes, and one
batched decode step a scheduler step.  On a CUDA device that step replays
one CUDA graph (:mod:`.decode_graph`), captured at the second step over a
cache whose leaves the step writes in place (K/V rows; the first step runs
eagerly and plans its kernels) and keyed on the batch, the dtypes and
those leaves' shapes and data pointers.  A replay copies the tokens and
``pos`` into the graph's static inputs and returns clones of its logits
and next ``pos`` over the caller's leaves.  An MoE model replays on the
direct ragged route (its tile table built on the card) and on the
capacity route; on the ragged registry route (``kernel_plan='measure'``,
group sizes read on the host) it stays eager, as do SSM and hybrid
caches, an int ``pos`` (``generate``), a mesh and a guarded step
(``nan_guard``, fault rules).  On a CUDA device a fresh prefill of S
tokens replays one CUDA graph too (:mod:`.prefill_graph`): the engine
takes the bucket b of ``cfg.prefill_graph_bucket``, or 128 where the
configuration sets none (0), captures at construction one graph of its
batch for every multiple of b up to ``max_len`` where the captured state
takes at most 2% of the card's memory, and a prefill runs at the least of
them that holds S, the padding after the prompt, the head projecting
position S - 1 alone; a family other than dense and MoE, the MoE
registry and capacity routes, a mesh and a guarded prefill stay eager.
Off the card a configuration's 0 keeps every prefill eager.
``Engine.prefill_chunk`` is the
continuation prefill under chunked prefill and preemption resume: a
config with ``prefill_continuation=True`` and ``fresh_prefill_kernel=False``
that attends over the whole written prefix and seeds the SSM scan from the
cached state.

**Robustness**, the reference's: every prefill, continuation chunk and
decode step goes through ``_run_step``, the ``engine.{phase}`` fault seam,
and, when ``ServeConfig.nan_guard`` is on or fault rules are installed, a
host check that the step's logits are finite (a sync).  On any failure the
step re-runs on the bottom rung, ``_direct_cfg`` (``kernel_plan='direct'``,
``attention_impl='xla_chunked'``, ``ssm_impl='xla'``: plain PyTorch, no
kernel but an MoE model's grouped GEMM, which the reference leaves as it
is; made at its first use), from the caller's cache, counted as
``engine.degraded`` with the phase and reason; ``degraded_requests``
counts the requests that needed one.
The cache is written in place (K/V rows at ``[pos, pos + s)``; ``pos``, the
SSM state and the conv window come back as new tensors), so the re-run
from the caller's cache is exact: it rewrites those rows before it reads
them, and nothing else was touched.  A ``KernelError`` is re-raised,
never degraded: the kernel layer raises it where its library does not
build (``KernelBuildError``), where it has no case for a CUDA tensor's
shape, dtype or pump, or where a launch fails, and a rung of plain
PyTorch standing in for such a kernel would hide it (the reference
degrades on any exception).  A failure of the bottom rung itself raises.

**Meshes.**  ``Engine(..., mesh=)`` places the weights under the serving
rules (``launch.steps.serve_param_specs``: TP-resident, "data" stripped
but for MoE) as DTensor parameters, and every step runs through
``launch.steps.on_mesh``: on a mesh where they are all replicated (the
card's 1 x 1 host mesh) the model is served from its local tensors, so
routes, kernels and launch counts are the direct path's.  A placement
that shards a weight raises ``ValueError``: the engine's caches and
tokens are plain tensors, so a sharded mesh serves through
``make_prefill_step`` / ``make_decode_step`` on a placed cache
(``serve_shardings``).  ``mesh=None`` (the default; the reference's is
``make_host_mesh()``) makes no process group and no DTensor.

**Tracing and metrics** (:mod:`repro_torch.obs`): the spans
``serve.warmup``, ``serve.generate``, ``serve.prefill``,
``serve.prefill_chunk`` and ``serve.decode``, each step's with an
``engine.sync_wait`` child where ``StepTimer`` waits for the card; the
histograms ``serve.ttft_s`` and ``engine.warmup_s``; two samples a step,
both from the step's entry, split at the point ``StepTimer`` stamps as the
host's last enqueue: ``engine.<phase>_enqueue_s`` up to it, and the synced
wall (``serve.decode_step_s`` for decode, ``engine.prefill_s`` and
``engine.prefill_chunk_s``); ``serve.tokens``; a decode step's
``engine.decode_graph`` sample (1 a replay, 0 an eager step), the
``engine.decode_graph_capture`` counter and each eager step's
``engine.decode_graph_eager`` with its reason (``degraded`` for the
bottom rung); a fresh prefill's ``engine.prefill_graph`` sample (1 a
replay, 0 an eager prefill) and the ``engine.prefill_graph_*`` counters
of :mod:`.prefill_graph`; and the engine's ``stats()`` as the
``serve.engine`` snapshot view.  An MoE model's layers add the
``moe.experts`` span and, while a profiler records, one sample a step of
each of
``moe.<phase>_calls``, ``_rows``, ``_buffer_rows`` and ``_experts_hit``
(``models.moe.ExpertTally``), read back after the step's synchronize.
A replay ends ``engine.decode_enqueue_s`` at its return,
inside ``serve.decode`` and before ``engine.sync_wait``, and adds to each
kernel's ``launches`` what the capture launched (the capture itself leaves
them as they were), so the counters match the kernels the card ran.
With tracing off and no profiler recording, a span is one attribute and
one profiler check (``decode_token`` gives the whole cost of a decode
step).

"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
import weakref
from typing import Any, Dict, List, Optional, Union

import torch

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.kernels._build import KernelError
from repro_torch.launch.steps import StepTimer
from repro_torch.models import model as model_mod
from repro_torch.models import moe as moe_mod
from repro_torch.obs.trace import profiling
from repro_torch.testing import faults

from . import prng
from .decode_graph import DecodeGraph, count_eager
from .prefill_graph import PrefillGraph, engine_bucket

# the bottom rung of the degradation ladder: plain PyTorch attention and
# SSD, no plan registry
_DIRECT = dict(kernel_plan="direct", attention_impl="xla_chunked",
               ssm_impl="xla")


@dataclasses.dataclass
class ServeConfig:
    batch: int = 4
    max_len: int = 256
    temperature: float = 0.0      # 0 = greedy
    seed: int = 0                 # the sampler's PRNGKey(seed)
    cache_dtype: str = "float32"
    # plan the registry's bucket grid at construction (a no-op unless the
    # model routes its kernels through the registry)
    warmup: bool = True
    # overrides cfg.kernel_plan for this engine ('measure' | 'direct')
    kernel_plan: Optional[str] = None
    # a published plan artifact (repro_torch.tune): warmup verifies and
    # installs its entries first, so every bucket it covers replays with
    # zero measurements; None tunes locally at warmup
    plan_artifact: Optional[str] = None
    # host check that each step's logits are finite, degrading the step to
    # the plain route instead of emitting garbage tokens; a sync a step, so
    # opt-in (on implicitly while fault rules are installed)
    nan_guard: bool = False


class Engine:
    def __init__(self, cfg, model, scfg: ServeConfig, *,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        model_mod.check_supported(cfg)
        self.device = device_mod.resolve(device)
        if scfg.kernel_plan and scfg.kernel_plan != cfg.kernel_plan:
            cfg = dataclasses.replace(cfg, kernel_plan=scfg.kernel_plan)
        if not cfg.fresh_prefill_kernel:
            cfg = dataclasses.replace(cfg, fresh_prefill_kernel=True)
        bucket = engine_bucket(cfg, self.device)
        if bucket != cfg.prefill_graph_bucket:
            cfg = dataclasses.replace(cfg, prefill_graph_bucket=bucket)
        self.cfg, self.scfg = cfg, scfg
        # continuation prefill: s > 1 into a cache already holding tokens,
        # so attention masks over the whole written prefix (the flash
        # fresh-prefill route off) and the SSM scan seeds from the cache
        self.cont_cfg = dataclasses.replace(
            cfg, prefill_continuation=True, fresh_prefill_kernel=False)
        # the bottom rung of the degradation ladder and its continuation
        # twin, made at their first use (``_fallback``)
        self._direct_cfg = None
        self._direct_cont_cfg = None
        self.degraded_requests = 0
        self._req_degraded = False
        self.model = model.to(self.device)
        self.mesh = mesh
        if mesh is not None:
            from repro_torch.launch import sharding as shard_mod
            from repro_torch.launch import steps as steps_mod
            specs = steps_mod.serve_param_specs(cfg, self.model)
            shard_mod.place(self.model, mesh, specs)
            if not shard_mod.replicated(self.model):
                raise ValueError(
                    f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                    f"shards {cfg.name}'s weights; the engine serves a "
                    f"replicated placement (a host mesh): serve a sharded "
                    f"one through launch.steps.make_prefill_step / "
                    f"make_decode_step on a placed cache")
        self.cache_dtype = getattr(torch, scfg.cache_dtype)
        self.timer = StepTimer(self.device)
        self.ttft_s: Optional[float] = None
        self.warmup_s = 0.0
        self.warmup_report: List[Dict[str, Any]] = []
        self.artifact_report: Optional[Dict[str, Any]] = None
        # captured once: warmup(), stats() and the layers (through
        # _serving) use this registry, even if the process default is
        # swapped later
        self._reg = None
        if cfg.kernel_plan == "measure":
            from repro_torch.compiler.registry import default_registry
            self._reg = default_registry()
        # this engine's stats in every metrics snapshot (a view; the most
        # recently constructed engine owns the slot).  A weak reference:
        # the view keeps no engine, and so no weights on the card, alive
        stats = weakref.WeakMethod(self.stats)
        obs.register_view("serve.engine",
                          lambda: None if stats() is None else stats()())
        # resolved once: a step appends to its histograms directly
        reg = obs.default_metrics()
        self._step_hists = {
            phase: (reg.histogram(f"engine.{phase}_enqueue_s"),
                    reg.histogram(wall))
            for phase, wall in (("prefill", "engine.prefill_s"),
                                ("prefill_chunk", "engine.prefill_chunk_s"),
                                ("decode", "serve.decode_step_s"))}
        # the decode step, replayed as a CUDA graph where it can be
        # (serve.decode_graph), and its sample: 1 a replay, 0 eager
        self._decode = DecodeGraph(self.device, mesh, scfg.nan_guard)
        self._graph_hist = reg.histogram("engine.decode_graph")
        # the fresh prefill, replayed per length bucket as a CUDA graph
        # (serve.prefill_graph), and its sample: 1 a replay, 0 eager
        self._prefill = PrefillGraph(self.device, mesh, scfg.nan_guard)
        self._prefill_hist = reg.histogram("engine.prefill_graph")
        # an MoE model's expert tally, read back per step while profiled
        self._tally = moe_mod.TALLY if cfg.moe is not None else None
        if scfg.warmup:
            self.warmup()
            if self.device.type == "cuda":
                with self._serving():
                    self._prefill.warm(self.cfg, self.model, scfg.batch,
                                       scfg.max_len, self.cache_dtype)

    def warmup(self) -> List[Dict[str, Any]]:
        """Plan the registry's bucket grid for this model and shape: one
        request per kernel and bucket up to ``max_len``
        (``transformer.plan_requests(..., cached=True)``), measured now or
        replayed from the compile cache, after preloading
        ``ServeConfig.plan_artifact``'s verified plans into it.  The time
        goes to ``warmup_s``."""
        if self._reg is None:
            return []
        from repro_torch.models import transformer
        param = next(self.model.parameters(), None)
        dtype = torch.promote_types(
            param.dtype if param is not None else torch.float32,
            self.cfg.activation_dtype)
        t0 = time.perf_counter()
        with obs.span("serve.warmup", cat="serve", batch=self.scfg.batch,
                      max_len=self.scfg.max_len) as sp:
            if self.scfg.plan_artifact:
                # rejected or missing entries fall through to the local
                # measured path below
                self.artifact_report = self._reg.preload_artifact(
                    self.scfg.plan_artifact, device=self.device)
                sp.set(artifact_verified=self.artifact_report["verified"],
                       artifact_rejected=self.artifact_report["rejected"])
            reqs = transformer.plan_requests(
                self.cfg, self.scfg.batch, self.scfg.max_len,
                dtype=str(dtype).replace("torch.", ""), cached=True,
                cache_dtype=self.cache_dtype)
            self.warmup_report = self._reg.warmup(reqs, device=self.device)
            sp.set(plans=len(self.warmup_report),
                   failed=sum(1 for r in self.warmup_report
                              if "error" in r))
        dt = time.perf_counter() - t0
        self.warmup_s += dt
        obs.observe("engine.warmup_s", dt)
        return self.warmup_report

    @contextlib.contextmanager
    def _serving(self):
        """The engine's registry as the process default (the one the model
        layers read) for the length of the block."""
        if self._reg is None:
            yield
            return
        from repro_torch.compiler.registry import set_default_registry
        old = set_default_registry(self._reg)
        try:
            yield
        finally:
            set_default_registry(old)

    def _on_mesh(self):
        """Under a mesh, the model over its local tensors
        (``launch.steps.on_mesh``) for the length of the block."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.launch.steps import on_mesh
        return on_mesh(self.model)

    def _batch(self, tokens: torch.Tensor, enc_out=None) -> Dict:
        """A step's batch: the tokens, and an enc-dec model's encoder
        output."""
        batch = {"tokens": tokens.to(self.device)}
        if enc_out is not None:
            batch["enc_out"] = enc_out.to(self.device)
        return batch

    # ------------------------------------------------------------ serving --
    def _fallback(self, cont: bool):
        """The bottom rung's config (``_DIRECT`` over this engine's), or
        for a chunk its continuation twin, which keeps the continuation
        masking and state seeding.  Each is made at its first use,
        counted as ``engine.fallback_build``."""
        if cont:
            if self._direct_cont_cfg is None:
                obs.count("engine.fallback_build", phase="prefill_chunk")
                self._direct_cont_cfg = dataclasses.replace(
                    self.cont_cfg, **_DIRECT)
            return self._direct_cont_cfg
        if self._direct_cfg is None:
            obs.count("engine.fallback_build")
            self._direct_cfg = dataclasses.replace(self.cfg, **_DIRECT)
        return self._direct_cfg

    def _record_step(self, phase: str, t0: float) -> None:
        """The step entered at ``t0``: its enqueue, up to ``StepTimer``'s
        stamp, and its synced wall."""
        enqueue, wall = self._step_hists[phase]
        enqueue.record(self.timer.enqueued - t0)
        wall.record(time.perf_counter() - t0)

    def _nan_guarded(self) -> bool:
        return self.scfg.nan_guard or faults.active()

    def _run_step(self, phase: str, cache, batch: Dict, **kw):
        """One guarded model step: the planned route, re-run on the bottom
        rung on any failure (an exception out of the step, an injected
        ``engine.{phase}`` fault, or, guarded, non-finite logits), from
        the caller's cache (exact: module docstring).  Re-raises a
        ``KernelError``; raises if the bottom rung fails too.  While a
        profiler records, an MoE model's ``moe.TALLY`` is reset before
        the step and folded into its samples after the step's
        synchronize."""
        tally = self._tally if self._tally is not None and profiling() \
            else None
        if tally is not None:
            tally.reset()
        with self._on_mesh():
            out = self._guarded_step(phase, cache, batch, **kw)
        if tally is not None:
            tally.fold()
        return out

    def _guarded_step(self, phase: str, cache, batch: Dict, **kw):
        cont = phase == "prefill_chunk"
        step = {"decode": self._decode, "prefill": self._prefill}.get(
            phase, model_mod.decode_step)
        try:
            faults.check(f"engine.{phase}")
            with self._serving():
                logits, new_cache = self.timer.run(
                    phase, step, self.cont_cfg if cont else self.cfg,
                    self.model, batch, cache, **kw)
            if self._nan_guarded() and \
                    not bool(torch.isfinite(logits[:, -1]).all()):
                raise FloatingPointError(
                    f"non-finite logits from the planned {phase} step")
            return logits, new_cache
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — serving must not die
            obs.count("engine.degraded", phase=phase,
                      reason=type(e).__name__)
            if phase == "decode":
                count_eager("degraded")
            self._req_degraded = True
            return self.timer.run(phase, model_mod.decode_step,
                                  self._fallback(cont), self.model, batch,
                                  cache, **kw)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, enc_out=None):
        """tokens (B, S_prompt) -> (cache, last-position logits (B, V)).
        ``enc_out``: an enc-dec model's encoder output (``encdec.encode``,
        run outside the engine)."""
        t0 = time.perf_counter()
        replays = self._prefill.replays
        cache = model_mod.init_cache(self.cfg, int(tokens.shape[0]),
                                     self.scfg.max_len, self.cache_dtype,
                                     self.device)
        with obs.span("serve.prefill", cat="serve",
                      batch=int(tokens.shape[0]),
                      prompt_len=int(tokens.shape[1])):
            logits, cache = self._run_step(
                "prefill", cache, self._batch(tokens, enc_out),
                last_only=True)
        self._record_step("prefill", t0)
        self._prefill_hist.record(float(self._prefill.replays > replays))
        return cache, logits[:, -1]

    @torch.no_grad()
    def prefill_chunk(self, cache, tokens: torch.Tensor, enc_out=None):
        """Continuation prefill: advance ``cache`` (int pos, possibly
        already holding tokens) by one chunk of ``tokens`` (B, S_chunk).
        Returns (cache, last-position logits (B, V)).  At pos 0 this is the
        answer of ``prefill`` without the flash fresh-cache route."""
        t0 = time.perf_counter()
        with obs.span("serve.prefill_chunk", cat="serve",
                      batch=int(tokens.shape[0]),
                      chunk_len=int(tokens.shape[1])):
            obs.count("engine.prefill_chunk")
            logits, cache = self._run_step(
                "prefill_chunk", cache, self._batch(tokens, enc_out),
                last_only=True)
        self._record_step("prefill_chunk", t0)
        return cache, logits[:, -1]

    @torch.no_grad()
    def decode_token(self, cache, tokens: torch.Tensor, enc_out=None):
        """One decode step of every row of ``cache`` (int or per-slot pos):
        tokens (B, 1) -> (logits (B, 1, V), cache).  The serving hot path:
        with tracing off and no profiler recording it adds two no-op spans
        (``serve.decode``, ``engine.sync_wait``), five ``perf_counter``
        reads and four histogram appends to the step, ``StepTimer``'s
        included, and an eager step a counter."""
        t0 = time.perf_counter()
        replays = self._decode.replays
        with obs.span("serve.decode", cat="serve"):
            out = self._run_step("decode", cache,
                                 self._batch(tokens, enc_out))
        self._record_step("decode", t0)
        self._graph_hist.record(float(self._decode.replays > replays))
        return out

    def _sample(self, logits: torch.Tensor, key: prng.Key) -> torch.Tensor:
        """(B, V) logits -> (B,) token ids on their device: the argmax at
        temperature 0, else ``categorical(key, logits / temperature)``."""
        if self.scfg.temperature <= 0.0:
            return logits.argmax(dim=-1)
        return prng.categorical(
            key, prng.scaled(logits, self.scfg.temperature))

    @torch.no_grad()
    def generate(self, prompt_tokens: torch.Tensor, n_new: int,
                 enc_out=None, return_logits: bool = False):
        """Greedy or sampled generation: (B, n_new) tokens, or with
        ``return_logits`` a (tokens, logits) pair where logits is the fp32
        (n_new, B, V) stack of the distributions each token was chosen
        from.  Sampling keys follow the reference: ``PRNGKey(seed)`` draws
        the first token, and each later step splits the running key and
        draws with the second half.  An
        enc-dec model's every step attends over ``enc_out``.  Completion
        is the contract: a failing step degrades (``_run_step``), and a
        request that needed a degraded step is counted in
        ``degraded_requests``."""
        t_start = time.perf_counter()
        self._req_degraded = False
        if enc_out is not None:
            enc_out = enc_out.to(self.device)
        with obs.span("serve.generate", cat="serve",
                      batch=int(prompt_tokens.shape[0]),
                      prompt_len=int(prompt_tokens.shape[1]),
                      n_new=n_new) as gspan:
            cache, last = self.prefill(prompt_tokens, enc_out)
            key = prng.PRNGKey(self.scfg.seed)
            cur = self._sample(last, key)[:, None]
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            self.ttft_s = time.perf_counter() - t_start
            obs.observe("serve.ttft_s", self.ttft_s)
            gspan.set(ttft_s=round(self.ttft_s, 6))
            toks, lgs = [], [last.float()]
            for _ in range(n_new):
                toks.append(cur)
                logits, cache = self.decode_token(cache, cur, enc_out)
                lgs.append(logits[:, -1].float())
                key, sub = prng.split(key)
                cur = self._sample(logits[:, -1], sub)[:, None]
            obs.count("serve.tokens", n_new * int(prompt_tokens.shape[0]))
            if self._req_degraded:
                self.degraded_requests += 1
                obs.count("serve.degraded_request")
                gspan.set(degraded=True)
        out = torch.cat(toks, dim=1)
        if return_logits:
            return out, torch.stack(lgs[:n_new])
        return out

    def measured_step_time_ms(self) -> Optional[float]:
        """A measured decode-step time (ms) for the scheduler's virtual
        clock, or None: the p50 of this engine's steady decode steps (at
        least 3, so no cold step is the estimate), else the warmup's plan
        times (the slowest bucket's winner per decode kernel times the
        layers that run it, kernels only, so an underestimate)."""
        steps = self.timer.steady.get("decode", [])
        if len(steps) >= 3:
            return statistics.median(steps) * 1e3
        best: Dict[str, float] = {}
        for rec in self.warmup_report:
            us, kern = rec.get("winner_us"), rec.get("kernel")
            if us and kern in ("decode_attention", "ssd_decode"):
                best[kern] = max(best.get(kern, 0.0), float(us))
        if not best:
            return None
        cfg = self.cfg
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            n_attn = cfg.n_layers // cfg.hybrid_attn_every
        elif cfg.family == "ssm":
            n_attn = 0
        else:
            n_attn = cfg.n_layers
        n_ssm = cfg.n_layers - n_attn if cfg.family in ("ssm", "hybrid") \
            else 0
        ms = (best.get("decode_attention", 0.0) * n_attn
              + best.get("ssd_decode", 0.0) * n_ssm) / 1e3
        return ms or None

    @torch.no_grad()
    def serve_stream(self, requests, *, max_slots: Optional[int] = None,
                     collect_logits: bool = False, step_hook=None,
                     prefill_chunk_tokens: Optional[int] = None,
                     preempt_policy: Optional[str] = None,
                     max_queue: Optional[int] = None,
                     deadline_aware: bool = False,
                     step_time_ms: Optional[float] = None,
                     return_shed: bool = False):
        """Serve a stream of ``scheduler.Request``s (virtual arrival steps;
        ``scheduler.synthetic_workload`` makes seeded traces) through the
        continuous-batching scheduler: ``max_slots`` (default: the engine
        batch) decode lanes over one per-slot cache.  Returns
        ``[CompletedRequest]`` sorted by rid; in fp32 each request's tokens
        are those of running it alone through ``generate``, in bf16 they
        may differ at near-ties of the top two logits (a GEMM over all
        lanes rounds otherwise than one over a single row).  With
        ``return_shed`` a
        ``(completed, shed)`` pair.  ``prefill_chunk_tokens``,
        ``preempt_policy``, ``max_queue`` and ``deadline_aware`` are the
        reference's overload controls.  ``step_time_ms`` maps deadlines
        onto scheduler steps; None takes ``measured_step_time_ms`` and
        falls back to 1.0."""
        from . import scheduler as sched_mod
        if step_time_ms is None:
            measured = self.measured_step_time_ms()
            step_time_ms = measured or 1.0
            obs.count("sched.step_time_seeded",
                      source="measured" if measured else "constant",
                      step_time_ms=round(step_time_ms, 4))
        sched = sched_mod.Scheduler(
            self, max_slots=max_slots, collect_logits=collect_logits,
            step_hook=step_hook, prefill_chunk_tokens=prefill_chunk_tokens,
            preempt_policy=preempt_policy, max_queue=max_queue,
            deadline_aware=deadline_aware, step_time_ms=step_time_ms)
        completed = sched.run(requests)
        if return_shed:
            return completed, sorted(sched.shed.values(),
                                     key=lambda r: r.rid)
        return completed

    def stats(self) -> Dict[str, Any]:
        """Time to first token of the last ``generate``, the plan warmup,
        the per-phase cold / steady-state split and the registry's
        hit / miss / fallback counts (None off the registry), and the
        requests served with a degraded step."""
        return {
            "ttft_s": self.ttft_s,
            "warmup_s": round(self.warmup_s, 4),
            "plans_warmed": len(self.warmup_report),
            "warmup_failed": sum(1 for r in self.warmup_report
                                 if "error" in r),
            "warmup_measured": sum(1 for r in self.warmup_report
                                   if r.get("measured")
                                   and not r.get("replayed")),
            "degraded_requests": self.degraded_requests,
            "artifact": self.artifact_report,
            "phases": self.timer.stats(),
            "registry": self._reg.stats.as_dict() if self._reg is not None
            else None,
        }
